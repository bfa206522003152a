"""The program's profiler ranges (``repro_torch.telemetry.span``) on the
CPU.

* with no profiler recording, ``span`` hands back one shared null
  context and never enters ``record_function``;
* under ``torch.profiler`` one ``OverlayServer`` round (streaming and
  barrier drains), one decode step of a small dense model and one
  training step record the ranges of docs/TELEMETRY.md, each as often as
  the table there says (decode's cache ranges as docs/PORT.md's "Spans
  of the in-place decode" has them);
* their outputs are bit-identical with the profiler on and off;
* the dry run's counts (FLOPs, bytes, ops, peak, collectives) are those
  of the same step with the ranges taken out: its tracer sees no
  profiler op (an ungated range is two ops, enter and exit).
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.core import paper_bench
from repro_torch.core.overlay import compile_program
from repro_torch.launch import dryrun as D
from repro_torch.launch.serve import OverlayServer
from repro_torch.models import model as M
from repro_torch.models.blocks import tree_leaves, tree_map
from repro_torch.runtime import optim as O
from repro_torch.runtime.steps import (make_decode_step, make_prefill_step,
                                       make_train_step)
from repro_torch.telemetry import span, spans

OVERLAY_RANGES = ("overlay.plan", "overlay.pack", "overlay.h2d",
                  "overlay.launch", "overlay.collect")
ENGINE_RANGES = ("engine.form_round", "engine.wait", "engine.deliver")


def ranges(fn):
    """``fn()``'s result and how often each program range was entered
    while a CPU profiler recorded it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    counts: dict = {}
    for e in prof.events():
        if "." in e.name and not e.name.startswith(("aten::", "profiler")):
            counts[e.name] = counts.get(e.name, 0) + 1
    return out, counts


def same_bits(a, b) -> bool:
    def bits(x):
        return x.reshape(-1).view(torch.uint8)

    xs, ys = tree_leaves(a), tree_leaves(b)
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and torch.equal(bits(x), bits(y))
        for x, y in zip(xs, ys))


def test_no_profiler_no_record_function(monkeypatch):
    entered = []
    real = spans.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(spans, "record_function", counting)
    first, second = span("overlay.pack"), span("decode.cache_write")
    assert first is second
    assert isinstance(first, contextlib.nullcontext)
    with first, second:
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("overlay.pack"):
            pass
    assert entered == ["overlay.pack"]


# ------------------------------------------------------------ the overlay
@pytest.fixture(scope="module")
def kernels():
    return [compile_program(paper_bench.benchmark(n))
            for n in paper_bench.BENCH_NAMES[:3]]


def _serve(kernels, drain: str):
    """Three requests, one a kernel, through a bank of two: one round of
    two kernels, then one of the third (a context load on a full bank)."""
    srv = OverlayServer(bank_capacity=2, round_kernels=2, device="cpu")
    rng = np.random.default_rng(0)
    tickets = [srv.submit(k, [rng.uniform(-2, 2, 300).astype(np.float32)
                              for _ in k.dfg.inputs], tenant=f"t{i}")
               for i, k in enumerate(kernels)]
    res = dict(srv.as_completed()) if drain == "as_completed" \
        else srv.flush_sync()
    return [[np.asarray(y) for y in res[t]] for t in tickets], \
        srv.stats()["rounds"]


@pytest.mark.parametrize("drain", ["as_completed", "flush_sync"])
def test_an_overlay_round_records_its_ranges(kernels, drain):
    (outs, rounds), n = ranges(lambda: _serve(kernels, drain))
    assert rounds == 2
    for name in OVERLAY_RANGES:
        assert n.get(name) == rounds, (name, n)
    assert n.get("bank.load") == 3          # every kernel loaded once
    assert n.get("engine.form_round", 0) > rounds   # the last finds none
    if drain == "as_completed":
        for name in ENGINE_RANGES[1:]:
            assert n.get(name) == rounds, (name, n)
    else:                                   # the oracle: overlay ranges only
        assert not any(k in n for k in ENGINE_RANGES[1:])
    plain, _ = _serve(kernels, drain)
    assert all(a.tobytes() == b.tobytes()
               for got, want in zip(outs, plain) for a, b in zip(got, want))


# ------------------------------------------------------------ the LM steps
@pytest.fixture(scope="module")
def dense():
    cfg = get_smoke_config("deepseek-7b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return cfg, params


def test_a_decode_step_records_its_ranges(dense):
    cfg, params = dense
    tokens = torch.randint(1, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    _, caches = make_prefill_step(cfg, cache_len=8)(params,
                                                    {"tokens": tokens})
    decode = make_decode_step(cfg)
    tok = tokens[:, -1:]
    got, n = ranges(lambda: decode(params, caches, tok, 6))
    layers = cfg.stacks[0].count
    assert n.get("decode.cache_write") == layers
    assert n.get("decode.attn_core") == layers
    assert n.get("decode.cache_stack") == 1
    assert "decode.cache_clone" not in n       # slot 6 written in place
    # q, k, v, o, up, gate, down a layer, then the head
    assert n.get("weights.cast") == 7 * layers + 1
    assert same_bits(got, decode(params, caches, tok, 6))
    # position 8 wraps the 8-slot ring: each layer's K/V copied first
    _, n = ranges(lambda: decode(params, caches, tok, 8))
    assert n.get("decode.cache_clone") == n.get("decode.cache_write") \
        == layers


def test_a_dense_model_records_no_hybrid_ranges(dense):
    cfg, params = dense
    tokens = torch.randint(1, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    (_, caches), n = ranges(lambda: make_prefill_step(cfg, cache_len=8)(
        params, {"tokens": tokens}))
    _, m = ranges(lambda: make_decode_step(cfg)(params, caches,
                                                tokens[:, -1:], 6))
    for name in ("ssm_step", "shared_block"):
        assert f"prefill.{name}" not in n and f"decode.{name}" not in m


def test_a_hybrid_model_records_its_ranges():
    """Zamba2 at its smoke size: each Mamba layer's mixer and each site's
    shared block once a decode step, and once in prefill, under the
    names of docs/PORT.md ("Spans of the hybrid model")."""
    from repro_torch.configs import zamba2_7b_instruct
    cfg = zamba2_7b_instruct.smoke_config()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.randint(1, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    (_, caches), n = ranges(lambda: make_prefill_step(cfg, cache_len=8)(
        params, {"tokens": tokens}))
    layers, sites = cfg.n_layers, len(cfg.shared.sites)
    assert n.get("prefill.ssm_step") == layers
    assert n.get("prefill.shared_block") == sites
    decode = make_decode_step(cfg)
    tok = tokens[:, -1:]
    got, m = ranges(lambda: decode(params, caches, tok, 6))
    assert m.get("decode.ssm_step") == layers
    assert m.get("decode.shared_block") == sites
    assert m.get("decode.cache_write") == m.get("decode.attn_core") == sites
    # the Mamba layers' states (stacked) and the sites' K/V (in place)
    assert m.get("decode.cache_stack") == 2
    assert "decode.cache_clone" not in m
    assert same_bits(got, decode(params, caches, tok, 6))
    _, m = ranges(lambda: decode(params, caches, tok, 8))
    assert m.get("decode.cache_clone") == sites


def test_a_training_step_records_its_ranges(dense):
    cfg, params = dense
    batch = {"tokens": torch.randint(
        1, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(2))}
    step = make_train_step(cfg, O.OptConfig())

    def run():
        p = tree_map(torch.clone, params)
        return step(p, O.init_opt(p), batch)

    got, n = ranges(run)
    for name in ("train_step.forward", "train_step.backward",
                 "train_step.update"):
        assert n.get(name) == 1, (name, n)
    # each projection in the forward and again in full remat's recompute
    assert n.get("weights.cast") == 2 * 7 * cfg.stacks[0].count + 1
    assert same_bits(got, run())


# ------------------------------------------------------------ the dry run
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dry_run_counts_are_those_without_the_ranges(kind, monkeypatch):
    monkeypatch.setitem(D.SHAPES, f"tiny_{kind}", (64, 8, kind))

    def counts():
        cfg, batch, (seq, gbatch, _) = D.input_specs(
            "deepseek-7b", f"tiny_{kind}", smoke=True)
        t = D.trace_step(cfg, batch, kind, seq, gbatch)[0]
        return (t.flops, t.bytes_accessed, t.ops, t.peak_bytes,
                t.argument_bytes, t.output_bytes, t.collectives)

    counts()                    # a first trace counts a few lazy inits
    live = counts()
    null = contextlib.nullcontext()
    for mod in ("repro_torch.core.overlay", "repro_torch.models.layers",
                "repro_torch.models.blocks", "repro_torch.runtime.steps"):
        monkeypatch.setattr(f"{mod}.span", lambda name: null)
    assert live == counts()
