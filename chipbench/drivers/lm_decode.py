"""Decode traffic: a static batch of prompts prefilled in set-up
(``make_prefill_step``), then greedy generations through the cache
(``make_decode_step``), one after another from the prompts' end.

Traffic keys: ``batch`` sequences, ``prompt_len``, ``gen_len`` decode
steps a generation, ``prefill_rows`` (rows prefilled together),
``warmup_steps``, ``documents`` (see ``lm_common.token_rows``),
``check_rows`` (sequences the reference follows, drawn from the seed).

A decode step returns new caches and leaves its input's as they were,
so every generation starts from the prefilled caches; a position past
the one being written is masked.  The tokens served are the prefill's
greedy token and each step's; once the window has closed, the reference
runs each checked prompt with its served tokens and reads, at each
served position, how far the served token's logit lies below its best.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from chipbench.drivers import lm_common as C
from chipbench.lib import trace
from chipbench.lib.record import seed_int
from chipbench.lib.spec import load_module
from chipbench.metrics import _arith


def cat_caches(parts: list):
    """Caches of row blocks joined on the batch axis (dim 1 of a stacked
    leaf)."""
    import torch
    from repro_torch.models.blocks import tree_leaves, tree_unflatten
    leaves = [tree_leaves(p) for p in parts]
    return tree_unflatten(parts[0], [torch.cat(xs, 1)
                                     for xs in zip(*leaves)])


def served_gap(ref, W, d, prompts, served, rows, P: int, by=None) -> float:
    """The widest gap, over ``rows`` and served positions, between the
    reference's best logit and its logit of the served token.  With
    ``by`` (another precision), the token read is the one ``by`` puts
    first instead of the served one."""
    import torch
    worst = 0.0
    n = served.shape[1]
    for r in rows:
        seq = torch.cat([prompts[r], served[r, :n - 1]])
        lg = ref.logits_at(W, seq, P - 1, d)
        tok = served[r].long() if by is None else \
            ref.logits_at(W, seq, P - 1, d, by).argmax(-1)
        gap = lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


class Program:
    """The port's prefill and decode steps on the seed's weights, with
    the prompts prefilled and the first decode steps warmed up."""

    def __init__(self, cell, seed: int, dev):
        import torch
        from repro_torch.runtime.steps import (make_decode_step,
                                               make_prefill_step)
        cfg_file, tr = cell.config, cell.traffic
        self.ref = load_module(cell.reference_path)
        self.d = d = self.ref.dims(cfg_file)
        cfg = C.model_config(cfg_file)
        self.B, self.P, self.G = tr["batch"], tr["prompt_len"], tr["gen_len"]
        self.dev = dev
        self.prompts = torch.from_numpy(C.token_rows(
            seed, 21, self.B, self.P, d["vocab"], tr["documents"])).to(dev)
        self.params = C.port_params(cfg, self.ref.make_weights(d, seed, dev))
        prefill = make_prefill_step(cfg, cache_len=self.P + self.G)
        self.decode = make_decode_step(cfg)
        first, parts = [], []
        for r0 in range(0, self.B, tr["prefill_rows"]):
            lg, c = prefill(self.params, {
                "tokens": self.prompts[r0:r0 + tr["prefill_rows"]]})
            first.append(torch.argmax(lg, -1).to(torch.int32))
            parts.append(c)
        self.caches = cat_caches(parts) if len(parts) > 1 else parts[0]
        self.tok0 = torch.cat(first)
        del parts, lg, c
        self.generate(tr["warmup_steps"])
        self.sync()

    def sync(self) -> None:
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def step(self, caches, tok, i: int):
        """Decode step ``i`` of a generation: its token and caches."""
        with trace.span("bench.decode_step"):
            _, nt, caches = self.decode(self.params, caches, tok[:, None],
                                        self.P + i)
        return nt, caches

    def generate(self, n: int):
        """``n`` steps of a generation from the prefilled caches: the
        tokens served, [B, n + 1] (the prefill's and each step's)."""
        import torch
        toks, c = [self.tok0], self.caches
        for i in range(n):
            nt, c = self.step(c, toks[-1], i)
            toks.append(nt)
        return torch.stack(toks, 1)

    def free(self) -> None:
        import torch
        self.params = self.caches = self.decode = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def check_rows(cell, seed: int) -> list:
    rng = np.random.default_rng(seed_int(seed, 22))
    B = cell.traffic["batch"]
    return sorted(rng.choice(B, size=min(cell.traffic["check_rows"], B),
                             replace=False).tolist())


def reference_gap(cell, seed: int, prompts, served, dev, by=None) -> float:
    """``served_gap`` over the seed's checked rows, on the reference's
    weights made again from the seed."""
    ref = load_module(cell.reference_path)
    d = ref.dims(cell.config)
    W = ref.make_weights(d, seed, dev)
    return served_gap(ref, W, d, prompts, served, check_rows(cell, seed),
                      cell.traffic["prompt_len"], by=by)


def run(cell, rec) -> None:
    import torch
    tr = cell.traffic
    dev = rec.device
    prog = Program(cell, rec.seed, dev)
    B, P, G = prog.B, prog.P, prog.G
    rec.setup_done()
    out: dict = {}
    stamps, positions = [], []
    served, cur = None, [prog.tok0]
    with trace.profiled(rec.traced, out):
        t0 = time.perf_counter()
        t_end = t0 + rec.window_s(tr)
        c, i = prog.caches, 0
        while True:
            nt, c = prog.step(c, cur[-1], i)
            positions.append(P + i)
            cur.append(nt)
            i += 1
            if i == G:
                served, cur = cur, [prog.tok0]
                c, i = prog.caches, 0
            stamps.append(time.perf_counter())
            if stamps[-1] >= t_end:
                break
        prog.sync()
        t1 = time.perf_counter()
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    steps = len(positions)
    rec.e2e["decode_tokens_per_s"] = B * steps / (t1 - t0)
    gaps_ms = 1e3 * np.diff([t0] + stamps)
    d = prog.d
    rec.counters.update({
        "steps": steps, "window_s": t1 - t0,
        "step_ms_p95": float(np.percentile(gaps_ms, 95)),
        "flops": sum(_arith.decode_step_flops(d, B, p) for p in positions),
        "bytes": sum(_arith.decode_step_bytes(d, B, p) for p in positions)})
    rec.trace = out.get("trace")
    served = torch.stack(served if served is not None else cur, 1)
    rec.attempted = B
    print(f"chipbench: {steps} decode steps in {t1 - t0:.3f} s; "
          f"{served.shape[1]} tokens served a sequence, rows "
          f"{check_rows(cell, rec.seed)} checked", file=sys.stderr)
    prompts = prog.prompts
    del c, nt, cur
    prog.free()
    rec.check("served_logit_gap",
              reference_gap(cell, rec.seed, prompts, served, dev),
              tr["limits"]["served_logit_gap"])
