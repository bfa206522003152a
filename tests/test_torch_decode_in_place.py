"""A decode step writes the new token's K/V into the caches it is given
(``runtime.steps.make_decode_step``), on the smoke configs of a dense
model, gemma3's windowed rings, a MoE model, Whisper's cross K/V and the
published Zamba2's hybrid cache:

* a greedy generation is bit for bit the one run on a ``deepcopy`` of
  the caches before every step (the functional oracle), and a second
  generation restarted from the prefilled caches, as the benchmark's
  drivers restart, serves the same tokens;
* an unwrapped step returns the given K/V storage with only slot ``pos``
  written, and records no ``decode.cache_clone``;
* a wrapped ring (``pos >= S``) leaves the given caches whole and is
  copied once per attention layer (range ``decode.cache_clone``).

On a card (``cuda`` marker, skipped without one): the same oracle at
deepseek-7b's and Zamba2's smoke sizes in bf16, Zamba2's Mamba layers
through the fused ``MambaStack``.
"""

import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config, zamba2_7b_instruct
from repro_torch.models import model as M
from repro_torch.models.blocks import tree_leaves, tree_leaves_with_path
from repro_torch.runtime.steps import make_decode_step, make_prefill_step

ARCHS = ("deepseek-7b", "gemma3-4b", "qwen2-moe-a2.7b", "whisper-base",
         "zamba2-7b-instruct")
B, P, G = 2, 12, 8      # gemma3's smoke window is 16: its local rings wrap
KV = ("['k']", "['v']", "['xk']", "['xv']")


def config(arch):
    if arch == "zamba2-7b-instruct":
        return zamba2_7b_instruct.smoke_config()
    return get_smoke_config(arch)


def attention_layers(cfg) -> int:
    n = sum(st.count for st in cfg.stacks for s in st.blocks
            if s.kind == "attn")
    return n + (len(cfg.shared.sites) if cfg.shared else 0)


class Case:
    """A smoke config's seeded params, prompts and prefilled caches."""

    def __init__(self, arch, device="cpu"):
        self.cfg = cfg = config(arch)
        self.params = M.init_params(
            cfg, torch.Generator(device).manual_seed(0), device=device)
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(1, cfg.vocab, (B, P), generator=g)
                 .to(device)}
        if cfg.encoder is not None:
            batch["frame_embeds"] = torch.randn(
                B, P, cfg.d_model, generator=g).to(torch.bfloat16).to(device)
        logits, self.caches = make_prefill_step(cfg, cache_len=P + G)(
            self.params, batch)
        self.tok0 = torch.argmax(logits, -1).to(torch.int32)
        self.decode = make_decode_step(cfg)

    def generate(self, caches, oracle=False):
        """``G`` greedy steps from ``caches``: the tokens [B, G + 1] and
        each step's logits; ``oracle``: each step on a deep copy."""
        toks, logits = [self.tok0], []
        for i in range(G):
            if oracle:
                caches = copy.deepcopy(caches)
            lg, nt, caches = self.decode(self.params, caches,
                                         toks[-1][:, None], P + i)
            toks.append(nt)
            logits.append(lg)
        return torch.stack(toks, 1), torch.stack(logits, 1)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


def ranges(fn):
    """``fn()`` and how often each ``decode.*`` range was entered."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    counts: dict = {}
    for e in prof.events():
        if e.name.startswith("decode."):
            counts[e.name] = counts.get(e.name, 0) + 1
    return out, counts


def bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_generation_is_the_functional_oracles(case):
    kept = copy.deepcopy(case.caches)
    want_toks, want_logits = case.generate(kept, oracle=True)
    caches = copy.deepcopy(case.caches)
    toks, logits = case.generate(caches)
    assert torch.equal(toks, want_toks)
    assert bits_equal(logits, want_logits)
    # restarted from the caches the first generation wrote into
    again, again_logits = case.generate(caches)
    assert torch.equal(again, want_toks)
    assert bits_equal(again_logits, want_logits)


def test_an_unwrapped_step_writes_the_given_caches_in_place(case):
    caches = copy.deepcopy(case.caches)
    before = copy.deepcopy(caches)
    (_, _, new), n = ranges(lambda: case.decode(
        case.params, caches, case.tok0[:, None], P))
    assert "decode.cache_clone" not in n
    assert n.get("decode.cache_write") == attention_layers(case.cfg)
    old = tree_leaves_with_path(before)
    for (path, given), (_, got), (_, was) in zip(
            tree_leaves_with_path(caches), tree_leaves_with_path(new), old):
        if path.endswith(KV):
            assert got.data_ptr() == given.data_ptr(), path
            slot = torch.arange(given.shape[2]) != P
            if path.endswith(("['xk']", "['xv']")):
                slot[:] = True           # decode does not write cross K/V
            assert bits_equal(given[:, :, slot], was[:, :, slot]), path
        else:                            # states: new, the given whole
            assert got.data_ptr() != given.data_ptr(), path
            assert bits_equal(given, was), path


def test_a_wrapped_ring_is_copied(case):
    """At ``pos`` = the cache length every ring has wrapped: the step
    copies each attention layer's K/V and leaves the given caches whole."""
    caches = copy.deepcopy(case.caches)
    before = copy.deepcopy(caches)
    pos = P + G
    (logits, _, new), n = ranges(lambda: case.decode(
        case.params, caches, case.tok0[:, None], pos))
    layers = attention_layers(case.cfg)
    assert n.get("decode.cache_clone") == layers
    assert n.get("decode.cache_write") == layers
    for a, b in zip(tree_leaves(caches), tree_leaves(before)):
        assert bits_equal(a, b)
    for (path, got), given in zip(tree_leaves_with_path(new),
                                  tree_leaves(caches)):
        if path.endswith(("['k']", "['v']")):
            assert got.data_ptr() != given.data_ptr(), path
    want, _, _ = case.decode(case.params, copy.deepcopy(before),
                             case.tok0[:, None], pos)
    assert bits_equal(logits, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-7b-instruct"])
def test_cuda_generation_is_the_functional_oracles(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = Case(arch, torch.device("cuda"))
    want_toks, want_logits = case.generate(copy.deepcopy(case.caches),
                                           oracle=True)
    toks, logits = case.generate(case.caches)
    again, _ = case.generate(case.caches)
    torch.cuda.synchronize()
    assert logits.dtype == torch.bfloat16
    assert torch.equal(toks, want_toks) and torch.equal(again, want_toks)
    assert bits_equal(logits, want_logits)
