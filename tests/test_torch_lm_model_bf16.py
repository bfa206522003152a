"""The port's LM against the reference's on all ten smoke configs, on the
CPU, in bfloat16 mode (the configs' own compute dtype), and the port's
two execution modes against each other.

The inputs, weights and entry points are ``tests/test_torch_lm_model.py``'s
(``make_case``, ``run_both``).  In bfloat16 the two CPU libraries round
matmuls, silu and softmax inputs at different places, so the criterion is
the reference's own for bfloat16 against another code path
(``tests/test_arch_smoke.py::test_prefill_decode_matches_forward``):
top-1 agreement >= 0.95 and correlation > 0.99 on the logits of
``forward``, ``prefill`` and ``decode_step``; a top-1 mismatch must also
be a near-tie in both packages (top-2 gap under 0.1 of the logits' std,
the reference's rule in ``test_tm_equals_spatial``).  Loss and aux agree
to 1e-2 relative (bf16 logits carry 2^-8 each), every cache leaf to a
correlation > 0.99.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_lm_model as base
from repro.configs import ARCHS
from repro_torch.models.blocks import tree_leaves


def assert_bf16_agrees(got, want, what: str) -> None:
    a = base.to_np(got).reshape(-1, got.shape[-1])
    b = base.to_np(want).reshape(-1, got.shape[-1])
    cc = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert cc > 0.99, (what, cc)
    am, bm = a.argmax(-1), b.argmax(-1)
    assert (am == bm).mean() >= 0.95, (what, am, bm)
    tie = 0.1 * float(np.std(b))
    for i in np.flatnonzero(am != bm):
        gap = max(abs(a[i, am[i]] - a[i, bm[i]]), abs(b[i, am[i]] - b[i, bm[i]]))
        assert gap < tie, (what, i, gap, tie)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_mode_matches_reference(arch):
    case = base.make_case(arch)
    out = base.run_both(case, "bfloat16")
    for name in ("forward", "prefill", "decode"):
        got, want = out[name]
        assert got.dtype == torch.bfloat16, name
        assert got.shape == want.shape, name
        assert_bf16_agrees(got, want, name)
    for name in ("loss", "aux"):
        got, want = (float(x) for x in out[name])
        assert abs(got - want) <= 1e-2 * max(abs(want), 1e-3), (name, got,
                                                                want)
    for key in ("caches", "decode_caches"):
        for path, t, j in base.pairs(*out[key]):
            assert tuple(t.shape) == j.shape and t.dtype == {
                "bfloat16": torch.bfloat16, "float32": torch.float32}[
                str(j.dtype)], (key, path)
            a, b = base.to_np(t).ravel(), base.to_np(j).ravel()
            if np.abs(b).max():
                assert np.corrcoef(a, b)[0, 1] > 0.99, (key, path)
            else:
                assert not np.abs(a).max(), (key, path)


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-4b", "zamba2-7b",
                                  "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
                                  "whisper-base"])
def test_tm_equals_spatial_bit_for_bit(arch):
    """In the port both execution modes run the same layer body: forward,
    prefill caches and a decode step agree bit for bit."""
    case = base.make_case(arch, seed=3)
    cfg_sp = dataclasses.replace(case.tcfg, scan_layers=False)
    _, tk = case.embeds("bfloat16")
    toks = torch.from_numpy(case.tokens)
    a, aux_a, _ = base.TM.forward(case.tcfg, case.tp, toks, **tk)
    b, aux_b, _ = base.TM.forward(cfg_sp, case.tp, toks, **tk)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    _, tk = case.embeds("bfloat16", base.PROMPT)
    la, ca = base.TM.prefill(case.tcfg, case.tp, toks[:, :base.PROMPT], cache_len=40,
                        **tk)
    lb, cb = base.TM.prefill(cfg_sp, case.tp, toks[:, :base.PROMPT], cache_len=40, **tk)
    assert torch.equal(la, lb)
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(ca), tree_leaves(cb)))
    pos = base.PROMPT + case.tcfg.vision_tokens
    da, _ = base.TM.decode_step(case.tcfg, case.tp, ca, toks[:, base.PROMPT:base.PROMPT + 1],
                           pos)
    db, _ = base.TM.decode_step(cfg_sp, case.tp, cb, toks[:, base.PROMPT:base.PROMPT + 1],
                           pos)
    assert torch.equal(da, db)
