"""qwen2-moe-a2.7b's routing in bfloat16 against float32, in both packages,
on the CPU: why ``chip_smoke.py`` routes a MoE model's float32 forward as
its bfloat16 decode did before it holds the two to the absolute criterion.

The config is qwen2-moe-a2.7b's routing at its published depth — 24
layers of 60 experts, top-4, 4 shared experts — on the smoke config's
narrow widths (d_model 64), with numpy weights from a seed.  Over 48
tokens:

* routing by itself, each package's bfloat16 forward is far from its own
  float32 forward (about 12 % median; more than ``FREE_FAR`` is asked): a
  token whose 4th and 5th experts lie nearer than the two precisions'
  router difference picks another expert, and its later layers part.  The reference does so as
  much as the port (the two medians within ``FREE_RATIO`` of each other);
* routed alike — every forward of both packages forced to the experts
  the port's bfloat16 forward picked — both packages' bfloat16 forwards
  meet the card's criterion against float32 (every position within
  ``chip_smoke.FULL_REL_L2`` = 10 %, correlation above 0.99), and the two
  packages' float32 forwards agree to ``REL_F32`` (1e-5), so the forcing
  reaches the same experts in both.

The reference runs unrolled (``scan_layers=False``, bit-equal to its
scanned mode): its ``jax.lax.top_k`` is then called once a layer, in
layer order, as the port's ``layers.lax_top_k`` is.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models.layers as TL
from test_torch_lm_model import (JM, REL_F32, jax_smoke, numpy_params,
                                 params_from_numpy, rel_err, set_mode,
                                 to_np, torch_smoke)
import repro_torch.models.model as TM

ARCH, LAYERS, B, S = "qwen2-moe-a2.7b", 24, 4, 48
#: the card's per-position bound (``chip_smoke.FULL_REL_L2``)
FULL_REL_L2 = 0.1
#: routing by itself, bf16 lies at least this far from float32 (median)
FREE_FAR = 0.05
#: the port's free-routing median over the reference's, at most this far
#: from 1 either way
FREE_RATIO = 1.5


def routing_config(cfg):
    (stack,) = cfg.stacks
    return dataclasses.replace(
        cfg, n_experts=60, top_k=4, n_shared_experts=4,
        shared_expert_d_ff=4 * cfg.expert_d_ff, scan_layers=False,
        stacks=(dataclasses.replace(stack, count=LAYERS),))


class Routing:
    """Both packages' top-k watched: ``picked`` keeps each call's ids;
    with ``force`` (one [T, k] array a call) the call routes by those
    instead, its gates gathered from its own probabilities."""

    def __init__(self, monkeypatch, force=None):
        self.force, self.picked = force, []
        top_t, top_j = TL.lax_top_k, jax.lax.top_k

        def port(x, k):
            vals, idx = top_t(x, k)
            self.picked.append(idx.numpy())
            if self.force is None:
                return vals, idx
            idx = torch.from_numpy(self.force[len(self.picked) - 1])
            return x.gather(-1, idx), idx

        def reference(x, k):
            vals, idx = top_j(x, k)
            self.picked.append(np.asarray(idx))
            if self.force is None:
                return vals, idx
            idx = jnp.asarray(self.force[len(self.picked) - 1])
            return jnp.take_along_axis(x, idx, -1), idx

        monkeypatch.setattr(TL, "lax_top_k", port)
        monkeypatch.setattr(jax.lax, "top_k", reference)


def rel_l2(a, b) -> np.ndarray:
    a, b = to_np(a), to_np(b)
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)


def corr(a, b) -> float:
    return float(np.corrcoef(to_np(a).ravel(), to_np(b).ravel())[0, 1])


@pytest.fixture(scope="module")
def case():
    tcfg = routing_config(torch_smoke(ARCH))
    jcfg = routing_config(jax_smoke(ARCH))
    tree = numpy_params(tcfg, 0)
    tokens = np.random.RandomState(1).randint(
        0, tcfg.vocab, (B, S)).astype(np.int32)
    return (tcfg, jcfg, params_from_numpy(tcfg, tree, "cpu"),
            jax.tree.map(jnp.asarray, tree), tokens)


def forwards(case, mode, monkeypatch, force=None):
    """(port logits, reference logits, ids each picked) in ``mode``."""
    tcfg, jcfg, tp, jp, tokens = case
    with monkeypatch.context() as mp:
        set_mode(mp, mode)
        r = Routing(mp, force)
        tl = TM.forward(tcfg, tp, torch.from_numpy(tokens))[0]
        port_ids, r.picked = r.picked, []
        jl = JM.forward(jcfg, jp, jnp.asarray(tokens))[0]
    assert len(port_ids) == len(r.picked) == LAYERS
    return tl, jl, port_ids


def test_qwen2_moe_bf16_parts_from_float32_by_routing(case, monkeypatch):
    t16, j16, routes = forwards(case, "bfloat16", monkeypatch)
    t32, j32, _ = forwards(case, "float32", monkeypatch)
    free_t, free_j = (float(np.median(rel_l2(a, b)))
                      for a, b in ((t16, t32), (j16, j32)))
    print(f"free routing, bf16 vs float32 median: port {free_t}, "
          f"reference {free_j}")
    assert free_t > FREE_FAR and free_j > FREE_FAR, (free_t, free_j)
    assert 1 / FREE_RATIO <= free_t / free_j <= FREE_RATIO, (free_t, free_j)

    # every forward of both packages routed as the port's bf16 forward was
    f16_t, f16_j, _ = forwards(case, "bfloat16", monkeypatch, routes)
    f32_t, f32_j, own32 = forwards(case, "float32", monkeypatch, routes)
    assert rel_err(f32_t, f32_j) <= REL_F32, rel_err(f32_t, f32_j)
    flips = [float(np.mean((np.sort(a, -1) != np.sort(b, -1)).any(-1)))
             for a, b in zip(routes, own32)]
    print(f"tokens whose bf16 top-4 set is not float32's own, by layer: "
          f"{flips}")
    for what, a, b in (("port", f16_t, f32_t), ("reference", f16_j, f32_j)):
        rel, cc = rel_l2(a, b), corr(a, b)
        print(f"routed alike, {what}: median {np.median(rel)}, max "
              f"{rel.max()}, cc {cc}")
        assert rel.max() <= FULL_REL_L2 and cc > 0.99, (what, rel.max(), cc)
