"""The port's optimizer and gradient compression (``repro_torch.runtime.
optim`` / ``compress``) against the reference's, on the CPU.

* ``schedule`` over steps 0 .. total_steps + 5: float32, to 1e-6 relative
  (both compute the same float32 expression; ``cos`` may differ by an
  ulp between XLA and torch).
* ``adamw_update`` (functional and in place) and the mixed variant on
  random trees, the same numpy gradients and state in both packages: to
  1e-6 relative per leaf (``max|a - b| <= 1e-6 max|b|``).  The scalars
  (``b1 ** c``, the clip scale, the learning rate) are float32 ``pow``
  and divisions that may differ by an ulp between the frameworks, so
  across them AdamW is held to float tolerance.  Within the port the
  in-place form equals the functional one bit for bit, chunked or not.
* ``global_norm`` sums the leaves in the reference's order.
* ``compress_decompress`` with error feedback over 3 rounds: bit for bit
  (every operation correctly rounded, both round half to even).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compress as JC
from repro.runtime import optim as JO
from repro_torch.models.blocks import tree_leaves, tree_map
from repro_torch.runtime import compress as TC
from repro_torch.runtime import optim as TO
from torch_port_support import (assert_trees_bitwise, bits, leaf_pairs,
                                leaf_rel, torch_bits)

REL = 1e-6
OC = dict(lr=1e-3, warmup_steps=3, total_steps=12, weight_decay=0.1,
          grad_clip=1.0)


def random_tree(seed: int, scale: float = 1.0) -> dict:
    """A tree of float32 numpy leaves whose dict keys are NOT in sorted
    order (the reference sorts them, the port keeps insertion order)."""
    rng = np.random.RandomState(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"zeta": r(7, 5), "alpha": [r(3, 4, 2), {"w": r(6), "b": r(1)}],
            "mid": {"k": r(2, 3), "a": r(4)}}


def both(tree, jdtype=jnp.float32, tdtype=torch.float32):
    return (jax.tree.map(lambda a: jnp.asarray(a, jdtype), tree),
            tree_map(lambda a: torch.from_numpy(a.copy()).to(tdtype), tree))


def state_both(seed, count):
    m, v = random_tree(seed + 1, 0.1), random_tree(seed + 2, 0.05)
    v = jax.tree.map(np.abs, v)
    jm, tm = both(m)
    jv, tv = both(v)
    return ({"m": jm, "v": jv, "count": jnp.asarray(count, jnp.int32)},
            {"m": tm, "v": tv,
             "count": torch.tensor(count, dtype=torch.int32)})


def test_schedule_matches_reference():
    joc, toc = JO.OptConfig(**OC), TO.OptConfig(**OC)
    for step in range(0, OC["total_steps"] + 6):
        want = float(JO.schedule(joc, jnp.asarray(step, jnp.int32)))
        got = TO.schedule(toc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= REL * abs(want), (step, got, want)


def test_init_opt_count_is_int32_scalar():
    _, tp = both(random_tree(0))
    st = TO.init_opt(tp)
    assert st["count"].dtype == torch.int32 and st["count"].dim() == 0
    assert all(float(x.abs().max()) == 0 for x in tree_leaves(st["m"]))


@pytest.mark.parametrize("count", [0, 5])
@pytest.mark.parametrize("gscale", [0.01, 3.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(count, gscale):
    jp, tp = both(random_tree(0))
    jg, tg = both(random_tree(10, gscale))
    jst, tst = state_both(20, count)
    oc = dict(OC)
    jn, jstate, jstats = JO.adamw_update(JO.OptConfig(**oc), jg, jst, jp)
    tn, tstate, tstats = TO.adamw_update(TO.OptConfig(**oc), tg, tst, tp)
    for what, got, want in (("params", tn, jn),
                            ("m", tstate["m"], jstate["m"]),
                            ("v", tstate["v"], jstate["v"])):
        for path, t, j in leaf_pairs(got, want):
            assert leaf_rel(t, j) <= REL, (what, path, leaf_rel(t, j))
    assert int(tstate["count"]) == int(jstate["count"]) == count + 1
    assert tstate["count"].dtype == torch.int32
    for k in ("grad_norm", "lr"):
        assert abs(float(tstats[k]) - float(jstats[k])) <= \
            REL * abs(float(jstats[k])), k
    # in place: the same bits as the functional form, in the same tensors
    ids = [id(x) for x in (*tree_leaves(tp), *tree_leaves(tst["m"]))]
    ip, ist, istats = TO.adamw_update_(TO.OptConfig(**oc), tg, tst, tp)
    assert ip is tp and ist is tst
    assert ids == [id(x) for x in (*tree_leaves(ip), *tree_leaves(ist["m"]))]
    assert_trees_bitwise(ip, tn, "in-place params")
    assert_trees_bitwise({k: ist[k] for k in ("m", "v", "count")},
                         tstate, "in-place state")
    for k in ("grad_norm", "lr"):
        assert torch.equal(istats[k], tstats[k])


def test_adamw_in_place_chunked_equals_functional(monkeypatch):
    """Leaves split in slices of 7 elements: still the same bits."""
    _, tp = both(random_tree(1))
    _, tg = both(random_tree(11, 2.0))
    _, tst = state_both(21, 3)
    oc = TO.OptConfig(**OC)
    fn, fst, _ = TO.adamw_update(oc, tg, tst, tp)
    monkeypatch.setattr(TO, "CHUNK", 7)
    ip, ist, _ = TO.adamw_update_(oc, tg, tst, tp)
    assert_trees_bitwise(ip, fn, "params")
    assert_trees_bitwise({k: ist[k] for k in ("m", "v", "count")}, fst,
                         "state")


def test_adamw_mixed_matches_reference():
    pnp = random_tree(2)
    jp, tp = both(pnp, jnp.bfloat16, torch.bfloat16)
    # the same bf16 values on both sides: round once (torch), hand JAX them
    jp = jax.tree.map(lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16),
                      tp, is_leaf=lambda x: isinstance(x, torch.Tensor))
    gnp = random_tree(12, 0.5)
    _, tg = both(gnp, tdtype=torch.bfloat16)
    jg = jax.tree.map(lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16),
                      tg, is_leaf=lambda x: isinstance(x, torch.Tensor))
    jst, tst = JO.init_opt_mixed(jp), TO.init_opt_mixed(tp)
    for path, t, j in leaf_pairs(tst["master"], jst["master"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=path)
    joc, toc = JO.OptConfig(**OC), TO.OptConfig(**OC)
    for _ in range(2):
        jp, jst, jstats = JO.adamw_update_mixed(joc, jg, jst, jp)
        tp, tst, tstats = TO.adamw_update_mixed(toc, tg, tst, tp)
    for path, t, j in leaf_pairs(tst["master"], jst["master"]):
        assert leaf_rel(t, j) <= REL, (path, leaf_rel(t, j))
    for path, t, j in leaf_pairs(tp, jp):
        assert t.dtype == torch.bfloat16
        # bf16 casts of masters within 1e-6: equal unless a master sits
        # at a rounding boundary, then one bf16 ulp
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j).astype(np.float32),
                                   rtol=2 ** -7, atol=0, err_msg=path)
    # in place, from the same start: the same bits as the functional form
    _, tp0 = both(pnp, tdtype=torch.bfloat16)
    st_f, st_i = TO.init_opt_mixed(tp0), TO.init_opt_mixed(
        tree_map(torch.clone, tp0))
    p_f, p_i = tp0, tree_map(torch.clone, tp0)
    for _ in range(2):
        p_f, st_f, _ = TO.adamw_update_mixed(toc, tg, st_f, p_f)
        p_i, st_i, _ = TO.adamw_update_mixed_(toc, tg, st_i, p_i)
    assert_trees_bitwise(p_i, p_f, "mixed params")
    assert_trees_bitwise(st_i, st_f, "mixed state")


def test_global_norm_in_reference_order():
    jt, tt = both(random_tree(3, 2.0))
    got, want = TO.global_norm(tt), JO.global_norm(jt)
    assert abs(float(got) - float(want)) <= REL * float(want)
    # the sum is taken leaf by leaf in jax.tree.leaves' order
    sq = [torch.sum(torch.square(t)) for _, t, _ in leaf_pairs(tt, jt)]
    total = 0
    for s in sq:
        total = total + s
    assert torch.equal(got, torch.sqrt(total))


def test_compress_decompress_bit_for_bit():
    jt, tt = both(random_tree(4, 0.3))
    jef = tef = None
    for r in range(3):
        jg, jef = JC.compress_decompress(jt, jef)
        tg, tef = TC.compress_decompress(tt, tef)
        for what, got, want in (("grads", tg, jg), ("ef", tef, jef)):
            for path, t, j in leaf_pairs(got, want):
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(
                    bits(torch_bits(t)), bits(np.asarray(j)),
                    err_msg=f"round {r} {what}{path}")
        # the next round's grads: this round's outputs (residuals grow)
        jt, tt = jg, tg


def test_compress_quantizes_to_127_levels():
    g = torch.linspace(-2, 2, 101)
    q, scale = TC._quantize(g)
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    assert float(scale) == pytest.approx(2 / 127, rel=1e-7)
    out, ef = TC.compress_decompress({"g": g})
    # what was dropped is carried: dequantised + residual = the input
    assert float((out["g"] + ef["g"] - g).abs().max()) <= 2.5e-7
