"""The port's LM (``repro_torch.models``) against the reference's on all
ten smoke configs, on the CPU, in float32 mode; the structural checks
(param counts of the full configs, tm == spatial, the weight carrier).

Weights are drawn by ``numpy_params`` (``numpy.random.RandomState``),
handed to JAX as ``jnp.asarray`` and to the port by ``params_from_numpy``.

**float32 mode**: ``COMPUTE_DTYPE`` is monkeypatched to float32 in
``repro.models.layers``, ``repro.models.model`` and the port's two
counterparts.  Logits, loss and aux agree to ``max|a - b| <= 1e-5 *
max|b|`` (``REL_F32``): both sides compute in float32 (unit roundoff
6e-8) and differ in summation order and in exp / sin / cos; the largest
difference seen is 2.5e-6.  TF32 (2^-11) or one bfloat16 step (2^-8)
would fail it.  The caches stay bfloat16 in both packages (``init_caches``'
default), so prefill's cache leaves agree to one bf16 ulp (``rtol =
2^-7``; ``atol = 1e-5``, the float32 error of a value near zero, which is
a difference of O(1) terms).  The decode step then runs on the reference's prefill caches
widened to float32 in both packages (a bf16 cache would put a bf16
rounding — mamba's conv runs in the cache dtype — back in the float32
path) and agrees to ``REL_F32``.

The bfloat16 mode is ``tests/test_torch_lm_model_bf16.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro.models.model as JM
import repro_torch.models.layers as TL
import repro_torch.models.model as TM
from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import numpy_params, params_from_numpy
from repro_torch.models.blocks import tree_leaves

REL_F32 = 1e-5
BF16_ULP = dict(rtol=2 ** -7, atol=1e-5)
B, S, PROMPT = 2, 32, 16


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def jax_to_torch(x, dtype=None) -> torch.Tensor:
    """A JAX array as a tensor, bf16 bits kept (then cast to ``dtype``)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t if dtype is None else t.to(dtype)


def jax_tree_to_torch(tree, dtype=None):
    """A JAX cache tree (lists of dicts) as the port's, leaves cast to
    ``dtype`` where given."""
    if isinstance(tree, dict):
        return {k: jax_tree_to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_torch(v, dtype) for v in tree]
    return jax_to_torch(tree, dtype)


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (over 1 where want is all 0)."""
    got, want = to_np(got), to_np(want)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale else 1.0))


def pairs(port_tree, jax_tree, path=""):
    """(path, port leaf, reference leaf) of two trees, walked by key (JAX
    orders a dict's leaves by sorted key, the port by insertion)."""
    if isinstance(port_tree, dict):
        assert set(port_tree) == set(jax_tree), path
        for k in port_tree:
            yield from pairs(port_tree[k], jax_tree[k], f"{path}/{k}")
    elif isinstance(port_tree, (list, tuple)):
        assert len(port_tree) == len(jax_tree), path
        for i, (a, b) in enumerate(zip(port_tree, jax_tree)):
            yield from pairs(a, b, f"{path}/{i}")
    else:
        yield path, port_tree, jax_tree


def set_mode(monkeypatch, mode: str) -> None:
    if mode == "float32":
        for mod in (JL, JM):
            monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
        for mod in (TL, TM):
            monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


@dataclasses.dataclass
class Case:
    """One arch's smoke config, weights and inputs in both packages."""
    jcfg: object
    tcfg: object
    jp: dict
    tp: dict
    tokens: np.ndarray            # [B, S] int32
    vision: np.ndarray | None     # [B, Sv, D], bf16-representable
    frames: np.ndarray | None     # [B, S, D], bf16-representable

    def embeds(self, mode, n=S):
        """(JAX kwargs, port kwargs) of the stub embeds, in the mode's
        compute dtype, frames cut to ``n``."""
        jd = jnp.float32 if mode == "float32" else jnp.bfloat16
        td = torch.float32 if mode == "float32" else torch.bfloat16
        jk, tk = {}, {}
        if self.vision is not None:
            jk["extra_embeds"] = jnp.asarray(self.vision, jd)
            tk["extra_embeds"] = torch.from_numpy(self.vision).to(td)
        if self.frames is not None:
            jk["frame_embeds"] = jnp.asarray(self.frames[:, :n], jd)
            tk["frame_embeds"] = torch.from_numpy(self.frames[:, :n]).to(td)
        return jk, tk


def bf16_values(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).bfloat16().float().numpy()


def make_case(arch: str, seed: int = 0) -> Case:
    tcfg, jcfg = torch_smoke(arch), jax_smoke(arch)
    tree = numpy_params(tcfg, seed)
    rng = np.random.RandomState(seed + 1)
    tokens = rng.randint(0, tcfg.vocab, (B, S)).astype(np.int32)
    vision = frames = None
    if tcfg.vision_tokens:
        vision = bf16_values(rng.standard_normal(
            (B, tcfg.vision_tokens, tcfg.d_model)).astype(np.float32))
    if tcfg.encoder is not None:
        frames = bf16_values(rng.standard_normal(
            (B, S, tcfg.d_model)).astype(np.float32))
    return Case(jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                params_from_numpy(tcfg, tree, "cpu"), tokens, vision, frames)


def run_both(case: Case, mode: str) -> dict:
    """Every entry point in both packages: name -> (port, reference)."""
    out = {}
    jk, tk = case.embeds(mode)
    jl, ja, _ = JM.forward(case.jcfg, case.jp, jnp.asarray(case.tokens), **jk)
    tl, ta, _ = TM.forward(case.tcfg, case.tp, torch.from_numpy(case.tokens),
                           **tk)
    out["forward"], out["aux"] = (tl, jl), (ta, ja)
    jk, tk = case.embeds(mode, S - 1)
    jb = {"tokens": jnp.asarray(case.tokens),
          **{("vision_embeds" if k == "extra_embeds" else k): v
             for k, v in jk.items()}}
    tb = {"tokens": torch.from_numpy(case.tokens),
          **{("vision_embeds" if k == "extra_embeds" else k): v
             for k, v in tk.items()}}
    out["loss"] = (TM.loss_fn(case.tcfg, case.tp, tb),
                   JM.loss_fn(case.jcfg, case.jp, jb))
    jk, tk = case.embeds(mode, PROMPT)
    cache_len = PROMPT + 8 + case.tcfg.vision_tokens
    jlast, jcache = JM.prefill(case.jcfg, case.jp,
                               jnp.asarray(case.tokens[:, :PROMPT]),
                               cache_len=cache_len, **jk)
    tlast, tcache = TM.prefill(case.tcfg, case.tp,
                               torch.from_numpy(case.tokens[:, :PROMPT]),
                               cache_len=cache_len, **tk)
    out["prefill"] = (tlast, jlast)
    out["caches"] = (tcache, jcache)
    # one decode step on the reference's caches (widened to float32 in
    # float32 mode), in both packages
    wide = mode == "float32"
    jcache_in = jax.tree.map(
        lambda x: x.astype(jnp.float32) if wide else x, jcache)
    tcache_in = jax_tree_to_torch(jcache, torch.float32 if wide else None)
    pos = PROMPT + case.tcfg.vision_tokens
    tok = case.tokens[:, PROMPT:PROMPT + 1]
    jd, jc = JM.decode_step(case.jcfg, case.jp, jcache_in, jnp.asarray(tok),
                            jnp.asarray(pos))
    td, tc = TM.decode_step(case.tcfg, case.tp, tcache_in,
                            torch.from_numpy(tok), pos)
    out["decode"] = (td, jd)
    out["decode_caches"] = (tc, jc)
    return out


# ------------------------------------------------------------ float32 mode
@pytest.mark.parametrize("arch", ARCHS)
def test_float32_mode_matches_reference(arch, monkeypatch):
    set_mode(monkeypatch, "float32")
    case = make_case(arch)
    out = run_both(case, "float32")
    for name in ("forward", "prefill", "decode"):
        got, want = out[name]
        assert got.dtype == torch.float32, name
        assert got.shape == want.shape, name
        assert rel_err(got, want) <= REL_F32, (name, rel_err(got, want))
    for name in ("loss", "aux"):
        got, want = (float(x) for x in out[name])
        assert abs(got - want) <= REL_F32 * max(abs(want), 1.0), (name, got,
                                                                 want)
    for key, tol in (("caches", BF16_ULP), ("decode_caches", None)):
        leaves = list(pairs(*out[key]))
        assert leaves
        for path, t, j in leaves:
            assert tuple(t.shape) == j.shape, (key, path)
            if tol is None:        # decode's float32 caches
                assert rel_err(t, j) <= REL_F32, (key, path)
            else:
                np.testing.assert_allclose(to_np(t), to_np(j), **tol,
                                           err_msg=f"{key}{path}")


# ------------------------------------------------------------- structure
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_of_the_full_configs(arch):
    """``param_count`` (``init_params`` on the meta device) and
    ``active_param_count`` equal the reference's (``jax.eval_shape``)."""
    tcfg, jcfg = torch_config(arch), jax_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


def test_param_counts_named_values():
    assert torch_config("deepseek-7b").param_count() == 6_910_365_696
    phi = torch_config("phi3.5-moe-42b-a6.6b")
    assert phi.param_count() == 41_872_527_360
    assert phi.active_param_count() == 6_640_373_760


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_equal_the_reference(arch):
    """Every field of the published config, stacks and specs included."""
    assert repr(torch_config(arch)) == repr(jax_config(arch))
    assert repr(torch_smoke(arch)) == repr(jax_smoke(arch))


def _structure(tree):
    """Keys, list lengths and leaf shapes of a tree."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_carrier_tree_matches_init_params(arch):
    """``params_from_numpy`` of a tree of the reference's ``init_params``
    structure (keys, lists, shapes from ``jax.eval_shape``; random values)
    gives the port's tree: the same keys, list lengths and shapes as the
    port's ``init_params`` (zamba2's shared attention unstacked), values
    unchanged."""
    tcfg, jcfg = torch_smoke(arch), jax_smoke(arch)
    shapes = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.RandomState(0)
    jtree = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), shapes)
    carried = params_from_numpy(tcfg, jtree, "cpu")
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _structure(carried) == _structure(own) == _structure(jtree)
    for path, t, j in pairs(carried, jtree):
        assert t.dtype == torch.float32, path
        np.testing.assert_array_equal(t.numpy(), j, err_msg=path)
    if arch == "zamba2-7b":
        shared = carried["stacks"][0][0]
        assert shared["attn"]["wq"]["w"].shape == (64, 64)   # unstacked
        assert carried["stacks"][0][1]["ln"]["g"].shape == (2, 64)


def test_carrier_rejects_a_wrong_tree():
    cfg = torch_smoke("deepseek-7b")
    tree = numpy_params(cfg, 0)
    bad = dict(tree, head=tree["head"][:, :10])
    with pytest.raises(ValueError, match="head"):
        params_from_numpy(cfg, bad, "cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(cfg, {k: v for k, v in tree.items()
                                if k != "embed"}, "cpu")


def test_numpy_params_are_seeded():
    cfg = torch_smoke("mamba2-2.7b")
    a, b = numpy_params(cfg, 5), numpy_params(cfg, 5)
    c = numpy_params(cfg, 6)
    la, lb, lc = (tree_leaves(t) for t in (a, b, c))
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    assert not np.array_equal(a["embed"], c["embed"])
    # the deterministic leaves are the reference's
    mixer = a["stacks"][0][0]["mixer"]
    np.testing.assert_allclose(
        mixer["A_log"][0], np.log(np.linspace(1.0, 16.0, 8)), rtol=1e-6)
