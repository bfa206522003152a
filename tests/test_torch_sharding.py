"""The port's sharding rules, mesh shapes, straggler helpers and test
helper against the reference's, on the CPU with no process group.

* ``runtime/sharding.py``: for the ten configs, both layouts and the
  meshes (data 2, model 2), (data 16, model 16) and (pod 2, data 16,
  model 16), the port's ``param_shardings``, ``cache_shardings`` (batch
  1: sequence parallel; batch 8), ``batch_shardings``, ``opt_shardings``
  and ``sanitize`` trees equal the reference's ``PartitionSpec`` trees
  leaf by leaf, paths included; mamba2-2.7b's vocab, which a 16-way
  ``model`` axis does not divide, stays whole in both.  The port's rules
  read a ``(names, sizes)`` description of the mesh; the reference's a
  ``Mesh`` over repeated fake devices (``tests/test_sharding_rules.py``'s
  way).
* ``to_placements``: a dim split over several axes is ``Shard`` on each
  of them; a size-1 mesh dim replicates.
* ``launch/mesh.py``: the re-mesh shapes for 1-16 survivors and the
  production mesh's shape equal the reference's.
* ``distributed/elastic.py``: ``straggler_scale`` and
  ``accumulate_with_deadline`` bit for bit in float32.
* ``testing.py``: the fallback draws the reference's examples; with a
  ``hypothesis`` module present it re-exports it.
"""

import functools
import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import repro.launch.mesh as JM
from repro.configs import ARCHS, get_config as jax_config
from repro.distributed import elastic as JE
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.runtime import sharding as JS
from repro_torch.configs import get_config as torch_config
from repro_torch.distributed import elastic as TE
from repro_torch.launch import mesh as TM
from repro_torch.models import init_caches, init_params
from repro_torch.models.blocks import tree_leaves_with_path
from repro_torch.runtime import sharding as TS

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices() * n)[:n].reshape(shape), names)


def _ref_specs(tree) -> list:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in leaves]


def _port_specs(tree) -> list:
    return [(p, s.entries) for p, s in tree_leaves_with_path(tree)]


def same(port_tree, ref_tree):
    got, want = _port_specs(port_tree), _ref_specs(ref_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a == b, f"{path}: {a} != {b}"


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference ShapeDtypeStructs, port meta tensors) of the params and
    of a batch-8 cache of 64 slots."""
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    jp = jax.eval_shape(lambda k: jax_init_params(jcfg, k),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    mem = 16 if jcfg.encoder is not None else 0
    jc = jax.eval_shape(lambda: jax_init_caches(jcfg, 8, 64, mem))
    tp = init_params(tcfg, device="meta")
    tc = init_caches(tcfg, 8, 64, mem, device="meta")
    return jp, jc, tp, tc


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("layout", ["2d", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_the_reference(arch, layout, mesh):
    shape, names = MESHES[mesh]
    jm, tm = _jax_mesh(shape, names), (names, shape)
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    jax_ax, ax = JS.for_mesh(jm, layout), TS.for_mesh(tm, layout)
    assert (ax.batch, ax.tp) == (jax_ax.batch, jax_ax.tp)
    assert ax.sizes(tm) == jax_ax.sizes(jm)
    jp_sds, jc_sds, tp_meta, tc_meta = _shapes(arch)

    jparams = JS.param_shardings(jcfg, jm, jax_ax)
    tparams = TS.param_shardings(tcfg, tm, ax)
    same(tparams, jparams)
    same(TS.sanitize(tparams, tp_meta, tm), JS.sanitize(jparams, jp_sds, jm))
    same(TS.opt_shardings(tparams), JS.opt_shardings(jparams))
    for batch in (1, 8):
        jcache = JS.cache_shardings(jcfg, jm, batch, jax_ax)
        tcache = TS.cache_shardings(tcfg, tm, batch, ax)
        same(tcache, jcache)
        same(TS.batch_shardings(tcfg, tm, batch, "train", ax),
             JS.batch_shardings(jcfg, jm, batch, "train", jax_ax))
    same(TS.sanitize(tcache, tc_meta, tm), JS.sanitize(jcache, jc_sds, jm))


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_a_vocab_the_model_axis_does_not_divide_stays_whole(mesh):
    """mamba2-2.7b's vocab, 50 280, on a 16-way ``model`` axis: both
    packages' ``sanitize`` drop the vocab split of the embedding and the
    head, which then stay whole on every ``model`` rank (a settled
    difference from an ideal layout, not a fault of the port: a padded
    vocab split is a feature the reference lacks)."""
    shape, names = MESHES[mesh]
    jm, tm = _jax_mesh(shape, names), (names, shape)
    jcfg, tcfg = jax_config("mamba2-2.7b"), torch_config("mamba2-2.7b")
    assert tcfg.vocab == 50280 and tcfg.vocab % 16
    jp_sds, _, tp_meta, _ = _shapes("mamba2-2.7b")
    port = TS.sanitize(TS.param_shardings(tcfg, tm, TS.for_mesh(tm, "2d")),
                       tp_meta, tm)
    ref = JS.sanitize(JS.param_shardings(jcfg, jm, JS.for_mesh(jm, "2d")),
                      jp_sds, jm)
    assert TS.param_shardings(tcfg, tm)["embed"].entries[0] == "model"
    for leaf in ("embed", "head"):
        assert port[leaf].entries == tuple(ref[leaf]), leaf
        assert "model" not in port[leaf].entries, (leaf, port[leaf])


def test_to_placements_layouts():
    from torch.distributed.tensor import Replicate, Shard
    big = (("pod", "data", "model"), (2, 16, 16))
    assert TS.to_placements(TS.Spec(("pod", "data"), "model"), big) == [
        Shard(0), Shard(0), Shard(1)]
    assert TS.to_placements(TS.Spec(None, "model", ("pod", "data")), big) \
        == [Shard(2), Shard(2), Shard(1)]
    assert TS.to_placements(TS.Spec(), big) == [Replicate()] * 3
    # a mesh dim of size 1 splits nothing
    one = (("data", "model"), (4, 1))
    assert TS.to_placements(TS.Spec("data", "model"), one) == [
        Shard(0), Replicate()]
    with pytest.raises(ValueError, match="order"):
        TS.to_placements(TS.Spec(("data", "pod")), big)
    with pytest.raises(ValueError, match="twice"):
        TS.to_placements(TS.Spec("data", "data"), big)
    # a one-name tuple is the name, as in PartitionSpec
    assert TS.Spec(("data",), ()).entries == tuple(P(("data",), ())) \
        == ("data", None)


@pytest.mark.parametrize("model_parallel", [1, 2, 4, 16])
def test_remesh_shapes_equal_the_reference(model_parallel):
    for n in range(1, 17):
        ref = JM.make_mesh_from_devices(jax.devices() * n, model_parallel)
        assert TM.mesh_from_devices_shape(n, model_parallel) == \
            tuple(ref.devices.shape), n
        assert ref.axis_names == ("data", "model")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_equals_the_reference(multi_pod, monkeypatch):
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: (shape, axes))
    assert TM.production_mesh_shape(multi_pod) == \
        JM.make_production_mesh(multi_pod=multi_pod)
    # the mesh itself needs a world of one rank a GPU of that size
    with pytest.raises(ValueError, match="needs a world of"):
        TM.make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("mask", [[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 0, 0],
                                  [0, 1, 0, 0], [1, 0, 0, 1]])
def test_deadline_accumulation_bits_equal_the_reference(mask):
    """``accumulate_with_deadline`` (the reference's ``lax.scan`` as a loop)
    and ``straggler_scale``: the same float32 bits.  The stand-in gradient
    adds and subtracts only: XLA's CPU backend contracts a product that
    feeds the accumulating add into one FMA, which no other float32
    program rounds the same way."""
    rng = np.random.RandomState(sum(mask) * 7 + len(mask))
    w = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    mbs = rng.standard_normal((4, 5)).astype(np.float32)
    ok = np.asarray(mask, bool)

    def grad(p, mb):
        return {"w": p["w"] + mb, "b": p["b"] - mb}

    jg, jk = JE.accumulate_with_deadline(
        grad, {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(mbs),
        jnp.asarray(ok))
    tg, tk_ = TE.accumulate_with_deadline(
        grad, {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
        torch.from_numpy(mbs), torch.from_numpy(ok))
    assert int(tk_) == int(jk) == ok.sum()
    for k in ("w", "b"):
        np.testing.assert_array_equal(_bits(tg[k].numpy()), _bits(jg[k]))
    js = JE.straggler_scale({"w": jnp.asarray(w)}, jnp.asarray(3), 4)
    ts = TE.straggler_scale({"w": torch.from_numpy(w)}, torch.tensor(3), 4)
    np.testing.assert_array_equal(_bits(ts["w"].numpy()), _bits(js["w"]))


# ----------------------------------------------------------------- testing
def _fresh(package, monkeypatch, hide_hypothesis):
    """A fresh copy of ``<package>/testing.py`` (the imported module is
    left alone), with ``hypothesis`` hidden or present."""
    if hide_hypothesis:
        monkeypatch.setitem(sys.modules, "hypothesis", None)
        monkeypatch.setitem(sys.modules, "hypothesis.strategies", None)
    path = ROOT / "src" / package / "testing.py"
    spec = importlib.util.spec_from_file_location(f"_{package}_testing",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _draws(mod, n=6):
    out = []

    @mod.settings(max_examples=n)
    @mod.given(mod.st.integers(-5, 1000), mod.st.sampled_from("abcdef"),
               d=mod.st.data())
    def probe(a, b, d):
        out.append((a, b, d.draw(mod.st.integers(0, 9))))

    probe()
    return out


def test_testing_fallback_draws_the_references_examples(monkeypatch):
    """Without hypothesis, the seeded fallback runs ``max_examples``
    examples (25 by default) and draws what the reference's draws."""
    port = _fresh("repro_torch", monkeypatch, hide_hypothesis=True)
    ref = _fresh("repro", monkeypatch, hide_hypothesis=True)
    assert not port.HAVE_HYPOTHESIS and not ref.HAVE_HYPOTHESIS
    got, want = _draws(port), _draws(ref)
    assert got == want and len(got) == 6
    assert len(_draws(port, 25)) == 25
    assert port.given(port.st.integers(0, 1))(lambda a: None).__name__ \
        == "<lambda>"


def test_testing_reexports_hypothesis_where_installed(monkeypatch):
    """With hypothesis present the helper re-exports its ``given``,
    ``settings`` and ``strategies`` (a stand-in module where hypothesis
    is not installed)."""
    if importlib.util.find_spec("hypothesis") is None:
        hyp = types.ModuleType("hypothesis")
        hyp.strategies = types.ModuleType("hypothesis.strategies")
        hyp.given, hyp.settings = object(), object()
        monkeypatch.setitem(sys.modules, "hypothesis", hyp)
        monkeypatch.setitem(sys.modules, "hypothesis.strategies",
                            hyp.strategies)
    import hypothesis
    mod = _fresh("repro_torch", monkeypatch, hide_hypothesis=False)
    assert mod.HAVE_HYPOTHESIS
    assert mod.given is hypothesis.given
    assert mod.settings is hypothesis.settings
    assert mod.st is hypothesis.strategies
