"""Front end of the PyTorch port against the JAX package: the same nine
kernels compile to byte-identical programs, context keys and context images.

Everything here is integer or bit-pattern equality; no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jbank
from repro.core import overlay as joverlay
from repro.core import paper_bench as jbench
from repro.core import vm as jvm
from repro_torch.core import bank as tbank
from repro_torch.core import overlay as toverlay
from repro_torch.core import paper_bench as tbench
from repro_torch.core import vm as tvm
from repro_torch.core.frontend import build_dfg as t_build_dfg
from repro.core.frontend import build_dfg as j_build_dfg

torch.set_num_threads(1)

NAMES = tuple(jbench.BENCH_NAMES) + ("gradient",)
DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16),
          ("int32", jnp.int32, torch.int32)]


def _pair(name):
    return (joverlay.compile_program(jbench.benchmark(name)),
            toverlay.compile_program(tbench.benchmark(name)))


def test_same_benchmark_set():
    assert tuple(tbench.BENCH_NAMES) == tuple(jbench.BENCH_NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_dfg_identical(name):
    jd, td = jbench.benchmark(name), tbench.benchmark(name)
    assert td.name == jd.name
    assert tuple(td.inputs) == tuple(jd.inputs)
    assert tuple(td.outputs) == tuple(jd.outputs)
    assert td.topo_order() == jd.topo_order()
    for n in jd.topo_order():
        a, b = jd.nodes[n], td.nodes[n]
        assert (int(a.op), a.args, a.imm) == (int(b.op), b.args, b.imm)
    assert td.stats() == jd.stats()


@pytest.mark.parametrize("name", NAMES)
def test_program_byte_identical(name):
    jk, tk = _pair(name)
    jp, tp = jk.program, tk.program
    assert (tp.name, tp.n_inputs, tp.n_outputs, tp.ii) == \
        (jp.name, jp.n_inputs, jp.n_outputs, jp.ii)
    assert tp.context_bytes == jp.context_bytes
    assert len(tp.images) == len(jp.images)
    for ji, ti in zip(jp.images, tp.images):
        assert ti.words.dtype == ji.words.dtype == np.uint32
        assert ti.words.tobytes() == ji.words.tobytes()
        assert ti.consts.tobytes() == ji.consts.tobytes()
        assert (ti.stage, ti.n_loads) == (ji.stage, ji.n_loads)
    assert tk.sched.ii == jk.sched.ii
    np.testing.assert_array_equal(tvm._output_slots(tp), jvm._output_slots(jp))


@pytest.mark.parametrize("name", NAMES)
def test_context_key_identical(name):
    jk, tk = _pair(name)
    assert tbank.context_key(tk) == jbank.context_key(jk)
    assert tbank.context_key(tk.program) == jbank.context_key(jk.program)


@pytest.mark.parametrize("dtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("name", NAMES)
def test_make_context_identical(name, dtype):
    _, jdt, tdt = dtype
    jk, tk = _pair(name)
    jc = jvm.make_context(jk.program, dtype=jdt)
    tc = tvm.make_context(tk.program, dtype=tdt, device="cpu")
    for f in ("op", "src_a", "src_b", "out_idx"):
        got = getattr(tc, f)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jc, f)))
    assert tc.imm.dtype == tdt
    if tdt == torch.bfloat16:
        # numpy has no bfloat16: compare the 16-bit patterns
        got = tc.imm.view(torch.int16).numpy()
        want = np.asarray(jax.lax.bitcast_convert_type(jc.imm, jnp.int16))
    else:
        got, want = tc.imm.numpy(), np.asarray(jc.imm)
        assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    assert (tc.n_inputs, tc.n_outputs, tc.context_bytes) == \
        (jc.n_inputs, jc.n_outputs, jc.context_bytes)


def test_frontend_source_to_dfg_identical():
    src = ("t = (x - 1.5) * (y + 0.25)\n"
           "u = max(t, x) - abs(y)\n"
           "out = u * u + min(t, 2.0 - y)\n")
    jd = j_build_dfg("expr", inputs=["x", "y"], source=src, outputs=["out"])
    td = t_build_dfg("expr", inputs=["x", "y"], source=src, outputs=["out"])
    assert td.topo_order() == jd.topo_order()
    for n in jd.topo_order():
        a, b = jd.nodes[n], td.nodes[n]
        assert (int(a.op), a.args, a.imm) == (int(b.op), b.args, b.imm)
    jp = joverlay.compile_program(jd).program
    tp = toverlay.compile_program(td).program
    assert tbank.context_key(tp) == jbank.context_key(jp)


def test_make_context_rejects_too_many_stages():
    _, tk = _pair("poly6")
    with pytest.raises(ValueError):
        tvm.make_context(tk.program, s_max=1, device="cpu")


def test_device_rule_none_means_cuda():
    """No silent CPU fallback: without a CUDA device ``device=None`` raises;
    with one it resolves to it."""
    _, tk = _pair("poly6")
    if torch.cuda.is_available():
        assert tvm.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tvm.make_context(tk.program)
        with pytest.raises(RuntimeError):
            toverlay.Overlay()
        with pytest.raises(RuntimeError):
            tbank.ContextBank(4)
    assert tvm.resolve_device("cpu").type == "cpu"
