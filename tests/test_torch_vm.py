"""The port's plain executor against the JAX package's: ``vm_exec``,
``vm_exec_multi``, ``tmfu_ref`` and ``dfg_eval`` on the same numpy inputs.

float32, bfloat16 and int32 results are compared as BIT PATTERNS (NaN by
position); no tolerance is needed anywhere in this file.  The one number
class on which the two differ — float32 denormals, which XLA's CPU backend
flushes to zero and PyTorch keeps — is pinned down by its own test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import overlay as joverlay
from repro.core import paper_bench as jbench
from repro.core import vm as jvm
from repro.kernels.tmfu import ref as jref
from repro_torch.core import overlay as toverlay
from repro_torch.core import paper_bench as tbench
from repro_torch.core import vm as tvm
from repro_torch.kernels.tmfu import ref as tref
from torch_port_support import (DTYPE_NAMES, all_opcodes_context,
                                assert_same_result, both, dtype_pair,
                                random_inputs, special_lanes)

torch.set_num_threads(1)

NAMES = tuple(jbench.BENCH_NAMES) + ("gradient",)
BATCHES = (128, 100, 777)


def _contexts(name, dtype):
    jd, td = dtype_pair(dtype)
    jk = joverlay.compile_program(jbench.benchmark(name))
    tk = toverlay.compile_program(tbench.benchmark(name))
    return (jk, jvm.make_context(jk.program, dtype=jd),
            tk, tvm.make_context(tk.program, dtype=td, device="cpu"))


def _rf_images(xs, dtype):
    pairs = [both(v, dtype) for v in xs]
    return (jvm.pad_inputs([p[0] for p in pairs]),
            tvm.pad_inputs([p[1] for p in pairs]))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("name", NAMES)
def test_vm_exec_bit_identical(name, dtype, batch):
    jk, jc, tk, tc = _contexts(name, dtype)
    jx, tx = _rf_images(random_inputs(jc.n_inputs, batch, dtype, seed=batch),
                        dtype)
    want = jvm.vm_exec(jc.tree(), jc.out_idx, jx)
    got = tvm.vm_exec(tc.tree(), tc.out_idx, tx)
    assert got.shape == (tc.n_outputs, batch) and got.dtype == tx.dtype
    assert_same_result(got, want, f"{name}/{dtype}/{batch}")


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("name", NAMES)
def test_tmfu_ref_bit_identical(name, dtype):
    jk, jc, tk, tc = _contexts(name, dtype)
    jx, tx = _rf_images(random_inputs(jc.n_inputs, 128, dtype, seed=7), dtype)
    want = jref.tmfu_ref(np.asarray(jc.op), np.asarray(jc.src_a),
                         np.asarray(jc.src_b), np.asarray(jc.imm), jx)
    got = tref.tmfu_ref(tc.op.numpy(), tc.src_a.numpy(), tc.src_b.numpy(),
                        tvm.to_host(tc.imm), tx)
    assert_same_result(got, want, f"{name}/{dtype}")
    # and the per-instruction oracle agrees with the stage-wide executor
    full = tvm.run_stages(tc.op[None], tc.src_a[None], tc.src_b[None],
                          tc.imm[None], tx[None])[0]
    assert_same_result(full, want, f"{name}/{dtype} run_stages")


def _stacked(dtype, max_outputs=8):
    """All nine contexts stacked as a bank's arrays, on both sides."""
    jd, td = dtype_pair(dtype)
    js, ts, n_out = [], [], []
    for name in NAMES:
        _, jc, _, tc = _contexts(name, dtype)
        js.append(jc), ts.append(tc), n_out.append(tc.n_outputs)
    out_idx = np.zeros((len(NAMES), max_outputs), np.int32)
    for k, c in enumerate(ts):
        out_idx[k, :c.n_outputs] = c.out_idx.numpy()
    jtree = tuple(jnp.stack([getattr(c, f) for c in js])
                  for f in ("op", "src_a", "src_b", "imm"))
    ttree = tuple(torch.stack([getattr(c, f) for c in ts])
                  for f in ("op", "src_a", "src_b", "imm"))
    return jtree, ttree, out_idx, n_out


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_vm_exec_multi_bit_identical(dtype):
    jtree, ttree, out_idx, n_out = _stacked(dtype)
    rng = np.random.RandomState(11)
    G, T = 16, 128
    ids = rng.randint(0, len(NAMES), size=G).astype(np.int32)
    ids[:len(NAMES)] = np.arange(len(NAMES))         # every context at least once
    if dtype == "int32":
        x = rng.randint(-6, 7, size=(G, 32, T)).astype(np.int32)
    else:
        x = rng.uniform(-2, 2, (G, 32, T)).astype(np.float32)
    jx, tx = both(x, dtype)
    want = jvm.vm_exec_multi(jtree, jnp.asarray(out_idx), jnp.asarray(ids), jx)
    got = tvm.vm_exec_multi(ttree, torch.from_numpy(out_idx),
                            torch.from_numpy(ids), tx)
    assert got.shape == (G, 8, T)
    assert_same_result(got, want, dtype)
    # tile g alone through the single-context executor gives the same rows
    for g in (0, 5, G - 1):
        k = int(ids[g])
        one = tvm.vm_exec(tuple(leaf[k] for leaf in ttree),
                          torch.from_numpy(out_idx[k]), tx[g])
        assert torch.equal(one.view(torch.int16 if dtype == "bfloat16"
                                    else torch.int32),
                           got[g].view(torch.int16 if dtype == "bfloat16"
                                       else torch.int32))


@pytest.mark.parametrize("dtype", ("float32", "int32"))
@pytest.mark.parametrize("name", NAMES)
def test_dfg_eval_bit_identical(name, dtype):
    jd, td = jbench.benchmark(name), tbench.benchmark(name)
    xs = random_inputs(len(jd.inputs), 200, dtype, seed=3)
    pairs = [both(v, dtype) for v in xs]
    want = jvm.dfg_eval(jd, {n: p[0] for n, p in zip(jd.inputs, pairs)})
    got = tvm.dfg_eval(td, {n: p[1] for n, p in zip(td.inputs, pairs)})
    assert list(got) == list(want)
    for o in want:
        assert_same_result(got[o], want[o], f"{name}/{o}")


@pytest.mark.parametrize("name", NAMES)
def test_vm_exec_matches_dfg_oracle(name):
    """The port's executor against the port's own DFG oracle (float32):
    same operations in the same order, so the bits agree."""
    _, _, tk, tc = _contexts(name, "float32")
    xs = random_inputs(tc.n_inputs, 300, "float32", seed=5)
    ts = [torch.from_numpy(v) for v in xs]
    got = tvm.vm_exec(tc.tree(), tc.out_idx, tvm.pad_inputs(ts))
    oracle = tvm.dfg_eval(tk.dfg, dict(zip(tk.dfg.inputs, ts)))
    for j, o in enumerate(tk.dfg.outputs):
        np.testing.assert_allclose(got[j].numpy(), oracle[o].numpy(),
                                   rtol=1e-5, atol=1e-5)


# --------------------------------------------- all 18 opcodes, special values
def _special_case(dtype):
    kind = "int" if dtype == "int32" else "float"
    jd, td = dtype_pair(dtype)
    c = all_opcodes_context(kind)
    jx, tx = both(special_lanes(kind, 256), dtype)
    jimm = jnp.asarray(c["imm"], dtype=jd)
    fields = dict(c, imm=c["imm"].astype(np.int32 if kind == "int"
                                         else np.float32))
    tc = tvm.context_from_numpy(fields, "cpu", td)
    jtree = (jnp.asarray(c["op"]), jnp.asarray(c["src_a"]),
             jnp.asarray(c["src_b"]), jimm)
    return c, jtree, jx, tc, tx


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_all_opcodes_special_values_vm_exec(dtype):
    c, jtree, jx, tc, tx = _special_case(dtype)
    assert set(np.unique(c["op"])) == set(range(18))
    want = jvm.vm_exec(jtree, jnp.asarray(c["out_idx"]), jx)
    got = tvm.vm_exec(tc.tree(), tc.out_idx, tx)
    assert_same_result(got, want, dtype)
    if dtype != "int32":
        assert np.isnan(np.asarray(want).astype(np.float32)).any()
        assert np.isinf(np.asarray(want).astype(np.float32)).any()


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_all_opcodes_special_values_tmfu_ref(dtype):
    c, jtree, jx, tc, tx = _special_case(dtype)
    want = jref.tmfu_ref(c["op"][:3], c["src_a"][:3], c["src_b"][:3],
                         np.asarray(jtree[3])[:3], jx)
    got = tref.tmfu_ref(c["op"][:3], c["src_a"][:3], c["src_b"][:3],
                        tvm.to_host(tc.imm)[:3], tx)
    assert_same_result(got, want, dtype)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_max_min_signed_zero_and_nan(dtype):
    """``jnp.maximum(+0, -0) = jnp.maximum(-0, +0) = +0``, ``minimum`` gives
    ``-0`` both ways, NaN from either side wins; ``torch.maximum`` alone
    would let the first operand win on signed zeros."""
    a = np.array([0.0, -0.0, 0.0, -0.0, np.nan, 1.0, np.nan, -np.inf, 2.0],
                 np.float32)
    b = np.array([-0.0, 0.0, 0.0, -0.0, 1.0, np.nan, np.nan, np.inf, 2.0],
                 np.float32)
    (ja, ta), (jb, tb) = both(a, dtype), both(b, dtype)
    assert_same_result(tvm._maximum(ta, tb), jnp.maximum(ja, jb), "max")
    assert_same_result(tvm._minimum(ta, tb), jnp.minimum(ja, jb), "min")
    mx = tvm._maximum(ta, tb).float().numpy()
    mn = tvm._minimum(ta, tb).float().numpy()
    assert not np.signbit(mx[0]) and not np.signbit(mx[1])
    assert np.signbit(mn[0]) and np.signbit(mn[1])
    assert np.isnan(mx[4:7]).all() and np.isnan(mn[4:7]).all()


def test_denormals_differ_and_how():
    """The one stated difference: XLA's CPU backend flushes float32
    denormals to zero in arithmetic, PyTorch keeps them.  MULC by 0.5 of
    1e-40 gives 0 there and 5e-41 here; on normal numbers the same
    instruction agrees bit for bit."""
    op = np.zeros((1, 32), np.int32)
    op[0, 0] = 7                                     # MULC
    src = np.tile(np.arange(32, dtype=np.int32), (1, 1))
    imm = np.zeros((1, 32), np.float32)
    imm[0, 0] = 0.5
    x = np.zeros((32, 4), np.float32)
    x[0] = [1e-40, -1e-40, 3e-38, 1.5]
    want = np.asarray(jvm.vm_exec(
        (jnp.asarray(op), jnp.asarray(src), jnp.asarray(src),
         jnp.asarray(imm)), jnp.arange(1), jnp.asarray(x)))[0]
    tc = tvm.context_from_numpy(
        {"op": op, "src_a": src, "src_b": src, "imm": imm,
         "out_idx": np.arange(1), "n_inputs": 1, "n_outputs": 1,
         "context_bytes": 0}, "cpu")
    got = tvm.vm_exec(tc.tree(), tc.out_idx, torch.from_numpy(x))[0].numpy()
    assert want[0] == 0.0 and want[1] == 0.0          # flushed
    assert got[0] == np.float32(1e-40) * np.float32(0.5) != 0.0   # kept
    assert got[1] == -got[0]
    np.testing.assert_array_equal(got[2:].view(np.uint32),
                                  want[2:].view(np.uint32))
