"""The module that holds the TMFU kernel (``repro_torch.kernels.tmfu``), on
the CPU: the public wrappers' padding, output-row gather and trim, the
donated (in-place) entry point, the argument checks, and ``_imm_to_i32`` —
against the JAX package's plain executor.  All comparisons are on bit
patterns; no tolerance.

The CUDA kernel itself cannot run without a GPU: ``chip_smoke.py`` holds it
against the plain versions on the card.  The few tests here that need CUDA
carry the ``cuda`` marker and skip without a device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jbank
from repro.core import overlay as joverlay
from repro.core import paper_bench as jbench
from repro.core import vm as jvm
from repro.kernels.tmfu import ops as jops
from repro_torch.core import bank as tbank
from repro_torch.core import overlay as toverlay
from repro_torch.core import paper_bench as tbench
from repro_torch.core import vm as tvm
from repro_torch.kernels import tmfu as ttmfu
from repro_torch.kernels.tmfu import kernel as tkernel
from repro_torch.kernels.tmfu import ops as tops
from torch_port_support import (DTYPE_NAMES, assert_same_result, both,
                                dtype_pair, random_inputs)

torch.set_num_threads(1)

NAMES = tuple(jbench.BENCH_NAMES) + ("gradient",)


def _contexts(name, dtype):
    jd, td = dtype_pair(dtype)
    jk = joverlay.compile_program(jbench.benchmark(name))
    tk = toverlay.compile_program(tbench.benchmark(name))
    return (jvm.make_context(jk.program, dtype=jd),
            tvm.make_context(tk.program, dtype=td, device="cpu"))


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("name", NAMES)
def test_tmfu_pipeline_matches_jax_vm_exec(name, dtype):
    """Batch 777 pads to 1024 (two blocks of 512), runs, gathers the output
    rows and trims back: the same rows ``vm_exec`` gives."""
    jc, tc = _contexts(name, dtype)
    pairs = [both(v, dtype)
             for v in random_inputs(jc.n_inputs, 777, dtype, seed=2)]
    jx = jvm.pad_inputs([p[0] for p in pairs])
    tx = tvm.pad_inputs([p[1] for p in pairs])
    want = jvm.vm_exec(jc.tree(), jc.out_idx, jx)
    got = tops.tmfu_pipeline(tc, tx)
    assert got.shape == (tc.n_outputs, 777)
    assert_same_result(got, want, f"{name}/{dtype}")


@pytest.mark.parametrize("batch,block", [(128, 128), (384, 128), (1024, 512),
                                         (100, 128), (777, 256)])
def test_tmfu_pipeline_shape_sweep(batch, block):
    jc, tc = _contexts("poly6", "float32")
    pairs = [both(v, "float32")
             for v in random_inputs(jc.n_inputs, batch, "float32", seed=3)]
    want = jvm.vm_exec(jc.tree(), jc.out_idx,
                       jvm.pad_inputs([p[0] for p in pairs]))
    got = tops.tmfu_pipeline(tc, tvm.pad_inputs([p[1] for p in pairs]),
                             block_batch=block)
    assert_same_result(got, want, f"{batch}/{block}")


def _banks(dtype, names=NAMES):
    jd, td = dtype_pair(dtype)
    jb = jbank.ContextBank(len(names), dtype=jd)
    tb = tbank.ContextBank(len(names), dtype=td, device="cpu")
    for n in names:
        jb.load(joverlay.compile_program(jbench.benchmark(n)))
        tb.load(toverlay.compile_program(tbench.benchmark(n)))
    return jb, tb


def _tiles(dtype, G, n_ctx, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, n_ctx, size=G).astype(np.int32)
    if dtype == "int32":
        x = rng.randint(-6, 7, size=(G, 32, 128)).astype(np.int32)
    else:
        x = rng.uniform(-2, 2, (G, 32, 128)).astype(np.float32)
    return ids, x


@pytest.mark.parametrize("donate", (False, True), ids=("fresh", "donated"))
@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_tmfu_pipeline_multi_matches_jax_vm_exec_multi(dtype, donate):
    jb, tb = _banks(dtype)
    ids, x = _tiles(dtype, 16, len(NAMES), seed=4)
    jx, tx = both(x, dtype)
    want = jvm.vm_exec_multi(jb.tree(), jb.out_idx, jnp.asarray(ids), jx)
    keep = tx.clone()
    got = tops.tmfu_pipeline_multi(tb, torch.from_numpy(ids), tx,
                                   donate=donate)
    assert got.shape == (16, tb.max_outputs, 128)
    assert_same_result(got, want, f"{dtype}/donate={donate}")
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    if donate:
        # in place: the tile stack now holds the final register files
        rf = tkernel.tmfu_pipeline_rf_multi_plain(
            tb.op, tb.src_a, tb.src_b, tops._imm_to_i32(tb.imm),
            torch.from_numpy(ids), keep)
        assert torch.equal(tx.view(bits), rf.view(bits))
    else:
        assert torch.equal(tx.view(bits), keep.view(bits))


def test_donated_wrapper_returns_its_input():
    _, tb = _banks("float32", NAMES[:3])
    ids, x = _tiles("float32", 4, 3, seed=5)
    tx = torch.from_numpy(x)
    want = ttmfu.tmfu_pipeline_rf_multi(
        tb.op, tb.src_a, tb.src_b, tops._imm_to_i32(tb.imm),
        torch.from_numpy(ids), tx.clone())
    out = ttmfu.tmfu_pipeline_rf_multi_donated(
        tb.op, tb.src_a, tb.src_b, tops._imm_to_i32(tb.imm),
        torch.from_numpy(ids), tx)
    assert out is tx
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_imm_to_i32_matches_jax(dtype):
    jc, tc = _contexts("chebyshev", dtype)
    want = np.asarray(jops._imm_to_i32(jc.imm))
    got = tops._imm_to_i32(tc.imm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and back: the datapath sees the same immediates
    back = tkernel._imm_from_i32(got, tc.imm.dtype)
    assert torch.equal(back.view(torch.int16 if dtype == "bfloat16"
                                 else torch.int32),
                       tc.imm.view(torch.int16 if dtype == "bfloat16"
                                   else torch.int32))


def test_round_up():
    assert [tops._round_up(n, 128) for n in (1, 128, 129, 777)] == \
        [jops._round_up(n, 128) for n in (1, 128, 129, 777)]


# ------------------------------------------------------------ argument checks
def _multi_args():
    _, tb = _banks("float32", NAMES[:2])
    ids, x = _tiles("float32", 4, 2, seed=6)
    return [tb.op, tb.src_a, tb.src_b, tops._imm_to_i32(tb.imm),
            torch.from_numpy(ids), torch.from_numpy(x)]


@pytest.mark.parametrize("case", ["x_dtype", "x_rows", "x_ndim",
                                  "x_strided", "ids_dtype", "ids_len",
                                  "op_dtype", "op_shape", "imm_shape",
                                  "op_strided", "empty"])
def test_multi_wrapper_rejects(case):
    a = _multi_args()
    if case == "x_dtype":
        a[5] = a[5].double()
    elif case == "x_rows":
        a[5] = a[5][:, :31].contiguous()
    elif case == "x_ndim":
        a[5] = a[5][0]
    elif case == "x_strided":
        a[5] = a[5][:, :, ::2]
    elif case == "ids_dtype":
        a[4] = a[4].long()
    elif case == "ids_len":
        a[4] = a[4][:3]
    elif case == "op_dtype":
        a[0] = a[0].long()
    elif case == "op_shape":
        a[0] = a[0][:, :, :31].contiguous()
    elif case == "imm_shape":
        a[3] = a[3][:1]
    elif case == "op_strided":
        a[1] = a[1].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "empty":
        a[5], a[4] = a[5][:0], a[4][:0]
    with pytest.raises((TypeError, ValueError)):
        ttmfu.tmfu_pipeline_rf_multi(*a)
    with pytest.raises((TypeError, ValueError)):
        ttmfu.tmfu_pipeline_rf_multi_donated(*a)


@pytest.mark.parametrize("case", ["x_dtype", "x_rows", "x_strided",
                                  "batch_not_multiple", "op_shape",
                                  "imm_dtype"])
def test_single_wrapper_rejects(case):
    _, tc = _contexts("poly6", "float32")
    a = [tc.op, tc.src_a, tc.src_b, tops._imm_to_i32(tc.imm),
         torch.zeros(32, 256)]
    kw = {"block_batch": 128}
    if case == "x_dtype":
        a[4] = a[4].half()
    elif case == "x_rows":
        a[4] = torch.zeros(16, 256)
    elif case == "x_strided":
        a[4] = torch.zeros(256, 32).t()
    elif case == "batch_not_multiple":
        kw["block_batch"] = 100
    elif case == "op_shape":
        a[0] = a[0][None]
    elif case == "imm_dtype":
        a[3] = tc.imm
    with pytest.raises((TypeError, ValueError)):
        ttmfu.tmfu_pipeline_rf(*a, **kw)


def test_cpu_tensors_never_count_as_launches():
    """The launch counters move only where a CUDA kernel is launched."""
    before = dict(tkernel.launch_counts)
    a = _multi_args()
    ttmfu.tmfu_pipeline_rf_multi(*a)
    ttmfu.tmfu_pipeline_rf_multi_donated(*a)
    assert tkernel.launch_counts == before
    assert set(before) == {"tmfu_multi", "tmfu_multi_inplace", "tmfu_single"}


def test_build_is_lazy_and_names_the_source():
    """Importing the module builds nothing; the source it would build is in
    the package and the flags keep IEEE arithmetic (no fast-math, no FMA)."""
    assert tkernel._lib is None or torch.cuda.is_available()
    assert tkernel.SOURCE.is_file() and tkernel.SOURCE.suffix == ".cu"
    flags = " ".join(tkernel.NVCC_FLAGS)
    assert "sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags and "ftz" not in flags
    assert "-prec-div=false" not in flags and "-prec-sqrt=false" not in flags
    src = tkernel.SOURCE.read_text()
    assert 'extern "C" int tmfu_multi' in src
    assert 'extern "C" int tmfu_single' in src
    # the source keeps the explicit round-to-nearest intrinsics and asks for
    # no fused or approximate arithmetic itself
    for rn in ("__fadd_rn", "__fsub_rn", "__fmul_rn", "__float2bfloat16_rn"):
        assert rn in src
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for banned in ("fma", "__fdividef", "__expf", "FP_CONTRACT", "fast_math",
                   "ftz"):
        assert banned not in code, banned


# ------------------------------------------------------------------ on a GPU
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_multi_kernel_matches_plain(cuda_device):
    a = [t.to(cuda_device) for t in _multi_args()]
    tkernel.reset_launch_counts()
    want = tkernel.tmfu_pipeline_rf_multi_plain(*a)
    got = ttmfu.tmfu_pipeline_rf_multi(*a)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert tkernel.launch_counts["tmfu_multi"] == 1
    x = a[5].clone()
    out = ttmfu.tmfu_pipeline_rf_multi_donated(*a[:5], x)
    torch.cuda.synchronize()
    assert out is x and torch.equal(x.view(torch.int32), want.view(torch.int32))
    assert tkernel.launch_counts["tmfu_multi_inplace"] == 1


@pytest.mark.cuda
def test_cuda_single_kernel_matches_plain(cuda_device):
    _, tc = _contexts("poly6", "float32")
    a = [tc.op, tc.src_a, tc.src_b, tops._imm_to_i32(tc.imm),
         torch.from_numpy(np.random.RandomState(0).uniform(
             -2, 2, (32, 1024)).astype(np.float32))]
    a = [t.to(cuda_device) for t in a]
    want = tkernel.tmfu_pipeline_rf_plain(*a)
    got = ttmfu.tmfu_pipeline_rf(*a)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
