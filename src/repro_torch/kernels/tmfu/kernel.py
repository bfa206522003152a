"""The TMFU pipeline kernels: CUDA launch wrappers and their plain versions.

Mapping of the paper's FU (Fig. 2/3) onto the GPU memory hierarchy — the
counterpart of the Pallas TPU kernels in ``src/repro/kernels/tmfu/kernel.py``:

  * Instruction memory (32x32 RAM32M)  -> the tile's context, 4 x S x 32
    int32 words, copied once per block from the bank into shared memory.
  * Register file (32-entry RAM32M)    -> two ping-ponged [32, 128] shared
    memory buffers; one thread per lane executes the same instruction on
    an independent kernel iteration (pipeline replication, paper Fig. 4).
  * DSP48E1 + config bits, no decoder  -> a ``switch`` on the 5-bit opcode,
    uniform across the block; operands read by run-time row index (the
    5-bit RF addresses).
  * Linear FU->FU interconnect         -> stage s writes its full result
    stream, which IS stage s+1's register file.

Which TPU kernel each entry point replaces:

  ``tmfu_pipeline_rf_multi``          <- ``tmfu_pipeline_rf_multi``
      (``_tmfu_kernel_multi`` over ``_run_stages``): CUDA ``tmfu_multi``
  ``tmfu_pipeline_rf_multi_donated``  <- ``tmfu_pipeline_rf_multi_donated``
      (``input_output_aliases``): CUDA ``tmfu_multi`` called with
      ``out == x``; safe because a block reads its whole tile into shared
      memory before it writes and touches no other block's columns
  ``tmfu_pipeline_rf``                <- ``tmfu_pipeline_rf``
      (``_tmfu_kernel``): CUDA ``tmfu_single``

What bounds them on an H100: ``G x 32 x T x itemsize`` bytes in and the
same out (32 KiB per float32 tile of 128 lanes) plus ``4 G`` bytes of ids
and at most ``N x 8 KiB`` of instructions, against ``S x 32 x T``
lane-operations per tile, each two shared-memory reads and one write.  They
are bound by device-memory bytes or by shared-memory traffic and instruction
rate, never by the tensor cores.  The source, ``csrc/tmfu.cu``, carries the
design notes.

The CUDA source is compiled with ``nvcc`` at first use into a shared
library with a plain C interface and loaded with ``ctypes``; nothing is
built when this module is imported.  Each wrapper launches its kernel for
a CUDA tensor — or raises — and takes its plain PyTorch version
(``*_plain``, over ``core.vm.run_stages``) only for a tensor that lies on
the CPU.  ``launch_counts`` counts kernel launches, and nothing else.

The wrappers assume what ``make_context`` and ``ContextBank`` guarantee:
``src_a``/``src_b`` in [0, 32), opcodes in [0, 18), ``ctx_ids`` in [0, N).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.core.isa import IM_DEPTH, RF_DEPTH
from repro_torch.core.vm import run_stages

DEFAULT_BLOCK_BATCH = 512

#: element types the kernels take, with the C interface's dtype code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

#: kernel launches since import (or ``reset_launch_counts``); a wrapper adds
#: one exactly where it launches its CUDA kernel
launch_counts = {"tmfu_multi": 0, "tmfu_multi_inplace": 0, "tmfu_single": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# -------------------------------------------------------------------- build
SOURCE = Path(__file__).resolve().parent / "csrc" / "tmfu.cu"
#: no -use_fast_math, no -ftz: denormals are kept; -fmad=false so that no
#: multiply and add is ever contracted (the source also uses the explicit
#: round-to-nearest intrinsics)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def build_dir() -> Path:
    """Where the library is built: ``$REPRO_TORCH_BUILD_DIR`` or a
    ``build/`` directory beside this module (git-ignored)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent / "build"


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME and "
                       "in /usr/local/cuda): the TMFU kernel cannot be built")


def build_library(verbose: bool = False) -> Path:
    """Compile ``csrc/tmfu.cu`` if no up-to-date library exists.

    The library's name carries a hash of the source and the flags, so an
    edited source (or a changed flag) never loads a stale build.
    """
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    lib_path = out_dir / f"libtmfu_{tag}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".libtmfu_{tag}.{os.getpid()}.so"
    cmd = [_find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, lib_path)            # atomic: concurrent builds agree
    return lib_path


def load_library(verbose: bool = False):
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(verbose)))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.tmfu_multi.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
            lib.tmfu_multi.restype = i
            lib.tmfu_single.argtypes = [p, p, p, p, p, p, i, i, i, p]
            lib.tmfu_single.restype = i
            _lib = lib
    return _lib


# ------------------------------------------------------------------- checks
def _check_words(name, t, shape, device):
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, the tiles on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tiles(x, ndim):
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"tiles must be float32, bfloat16 or int32, "
                        f"got {x.dtype}")
    if x.dim() != ndim or x.shape[-2] != RF_DEPTH:
        lead = "G, " if ndim == 3 else ""
        raise ValueError(f"tiles must have shape [{lead}{RF_DEPTH}, lanes], "
                         f"got {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError("empty tile stack")
    if not x.is_contiguous():
        raise ValueError("tiles must be contiguous")


def _check_status(name, status):
    if status != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {status}")


def _imm_from_i32(imm_i32, dtype):
    """The immediates as the datapath sees them (inverse of ``_imm_to_i32``)."""
    if dtype.is_floating_point:
        return imm_i32.view(torch.float32).to(dtype)
    return imm_i32


# ------------------------------------------------------------ multi-context
def tmfu_pipeline_rf_multi_plain(op, src_a, src_b, imm_i32, ctx_ids, x):
    """Plain version of ``tmfu_pipeline_rf_multi``: gather each tile's
    instruction rows by ``ctx_ids``, then the stage-wide executor."""
    ids = ctx_ids.long()
    imm = _imm_from_i32(imm_i32, x.dtype)
    return run_stages(op[ids], src_a[ids], src_b[ids], imm[ids], x)


def _multi(op, src_a, src_b, imm_i32, ctx_ids, x, inplace: bool):
    _check_tiles(x, 3)
    n_tiles, _, tile = x.shape
    if op.dim() != 3 or op.shape[2] != IM_DEPTH:
        raise ValueError(f"op must have shape [N, S, {IM_DEPTH}], "
                         f"got {tuple(op.shape)}")
    for name, t in (("op", op), ("src_a", src_a), ("src_b", src_b),
                    ("imm_i32", imm_i32)):
        _check_words(name, t, op.shape, x.device)
    _check_words("ctx_ids", ctx_ids, (n_tiles,), x.device)
    if not x.is_cuda:
        rf = tmfu_pipeline_rf_multi_plain(op, src_a, src_b, imm_i32,
                                          ctx_ids, x)
        # in place: the caller's stack becomes the result, as on the card
        return x.copy_(rf) if inplace else rf
    lib = load_library()
    out = x if inplace else torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = lib.tmfu_multi(
            ctx_ids.data_ptr(), op.data_ptr(), src_a.data_ptr(),
            src_b.data_ptr(), imm_i32.data_ptr(), x.data_ptr(),
            out.data_ptr(), n_tiles, op.shape[1], tile,
            DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_status("tmfu_multi", status)
    launch_counts["tmfu_multi_inplace" if inplace else "tmfu_multi"] += 1
    return out


def tmfu_pipeline_rf_multi(op, src_a, src_b, imm_i32, ctx_ids, x):
    """Run a mixed-context tile batch: x [G, RF_DEPTH, T] -> [G, RF_DEPTH, T].

    op/src_a/src_b/imm_i32: stacked bank arrays [N, S, IM] int32;
    ctx_ids: [G] int32 selecting the context for each batch tile.  One
    launch, any mix of resident kernels, any G.
    """
    return _multi(op, src_a, src_b, imm_i32, ctx_ids, x, inplace=False)


def tmfu_pipeline_rf_multi_donated(op, src_a, src_b, imm_i32, ctx_ids, x):
    """``tmfu_pipeline_rf_multi`` writing the result over the tile stack.

    The [G, RF_DEPTH, T] input has exactly the output's shape and dtype,
    so the round's staging allocation is reused as its result — zero extra
    device buffers per round.  Returns ``x`` itself.  Caller contract:
    ``x`` no longer holds the inputs after this call (the serving engines
    consume each batch exactly once; see ``Overlay(donate=True)``).
    """
    return _multi(op, src_a, src_b, imm_i32, ctx_ids, x, inplace=True)


# ----------------------------------------------------------- single context
def tmfu_pipeline_rf_plain(op, src_a, src_b, imm_i32, x):
    """Plain version of ``tmfu_pipeline_rf``."""
    imm = _imm_from_i32(imm_i32, x.dtype)
    return run_stages(op[None], src_a[None], src_b[None], imm[None],
                      x[None])[0]


def tmfu_pipeline_rf(op, src_a, src_b, imm_i32, x,
                     block_batch: int = DEFAULT_BLOCK_BATCH):
    """Run the overlay pipeline: x [RF_DEPTH, B] -> final RF [RF_DEPTH, B].

    op/src_a/src_b: [S, IM_DEPTH] int32; imm_i32: int32 bit-patterns of the
    f32 immediates (or raw ints for integer datapaths).  B must be a
    multiple of ``block_batch`` — the caller's padding granule; the CUDA
    grid itself always walks the batch in blocks of 128 lanes.
    """
    _check_tiles(x, 2)
    batch = x.shape[1]
    if op.dim() != 2 or op.shape[1] != IM_DEPTH:
        raise ValueError(f"op must have shape [S, {IM_DEPTH}], "
                         f"got {tuple(op.shape)}")
    for name, t in (("op", op), ("src_a", src_a), ("src_b", src_b),
                    ("imm_i32", imm_i32)):
        _check_words(name, t, op.shape, x.device)
    if block_batch < 1 or batch % block_batch != 0:
        raise ValueError(f"batch {batch} is not a multiple of "
                         f"block_batch {block_batch}")
    if not x.is_cuda:
        return tmfu_pipeline_rf_plain(op, src_a, src_b, imm_i32, x)
    lib = load_library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = lib.tmfu_single(
            op.data_ptr(), src_a.data_ptr(), src_b.data_ptr(),
            imm_i32.data_ptr(), x.data_ptr(), out.data_ptr(), op.shape[0],
            batch, DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_status("tmfu_single", status)
    launch_counts["tmfu_single"] += 1
    return out
