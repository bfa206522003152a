#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Drives the port's serving path (``repro_torch``) on the card, end to end,
and fails (non-zero exit, nothing caught) if there is no CUDA device, if
the kernel does not build, if a launch fails or if any comparison fails.

Phases, each printing one JSON line:

1. ``env``     torch / CUDA / nvcc versions, the card and its power limit.
2. ``build``   builds ``src/repro_torch/kernels/tmfu/csrc/tmfu.cu`` with nvcc
               and loads it.
3. ``kernel_checks``  every hand-written kernel (``tmfu_multi``,
               ``tmfu_multi_inplace``, ``tmfu_single``) against its plain
               PyTorch version on the card — float32, bfloat16, int32; the
               nine benchmark contexts plus an all-opcodes context on
               special values; G in {1, 8, 2048} tiles of 128 lanes and
               batches of {128, 777 -> 1024, 32768, 65536} lanes.  Then the
               contexts of the sparse schedule — swap, chain, dense (every
               slot active), all-identity — with the nine and the
               all-opcodes context at S in {16, 1, 15, 32} and tile widths
               T in {128, 96, 300}, input rows outside each context's
               R u W poisoned (they must come back unchanged, and no other
               row may see them).  Every comparison is bit for bit, NaN by
               position.  Timings at the ``kernels`` line's shapes.
   ``kernel_timing``  float32 times (median of 30, CUDA events, launches
               queued behind a held stream; cold, each launch on its own
               copy of the input after an L2 flush, and warm, on one
               input) of the multi-context kernels over the mixed, the
               serving, the dense and the all-identity context, and of
               the single-context kernel on each context, each beside its
               bound.
   ``attn_decode``  the decode-attention kernel (``kernels/attn_decode``):
               the build of the deepseek-7b decode cell's variant, cold
               (seconds; ``-Xptxas -v``), then the kernel against its
               plain version at the cell's shape (B 32, S 2304, KH 32,
               G 1, hd 128, bfloat16) at positions 2048 and 2303 within
               ``kernel.tolerance``, which must refuse two planted faults
               (a position dropped, the logits rounded to bfloat16), one
               launch a call; ms cold (four copies of the caches in
               turn: no launch finds its rows in L2) and warm (one copy)
               beside the bound (the visible K and V rows read once at
               3.35 TB/s), and the plain version's ms.  A split shape
               (B 2, KH 2) against the plain version, one launch of each
               pass; three small batches timed at the split count
               ``splits`` picks, the memory's alone, and around them.
   ``ssm_decode``  the Mamba2 decode kernels (``kernels/ssm_decode``): the
               build, then at the zamba2 cell's batch (B 16) and the
               widths of Zamba2-7B (H 112, P 64, N 64, G 2, the norm per
               group) and mamba2-2.7b (H 80, P 64, N 128, G 1) the step
               (``ssm_step``) against ``models.ssm._step_plain`` (float32
               activations, the conv in the cache's bf16) within
               ``kernel.tolerance``, which must refuse planted
               faults (the skip term dropped, the conv bias dropped, the
               norm over the row where it is per group); ``MambaStack``
               over three layers (norm with the residual add and a site's
               output, step) against the plain versions layer by layer;
               the norm (``rms_norm``) on rows of 3584 (plus a site's
               output) and 7168 against ``layers.rms_norm``, which must
               refuse the gain or the added output dropped.  ms cold and
               warm beside the bound of the bytes each must move, the
               plain versions' ms and ``F.rms_norm``'s.
4. ``serve``   ``OverlayServer`` with bank capacities 4 and 8: nine
               kernels, four tenants, 72 requests of 32 768 lanes; ``flush``,
               ``as_completed`` and ``flush_sync`` agree bit for bit with
               each other, with ``Overlay.dispatch``, and with the plain
               executor; every request agrees with ``dfg_eval`` on the CPU
               to rtol = atol = 1e-5.  One ``Overlay.__call__`` per kernel.
               The kernels' launch counters are set to 0 before this phase
               and read after it.
5. ``fleet``   ``ShardedOverlayServer`` on the card, every replica on its own
               CUDA stream, over the same trace: 2 and 4 replicas with banks
               of 4, residency routing and work stealing, and 2 replicas
               with banks of 2 and two rounds in flight (nearly every round
               evicts); each drained by ``flush``, ``as_completed`` and
               ``flush_sync``, every request bit for bit equal to the serve
               phase's single-bank ``flush_sync`` and plain executor.  An
               elastic run feeds the trace in bursts through ``pump_once``
               with a ``PressureAutoscaler`` (1 to 4 replicas), one forced
               ``add_replica`` and one ``drain_replica`` under load: every
               ticket delivered exactly once, bit for bit.  One warm
               4-replica ``flush`` runs under ``torch.profiler``: the
               multi-context kernels must run on exactly one stream a
               replica, none the default stream, and every device operation
               a replica issues (its H2D copies above all) on its own
               stream; whether kernels of two replicas overlapped is
               reported, not required.  Counters set to 0 before, read
               after.
6. ``edge``    an ``OverlaySocketServer`` on 127.0.0.1 (an ephemeral port,
               its asyncio loop on a thread of this process) serves an
               ``OverlayGateway`` over a 2-replica fleet driven by an
               ``AutoPump`` thread; the port's ``RemoteOverlayClient``
               submits the trace and streams the results back (msgpack if
               it imports, JSON otherwise), each bit for bit equal to the
               oracles above; requests/s and the client's delivery latency.
               Every wait has its own timeout.  Counters set to 0 before,
               read after.
7. ``lm``      the LM serving path (``repro_torch.models``, ``configs``,
               ``runtime.steps``, ``launch.serve.lm_generate``, the function
               behind ``serve --arch``).  Full width, through
               ``lm_generate`` (B = 4, prompt 32, 16 tokens, seeded weights
               made on the card): deepseek-7b at full depth, mamba2-2.7b at
               full depth, phi3.5-moe-42b-a6.6b at its published widths cut
               to 2 of its 32 layers, qwen2-moe-a2.7b at full width and
               depth (60 experts, top-4, 4 shared; 14.3 B params, 57.3 GB
               of float32 weights).  Each run twice (the second timed;
               MoE: the two bit for bit), then its bfloat16 logits held
               against the port's float32 forward (``COMPUTE_DTYPE``
               float32, TF32 off) at the same positions; prefill and decode
               times and rates beside the decode step's bound, and
               ``torch.cuda.max_memory_allocated``.  Then all ten smoke
               configs on the card against the port's CPU path on the same
               ``numpy_params`` weights: forward, prefill (last logits and
               caches), one decode step on the CPU's caches, in float32
               mode (1e-4 relative) and bfloat16 mode (the reference's
               criterion), and a TF32 control.  The path launches none of
               the TMFU kernels, and the Mamba2 decode kernels in
               mamba2-2.7b's decode: counters set to 0 before the
               full-width runs, read after.
8. ``train``   the training path (``runtime/optim.py``, ``compress.py``,
               ``steps.make_train_step``, ``data/``,
               ``distributed/checkpoint.py``, ``launch/train.py``,
               ``launch/trainer_tenant.py``).  deepseek-7b at its
               published widths cut to 12 of its 30 layers (3.27 B params;
               p + g + m + v in float32 fill 52.3 GB), B = 8, S = 128, the
               reference CLI's optimizer, remat "full", updated in place,
               through ``run_training`` for 8 steps: step 0 first in
               bfloat16 and in float32 (loss within 1 %, every gradient
               leaf's cosine >= 0.99), then ms a step, tokens/s, peak
               memory, the loss and grad-norm trace beside the step's
               bounds; one step under ``torch.profiler`` and one with
               remat "dots".  The ten smoke configs' loss and gradients,
               card against the port's CPU path (float32 mode, 1e-4).  A
               ``TrainingTenant`` on a CUDA ``OverlayServer`` (bank 4)
               with the serve trace's requests between its rounds:
               params, optimizer state and losses bit-equal to a
               standalone run on the card, every request bit-equal to the
               oracles, serving p50 / p99 with and without it; the TMFU
               counters set to 0 before this drive and read after it.
               The CLI with checkpoints and a simulated failure, in a
               subprocess.
   ``mesh``    the multi-device path on a one-rank NCCL process group and a
               (data 1, model 1) ``DeviceMesh`` on the card, after the
               ``train`` phase freed its state: the same deepseek-7b cell,
               its params and optimizer state wrapped as DTensors by
               ``reshard_tree`` with no copy, 3 steps of ``run_training``
               on them; losses and grad norms bit-equal to the ``train``
               phase's first 3 steps (same seed, same batches); ms a step
               and peak memory.  Then ``torchrun --standalone
               --nproc-per-node 1 -m repro_torch.launch.train`` with
               checkpoints and a simulated failure (re-mesh, restore with
               the new placements).  Counters set to 0 before, read after.
   ``examples`` the four ``examples/*_torch.py`` on the card, each in a
               subprocess with its own timeout, each reporting its kernel
               launches on a JSON line: quickstart (overlay vs oracle error
               0), overlay_pipeline (every benchmark kernel's error 0),
               serve_batch (the LM path's rates) and train_e2e
               ``--preset 100m`` (200 steps, B 8, S 256: it must print
               ``LEARNING``; ms a step, tokens/s, peak memory).
   ``pipeline`` the microbatch ring (``runtime/pipeline.py``): deepseek-7b
               at its published widths and full depth (30 layers), five
               stages of six layers, one gloo rank a stage on the card
               (``torch.multiprocessing``; the link staged through host
               memory), M = 8 microbatches of 1 x 128 tokens; every rank's
               ``y`` bit-equal to ``pipeline_reference`` of the whole model
               run by this process; ms a slot, stage compute and link ms,
               bytes a hop, peak memory a rank, ``pipeline_ii(8, 5)``.  The
               S = 1 ring on a one-rank NCCL group (no send; the final
               all-reduce on NCCL), bit-equal to its reference.  Then
               ``examples/pipeline_lm_torch.py`` in a subprocess.
   ``dryrun``  the dry run (``launch/dryrun.py``): the estimator on the
               ``train`` phase's cell (plain tensors, and a (1, 1) mesh on
               a fake process group) held against this run's
               measurements: peak memory within 10 % of the ``train`` and
               ``mesh`` phases' ``max_memory_allocated``, FLOPs within 15 %
               of ``train_step_work``; then ``python -m
               repro_torch.launch.dryrun``, a subprocess a cell, all at
               once, for deepseek-7b x train_4k and x prefill_32k,
               qwen2-moe-a2.7b x decode_32k and x train_4k, and
               mamba2-2.7b x train_4k and x decode_32k on the single-pod
               (16, 16) mesh: records without ``error``; each train_4k
               cell's analytic / traced FLOPs a device inside the
               reference's own (0.6, 1.7) and its arguments within 1 % of
               the sharding rule's layout; mamba2-2.7b x train_4k's wire
               bytes a device at most 1.5x the reference's record; the
               roofline terms, wire bytes, temp, bottleneck, useful-FLOPs
               ratio and collectives, beside the reference's record.
               Then ``mamba_heads``: mamba2-2.7b at its published widths,
               depth CUT to 2 of 64 layers, float32, B 4 x S 256, on four
               gloo ranks of the host CPU as a (data 2, model 2) mesh:
               loss and gradients against the plain step (1e-5 / 1e-4),
               each rank's exchanges of head columns against the count
               from the shapes.
               Both paths launch no TMFU kernel: counters set to 0 before,
               read after.
9. ``context_switch``  ``Overlay.time_context_switch`` for the nine
               benchmark kernels on the card (median of 20, µs) beside
               ``time_recompile`` (a fresh ``torch.compile``: dynamo,
               inductor, a Triton kernel) for two of them: the paper's
               context switch against rebuilding the spatial design.
10. ``kernels`` one line with every kernel's launches (summed over the
               serve, fleet, edge, lm, train, mesh, examples, pipeline and
               dryrun paths, and by path; the Mamba2 decode kernels' of
               the lm path),
               error, time, plain time and bound; the card's line from
               nvidia-smi; and the verdict as the last line.

``--profile`` adds one warm ``flush`` under ``torch.profiler`` (device time
by kernel name, the device's idle share of the drain) before step 10.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from importlib import metadata
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
#: the serving phase's backlog: requests, lanes a request, tenants
N_REQUESTS, LANES, N_TENANTS = 72, 32768, 4
TILE = 128
S_MAX = 16
RF = 32
#: published peaks of one H100 SXM: device memory rate, and float32 outside
#: the tensor cores (also taken for the bfloat16 and int32 lanes, which run
#: on the same units)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
KERNEL_SOURCE = "src/repro_torch/kernels/tmfu/csrc/tmfu.cu"
DTYPES = (("float32", torch.float32), ("bfloat16", torch.bfloat16),
          ("int32", torch.int32))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------- all opcodes, special values
# (a copy of tests/torch_port_support.py: this script imports nothing from
# tests/)
N_OPS = 18
(BYP, ADD, SUB, MUL, ADDC, SUBC, RSUBC, MULC, SQR, MAX, MIN, ABS, NEG,
 AND, OR, XOR, OUT, NOP) = range(N_OPS)
FLOAT_SPECIALS = (0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 3e38, -3e38,
                  2.5, -7.25, 0.5)
INT_SPECIALS = (0, -1, 1, -2**31, 2**31 - 1, 46341, -46341, 65536, 12345,
                -7, 2, -2**30)
FLOAT_IMMS = (0.5, -1.25, 3.0, -0.0, 2.0)
INT_IMMS = (3, -5, 7, 0, 65537)


def all_opcodes_context(kind: str, s_max: int = S_MAX) -> dict:
    """One context using all 18 opcodes; AND/OR/XOR only on the inputs, their
    results only forwarded (see tests/torch_port_support.py)."""
    imms = FLOAT_IMMS if kind == "float" else INT_IMMS
    op = np.full((s_max, RF), BYP, np.int32)
    a = np.tile(np.arange(RF, dtype=np.int32), (s_max, 1))
    b = a.copy()
    imm = np.zeros((s_max, RF), np.float64)
    tail = (MAX, MIN, MAX, MIN, SUB, MUL, ADD, RSUBC, ABS, NEG, SQR, MULC,
            SUBC, ADDC)
    for i in range(RF):
        if i < N_OPS:
            op[0, i], a[0, i], b[0, i] = i, 2 * (i % 8), 2 * (i % 8) + 1
        else:
            k = i - N_OPS
            op[0, i], a[0, i], b[0, i] = tail[k], 2 * (k % 8) + 1, 2 * (k % 8)
        imm[0, i] = imms[i % len(imms)]
    arith = [i for i in range(RF) if op[0, i] not in (AND, OR, XOR)]
    cycle = (ADD, SUB, MUL, MAX, MIN, ABS, NEG, ADDC, MULC, RSUBC, SUBC, SQR)
    for n, i in enumerate(arith):
        op[1, i] = cycle[n % len(cycle)]
        a[1, i] = i
        b[1, i] = arith[(n + 5) % len(arith)]
        imm[1, i] = imms[(i + 2) % len(imms)]
    op[2, 0::2] = OUT
    op[2, 31] = NOP
    return {"op": op, "src_a": a, "src_b": b, "imm": imm}


def _identity(s_max: int):
    op = np.full((s_max, RF), BYP, np.int32)
    a = np.tile(np.arange(RF, dtype=np.int32), (s_max, 1))
    return op, a, a.copy(), np.zeros((s_max, RF), np.float64)


def identity_context(kind: str, s_max: int = S_MAX) -> dict:
    """Every slot passes its own row on (BYP, and OUT in the last stage)."""
    op, a, b, imm = _identity(s_max)
    op[-1, 1::2] = OUT
    return {"op": op, "src_a": a, "src_b": b, "imm": imm}


def swap_context(kind: str, s_max: int = S_MAX) -> dict:
    """Stage 0 swaps rows 3 and 7 and computes rows 5 and 9 from each other."""
    op, a, b, imm = _identity(s_max)
    op[0, 3], a[0, 3] = BYP, 7
    op[0, 7], a[0, 7] = OUT, 3
    op[0, 5], a[0, 5], b[0, 5] = ADD, 9, 5
    op[0, 9], a[0, 9], b[0, 9] = SUB, 5, 9
    return {"op": op, "src_a": a, "src_b": b, "imm": imm}


def chain_context(kind: str, s_max: int = S_MAX) -> dict:
    """Stage s writes row 1 + s % 3 from the row stage s - 1 wrote."""
    imms = FLOAT_IMMS if kind == "float" else INT_IMMS
    op, a, b, imm = _identity(s_max)
    cycle = (ADDC, MUL, SUB, MULC, ADD, RSUBC)
    prev = 0
    for s in range(s_max):
        dst = 1 + s % 3
        op[s, dst], a[s, dst], b[s, dst] = cycle[s % len(cycle)], prev, 0
        imm[s, dst] = imms[s % len(imms)]
        prev = dst
    return {"op": op, "src_a": a, "src_b": b, "imm": imm}


def dense_context(kind: str, s_max: int = S_MAX, seed: int = SEED) -> dict:
    """Every slot active, opcodes over all 18, from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    imms = FLOAT_IMMS if kind == "float" else INT_IMMS
    op = rng.randint(0, N_OPS, size=(s_max, RF)).astype(np.int32)
    a = rng.randint(0, RF, size=(s_max, RF)).astype(np.int32)
    b = rng.randint(0, RF, size=(s_max, RF)).astype(np.int32)
    own = ((op == BYP) | (op == OUT)) & (a == np.arange(RF))
    a[own] = (a[own] + 1) % RF
    imm = np.asarray(imms, np.float64)[rng.randint(0, len(imms),
                                                   size=(s_max, RF))]
    return {"op": op, "src_a": a, "src_b": b, "imm": imm}


SPECIAL_CONTEXTS = {"all_opcodes": all_opcodes_context,
                    "swap": swap_context, "chain": chain_context,
                    "dense": dense_context, "identity": identity_context}


def special_lanes(kind: str, n_lanes: int = 256, seed: int = 0) -> np.ndarray:
    """[32, n_lanes]: even rows special ``l % n``, odd rows ``(l // n) % n``."""
    specials = FLOAT_SPECIALS if kind == "float" else INT_SPECIALS
    dtype = np.float32 if kind == "float" else np.int32
    n = len(specials)
    vals = np.asarray(specials, dtype=np.float64 if kind == "float"
                      else np.int64).astype(dtype)
    lanes = np.arange(n_lanes)
    x = np.empty((RF, n_lanes), dtype)
    x[0::2] = vals[lanes % n]
    x[1::2] = vals[(lanes // n) % n]
    rng = np.random.RandomState(seed)
    extra = n_lanes - n * n
    if extra > 0:
        if kind == "float":
            x[:, n * n:] = rng.uniform(-4, 4, (RF, extra)).astype(dtype)
        else:
            x[:, n * n:] = rng.randint(-2**31, 2**31 - 1, (RF, extra),
                                       dtype=np.int64).astype(dtype)
    return x


# ------------------------------------------------------------- comparisons
def compare_bits(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Equal bit patterns, NaN by position; returns the largest absolute
    difference over the lanes where both are numbers (0.0 when equal)."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.numel() == 0:
        return 0.0
    it = {4: torch.int32, 2: torch.int16}[got.element_size()]
    if got.dtype.is_floating_point:
        gn, wn = torch.isnan(got), torch.isnan(want)
        if not torch.equal(gn, wn):
            raise AssertionError(f"{what}: NaN positions differ "
                                 f"({int((gn != wn).sum())} lanes)")
        same = (got.view(it) == want.view(it)) | gn
        diff = torch.where(same, torch.zeros((), device=got.device),
                           (got.float() - want.float()).abs())
        err = float(torch.nan_to_num(diff, nan=float("inf")).max())
    else:
        same = got == want
        err = float((got.double() - want.double()).abs().max())
    if not bool(same.all()):
        raise AssertionError(f"{what}: {int((~same).sum())} of "
                             f"{same.numel()} values differ, max |err| {err}")
    return err


#: clock cycles the stream is held before a timed run (about 10 ms on an
#: H100), so that every launch is queued before the device reaches it
HOLD_CYCLES = 20_000_000
#: bytes written to a scratch buffer before a cold timing: five times the
#: H100's 50 MB L2, so that no launch finds its inputs there
FLUSH_BYTES = 256 << 20


def median_ms(fn, n: int, warmup: int = 3) -> float:
    """Median over the calls ``fn(i)``, ``i = 0 .. n-1``, each between two
    CUDA events.  A spin kernel (``torch.cuda._sleep``) first holds the
    stream, so all ``n`` calls are queued before the device reaches them
    and each pair of events brackets the kernel on the device: timed one
    by one, a kernel shorter than its Python wrapper is timed at the
    wrapper's pace.  A call that waits on the device (the plain versions
    do, in ``torch.unique(...).tolist()``) is timed at the host's pace
    all the same."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(HOLD_CYCLES)
    for i, (t0, t1) in enumerate(pairs):
        t0.record()
        fn(i)
        t1.record()
    torch.cuda.synchronize()
    return statistics.median(t0.elapsed_time(t1) for t0, t1 in pairs)


def cold_warm_ms(call, x, n: int = 30) -> tuple[float, float]:
    """Medians of ``n`` launches ``call(x')``: (cold, warm).  Cold: each
    launch on its own copy of ``x``, with L2 flushed after the copies are
    made, so that every launch reads its tile stack from device memory, as
    a serving round does (its stack has just come from the host).  Warm:
    every launch on ``x``, whose rows stay in the 50 MB L2 between
    launches."""
    warm = median_ms(lambda i: call(x), n)
    copies = [x.clone() for _ in range(n)]
    torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=x.device).zero_()
    cold = median_ms(lambda i: call(copies[i]), n, warmup=0)
    return cold, warm


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def multi_bounds(bank, ids, T: int, itemsize: int):
    """Bounds of one multi-context launch over ``ids``, from the rows each
    tile's context needs (``context_footprint``: R, the rows it reads
    before writing them; W, the rows it writes).  Out of place (K2): the
    row chunks of R or outside W in (a row of W outside R is overwritten
    before anything reads it) and all 32 out.  In place (K3): R in and W
    out.  Both count the ids, the contexts used and the active
    lane-operations."""
    from repro_torch.kernels.tmfu import kernel as tk
    active, R, W = tk.context_footprint(*bank[:3])
    idl = ids.long()
    G, S = ids.numel(), bank[0].shape[1]
    fixed = 4 * G + len(torch.unique(ids)) * 4 * S * RF * 4
    ops = int(active.sum((1, 2))[idl].sum()) * T
    rows_in = int((R | ~W).sum(1)[idl].sum())
    rows = int((R.sum(1) + W.sum(1))[idl].sum())
    return (bound((rows_in + G * RF) * T * itemsize + fixed, ops),
            bound(rows * T * itemsize + fixed, ops))


def single_bound(ctx, B: int, itemsize: int):
    """Bound of one single-context launch: the rows of R or outside W in,
    all 32 out, and the context."""
    from repro_torch.kernels.tmfu import kernel as tk
    active, R, W = tk.context_footprint(*ctx[:3])
    rows_in = int((R | ~W).sum())
    return bound((rows_in + RF) * B * itemsize + 4 * ctx[0].numel() * 4,
                 int(active.sum()) * B)


# ------------------------------------------------------------------ phases
def phase_env(device) -> str:
    from repro_torch.kernels import _nvcc
    nvcc = subprocess.run([_nvcc.find_nvcc("the kernels"), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    try:
        triton = metadata.version("triton")
    except metadata.PackageNotFoundError:
        triton = None
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc[-2] if len(nvcc) > 1 else nvcc[-1],
          "triton": triton, "ninja": shutil.which("ninja"),
          "device": torch.cuda.get_device_name(device),
          "nvidia_smi": smi[0]})
    return smi[0]


def phase_build() -> None:
    from repro_torch.kernels.tmfu import kernel as tk
    t0 = time.perf_counter()
    path = tk.build_library(verbose=True)
    tk.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(path.relative_to(ROOT)) if path.is_relative_to(ROOT)
          else str(path), "flags": " ".join(tk.NVCC_FLAGS)})


def context_fields(kernels, name, dtype, s_max=S_MAX):
    """One context as host arrays ``(op, src_a, src_b, imm)``: a benchmark
    kernel's program or one of ``SPECIAL_CONTEXTS``, ``imm`` rounded to
    ``dtype`` and held in its host type."""
    from repro_torch.core import vm
    if name in SPECIAL_CONTEXTS:
        c = SPECIAL_CONTEXTS[name]("int" if dtype == torch.int32 else "float",
                                   s_max)
        imm = vm.to_host(torch.from_numpy(c["imm"]).to(dtype))
        return c["op"], c["src_a"], c["src_b"], imm.astype(vm.host_dtype(dtype))
    h = vm.host_context(kernels[name].program, s_max, dtype)
    return h.op, h.src_a, h.src_b, h.imm


def stacked_bank(kernels, ctx_names, dtype, device, s_max=S_MAX):
    """The contexts ``ctx_names`` as one bank's stacked tensors
    ``(op, src_a, src_b, imm_i32)`` of shape [N, s_max, 32]."""
    from repro_torch.kernels.tmfu.ops import _imm_to_i32
    fields = [context_fields(kernels, n, dtype, s_max) for n in ctx_names]
    op, a, b = (torch.from_numpy(np.stack([f[i] for f in fields])).to(device)
                for i in range(3))
    imm = torch.from_numpy(np.stack([f[3] for f in fields])).to(device).to(dtype)
    return op, a, b, _imm_to_i32(imm).contiguous()


def tiles_for(ids, dtype, device, rng, special_id=None, T=TILE):
    """[G, 32, T] tiles for the context ids ``ids`` (numpy): uniform(-2, 2),
    or for int32 small values in even tiles and full-range words in odd
    ones; tiles of context ``special_id`` carry the special values."""
    kind = "int" if dtype == torch.int32 else "float"
    G = len(ids)
    if kind == "int":
        x = rng.randint(-6, 7, size=(G, RF, T)).astype(np.int32)
        wide = rng.randint(-2**31, 2**31 - 1, size=(G, RF, T),
                           dtype=np.int64).astype(np.int32)
        x[1::2] = wide[1::2]
    else:
        x = rng.uniform(-2, 2, (G, RF, T)).astype(np.float32)
    if special_id is not None:
        sp = special_lanes(kind, 2 * T)
        for j, g in enumerate(np.nonzero(ids == special_id)[0]):
            x[g] = sp[:, (j % 2) * T:(j % 2 + 1) * T]
    return torch.from_numpy(x).to(device).to(dtype)


def tile_stack(n_ctx, G, dtype, device, rng, special=True):
    """[G, 32, 128] tiles and their context ids: tile g runs context
    ``g % n_ctx``; with ``special``, tiles of the last (all-opcodes)
    context carry the special values."""
    ids = (np.arange(G) % n_ctx).astype(np.int32)
    x = tiles_for(ids, dtype, device, rng, n_ctx - 1 if special else None)
    return torch.from_numpy(ids).to(device), x


#: the word written into input rows a context neither reads nor writes: a
#: NaN with a payload no arithmetic makes (int32: the same word)
POISON = {torch.float32: (torch.int32, 0x7FA5A5A5),
          torch.bfloat16: (torch.int16, 0x7FA5),
          torch.int32: (torch.int32, 0x7FA5A5A5)}


def poisoned(x, rows):
    """A copy of ``x`` with the rows ``rows`` (bool, ``x``'s leading
    shape) set to the poison word."""
    bits, word = POISON[x.dtype]
    out = x.clone()
    out.view(bits)[rows] = word
    return out


def check_untouched(got, x, what):
    bits = POISON[got.dtype][0]
    if not torch.equal(got.view(bits), x.view(bits)):
        raise AssertionError(f"{what}: a row the context does not write "
                             "differs from the input")


def check_multi_footprint(bank, ids, x, what, record):
    """Both multi-context entry points on ``x`` with its rows outside R u W
    poisoned: rows of W equal the plain result on the clean ``x``, every
    other row comes back as the poisoned input, bit for bit."""
    from repro_torch.kernels.tmfu import kernel as tk
    _, R, W = tk.context_footprint(*bank[:3])
    idl = ids.long()
    written = W[idl]
    xp = poisoned(x, ~(R | W)[idl])
    want = tk.tmfu_pipeline_rf_multi_plain(*bank, ids, x)
    for name in ("tmfu_multi", "tmfu_multi_inplace"):
        xin = xp.clone()
        if name == "tmfu_multi":
            got = tk.tmfu_pipeline_rf_multi(*bank, ids, xin)
        else:
            got = tk.tmfu_pipeline_rf_multi_donated(*bank, ids, xin)
            assert got is xin, "the in-place kernel must return its input"
        torch.cuda.synchronize()
        record(name, compare_bits(got[written], want[written],
                                  f"{name}/{what}"))
        check_untouched(got[~written], xp[~written], f"{name}/{what}")


def check_single_footprint(ctx, x, what, record):
    """``tmfu_single`` on ``x`` with its rows outside R u W poisoned."""
    from repro_torch.kernels.tmfu import kernel as tk
    _, R, W = tk.context_footprint(*ctx[:3])
    xp = poisoned(x, ~(R | W))
    want = tk.tmfu_pipeline_rf_plain(*ctx, x)
    got = tk.tmfu_pipeline_rf(*ctx, xp, block_batch=x.shape[1])
    torch.cuda.synchronize()
    record("tmfu_single", compare_bits(got[W], want[W],
                                       f"tmfu_single/{what}"))
    check_untouched(got[~W], xp[~W], f"tmfu_single/{what}")


def footprint_checks(kernels, names, dtype, dname, device, rng, record):
    """The contexts that exercise the sparse schedule — swap, chain, dense,
    all-identity — beside the nine and the all-opcodes context, at
    S in {16, 1, 15, 32} and tile widths T in {128, 96, 300}, with the rows
    outside each context's R u W poisoned: both multi-context entry points
    on 4 tiles a context, the single-context one on each context."""
    every = list(names) + list(SPECIAL_CONTEXTS)
    cases = [(S_MAX, T, every) for T in (TILE, 96, 300)]
    cases += [(1, T, ["swap", "chain", "dense", "identity"])
              for T in (TILE, 300)]
    cases += [(S, T, every) for S in (15, 32) for T in (TILE, 300)]
    for S, T, ctx_names in cases:
        bank = stacked_bank(kernels, ctx_names, dtype, device, S)
        sid = (ctx_names.index("all_opcodes") if "all_opcodes" in ctx_names
               else None)
        ids = (np.arange(4 * len(ctx_names)) % len(ctx_names)).astype(np.int32)
        x = tiles_for(ids, dtype, device, rng, sid, T)
        what = f"{dname}/S={S}/T={T}"
        check_multi_footprint(bank, torch.from_numpy(ids).to(device), x,
                              what, record)
        for k, n in enumerate(ctx_names):
            ctx = tuple(t[k].contiguous() for t in bank)
            for B in ((T, 32768) if (S, T) == (S_MAX, TILE) else (T,)):
                xb = tiles_for(np.zeros(1), dtype, device, rng,
                               0 if k == sid else None, B)[0]
                check_single_footprint(ctx, xb, f"{what}/{n}/B={B}", record)


def phase_kernels(kernels, names, device) -> dict:
    """Hold every kernel against its plain version; time it.  Returns the
    per-kernel records (without the serving path's launch counts)."""
    from repro_torch.core import vm
    from repro_torch.kernels.tmfu import kernel as tk
    from repro_torch.kernels.tmfu import ops as tops
    rng = np.random.RandomState(SEED)
    err = {"tmfu_multi": 0.0, "tmfu_multi_inplace": 0.0, "tmfu_single": 0.0}
    n_cmp = dict.fromkeys(err, 0)

    def record(name, e):
        err[name] = max(err[name], e)
        n_cmp[name] += 1

    timing = {}
    for dname, dtype in DTYPES:
        bank = stacked_bank(kernels, list(names) + ["all_opcodes"], dtype,
                            device)
        n_ctx = bank[0].shape[0]
        itemsize = torch.empty((), dtype=dtype).element_size()
        # ---- multi and in-place multi
        for G in (1, 8, 2048):
            ids, x = tile_stack(n_ctx, G, dtype, device, rng)
            want = tk.tmfu_pipeline_rf_multi_plain(*bank, ids, x)
            got = tk.tmfu_pipeline_rf_multi(*bank, ids, x)
            torch.cuda.synchronize()
            record("tmfu_multi", compare_bits(got, want,
                                              f"tmfu_multi/{dname}/G={G}"))
            x2 = x.clone()
            got2 = tk.tmfu_pipeline_rf_multi_donated(*bank, ids, x2)
            torch.cuda.synchronize()
            assert got2 is x2, "the in-place kernel must return its input"
            record("tmfu_multi_inplace",
                   compare_bits(got2, want, f"tmfu_multi_inplace/{dname}/G={G}"))
            if G == 2048:
                full, sparse = multi_bounds(bank, ids, TILE, itemsize)
                ms = cold_warm_ms(lambda xi: tk.tmfu_pipeline_rf_multi(
                    *bank, ids, xi), x)
                ms_in = cold_warm_ms(
                    lambda xi: tk.tmfu_pipeline_rf_multi_donated(
                        *bank, ids, xi), x2)
                plain = median_ms(lambda i: tk.tmfu_pipeline_rf_multi_plain(
                    *bank, ids, x), 5, warmup=1)
                timing[("tmfu_multi", dname)] = (*ms, plain, *full)
                timing[("tmfu_multi_inplace", dname)] = (*ms_in, plain,
                                                         *sparse)
        # ---- single context: every context at every batch
        for B in (128, 1024, 32768, 65536):
            for k in range(n_ctx):
                ctx = tuple(t[k].contiguous() for t in bank)
                if k == n_ctx - 1:
                    kind = "int" if dtype == torch.int32 else "float"
                    xb = np.tile(special_lanes(kind, 256), (1, B // 256 + 1))
                    xb = torch.from_numpy(xb[:, :B].copy()).to(device).to(dtype)
                else:
                    xb = tile_stack(n_ctx, B // TILE, dtype, device, rng)[1]
                    xb = xb.movedim(1, 0).reshape(RF, B).contiguous()
                want = tk.tmfu_pipeline_rf_plain(*ctx, xb)
                got = tk.tmfu_pipeline_rf(*ctx, xb,
                                          block_batch=min(512, B))
                torch.cuda.synchronize()
                record("tmfu_single", compare_bits(
                    got, want, f"tmfu_single/{dname}/B={B}/ctx={k}"))
                if B == 32768 and k == 0:
                    ms = cold_warm_ms(lambda xi: tk.tmfu_pipeline_rf(
                        *ctx, xi, block_batch=512), xb)
                    plain = median_ms(lambda i: tk.tmfu_pipeline_rf_plain(
                        *ctx, xb), 5, warmup=1)
                    timing[("tmfu_single", dname)] = (
                        *ms, plain, *single_bound(ctx, B, itemsize))
        # ---- the public wrapper's pad / out_idx / trim at a ragged batch
        for n in names:
            ctx = vm.make_context(kernels[n].program, S_MAX, dtype, device)
            xr = tile_stack(1, 7, dtype, device, rng, special=False)[1]
            xr = xr.movedim(1, 0).reshape(RF, 7 * TILE)[:, :777].contiguous()
            want = vm.vm_exec(ctx.tree(), ctx.out_idx, xr)
            got = tops.tmfu_pipeline(ctx, xr)
            torch.cuda.synchronize()
            record("tmfu_single", compare_bits(
                got, want, f"tmfu_pipeline/{dname}/{n}/B=777"))
        # ---- the sparse schedule's own cases
        footprint_checks(kernels, names, dtype, dname, device, rng, record)
    replaces = {"tmfu_multi": "src/repro/kernels/tmfu/kernel.py:169",
                "tmfu_multi_inplace": "src/repro/kernels/tmfu/kernel.py:202",
                "tmfu_single": "src/repro/kernels/tmfu/kernel.py:234"}
    shapes = {"tmfu_multi": "G=2048 T=128 S=16",
              "tmfu_multi_inplace": "G=2048 T=128 S=16",
              "tmfu_single": "B=32768 S=16"}
    counts = {"tmfu_multi": "per tile |R or not W| row chunks of T lanes "
                            "in, 32 out (context_footprint), ids, contexts "
                            "used",
              "tmfu_multi_inplace": "per tile |R|+|W| row chunks of T lanes "
                                    "(context_footprint), ids, contexts used",
              "tmfu_single": "|R or not W| rows in, 32 out "
                             "(context_footprint), the context"}
    records = {}
    for name in err:
        ms, warm, plain, b_ms, b_by = timing[(name, "float32")]
        records[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces[name], "launches": None,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": shapes[name] + " float32", "bound_counts": counts[name],
            "timing": "median of 30 queued launches, each on its own copy "
                      "of the input, L2 flushed first (cold); warm_ms: "
                      "every launch on one input",
            "warm_ms": warm, "comparisons": n_cmp[name],
            "tolerance": "bit-exact, NaN by position "
                         "(float32, bfloat16, int32)",
            "other_dtypes_ms": {d: timing[(name, d)][0]
                                for d in ("bfloat16", "int32")}}
    emit({"phase": "kernel_checks",
          "compared": n_cmp, "max_abs_err": err,
          "ms_cold_warm": {f"{k}/{d}": v[:2] for (k, d), v in timing.items()}})
    return records


def phase_timing(kernels, names, device) -> None:
    """float32 kernel times at G = 2048, T = 128, S = 16 over four context
    mixes — ``mixed`` (tile g runs context g % 10: the nine and the
    all-opcodes context, the ``kernels`` line's shape), ``serving`` (the
    nine only), ``dense`` and ``identity`` — and the single-context kernel
    at B = 32768 on each of the nine and the dense context; each beside
    its bound."""
    from repro_torch.kernels.tmfu import kernel as tk
    rng = np.random.RandomState(SEED + 2)
    every = list(names) + list(SPECIAL_CONTEXTS)
    bank = stacked_bank(kernels, every, torch.float32, device)
    sid, G = every.index("all_opcodes"), 2048
    mixes = {"mixed": np.arange(G) % 10, "serving": np.arange(G) % 9,
             "dense": np.full(G, every.index("dense")),
             "identity": np.full(G, every.index("identity"))}
    rows = []
    for mix, ids_np in mixes.items():
        ids_np = ids_np.astype(np.int32)
        ids = torch.from_numpy(ids_np).to(device)
        x = tiles_for(ids_np, torch.float32, device, rng, sid)
        full, sparse = multi_bounds(bank, ids, TILE, 4)
        for name, fn, (b_ms, b_by) in (
                ("tmfu_multi", lambda xi: tk.tmfu_pipeline_rf_multi(
                    *bank, ids, xi), full),
                ("tmfu_multi_inplace",
                 lambda xi: tk.tmfu_pipeline_rf_multi_donated(
                     *bank, ids, xi), sparse)):
            cold, warm = cold_warm_ms(fn, x.clone())
            rows.append({"kernel": name, "mix": mix, "ms": cold,
                         "warm_ms": warm, "bound_ms": b_ms, "bound_by": b_by})
    for n in list(names) + ["dense"]:
        ctx = tuple(t[every.index(n)].contiguous() for t in bank)
        xb = tiles_for(np.zeros(1), torch.float32, device, rng, None, 32768)[0]
        b_ms, b_by = single_bound(ctx, 32768, 4)
        cold, warm = cold_warm_ms(lambda xi: tk.tmfu_pipeline_rf(
            *ctx, xi, block_batch=512), xb)
        rows.append({"kernel": "tmfu_single", "mix": n, "ms": cold,
                     "warm_ms": warm, "bound_ms": b_ms, "bound_by": b_by})
    emit({"phase": "kernel_timing",
          "shape": "float32; multi G=2048 T=128 S=16; single B=32768 S=16",
          "timing": "median of 30 launches between CUDA events, launches "
                    "queued behind a held stream; ms: each launch on its "
                    "own copy of the input, L2 flushed first (cold); "
                    "warm_ms: every launch on one input",
          "rows": rows})


#: the deepseek-7b decode cell's attention: B, S, KH, G, hd and the first
#: and last positions a generation writes
ATTN_CELL = (32, 2304, 32, 1, 128)
ATTN_POSITIONS = (2048, 2303)
#: (B, S, KH, G, hd) at pos S - 1 held to the plain version through the
#: split kernels
ATTN_SPLIT = (2, 2304, 2, 1, 128)
#: small batches, where B x KH blocks cannot fill the card: timed at each
#: split count around the one ``splits`` picks
ATTN_SPLIT_TIMING = ((4, 2304, 8, 1, 128), (1, 4096, 8, 4, 128),
                     (8, 2304, 8, 4, 128))


def planted(q, ck, cv, pos, fault):
    """``attn_decode_plain`` at ``pos`` < S, no window, with one planted
    error: ``drop`` leaves out position 0, ``logits_bf16`` rounds the
    logits to bfloat16."""
    lo = 1 if fault == "drop" else 0
    k, v = ck[:, lo:pos + 1], cv[:, lo:pos + 1]
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    if fault == "logits_bf16":
        logits = logits.bfloat16().float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def atol_needed(got, want) -> float:
    """The atol, over max|want|, that ``got`` needs beside rtol 2^-7."""
    d = (got.float() - want.float()).abs() - 2 ** -7 * want.float().abs()
    return float(d.max()) / float(want.float().abs().max())


def phase_attn_decode(device) -> None:
    """The decode-attention kernel: its cold build; at the decode cell's
    shape its error against the plain version beside the tolerance and
    beside planted faults that the tolerance must refuse, its times
    beside its bound and the plain version's; a split shape held to the
    plain version; small batches timed at several split counts."""
    from repro_torch.kernels.attn_decode import kernel as adk
    B, S, KH, G, hd = ATTN_CELL
    t0 = time.perf_counter()
    adk.build_library(hd, torch.bfloat16, 1, verbose=True)
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device).manual_seed(SEED)

    def tensors(B, S, KH, G, hd, copies):
        q = torch.randn(B, 1, KH, G, hd, generator=gen, device=device,
                        dtype=torch.bfloat16)
        return q, [[torch.randn(B, S, KH, hd, generator=gen, device=device,
                                dtype=torch.bfloat16) for _ in range(2)]
                   for _ in range(copies)]

    q, copies = tensors(B, S, KH, G, hd, 4)
    ck, cv = copies[0]
    rows = []
    for pos in ATTN_POSITIONS:
        adk.reset_launch_counts()
        got = adk.attn_decode(q, ck, cv, pos)
        torch.cuda.synchronize()
        assert adk.launch_counts["attn_decode"] == 1, adk.launch_counts
        want = adk.attn_decode_plain(q, ck, cv, pos)
        tol = adk.tolerance(want)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        faults = {}
        for fault in ("drop", "logits_bf16"):
            wrong = planted(q, ck, cv, pos, fault)
            try:
                torch.testing.assert_close(wrong.float(), want.float(), **tol)
            except AssertionError:
                faults[fault] = atol_needed(wrong, want)
            else:
                raise AssertionError(f"the tolerance takes the fault {fault}")
        err = float((got.float() - want.float()).abs().max())
        _, n = adk.visible(S, pos, None)
        n_bytes = 2 * B * n * KH * hd * 2 + 2 * q.numel() * 2
        warm = median_ms(lambda i: adk.attn_decode(q, ck, cv, pos), 30)
        cold = median_ms(lambda i: adk.attn_decode(
            q, *copies[i % len(copies)], pos), 30)
        plain = median_ms(lambda i: adk.attn_decode_plain(q, ck, cv, pos),
                          10, warmup=1)
        rows.append({"pos": pos, "positions_read": n, "max_abs_err": err,
                     "max_abs_want": float(want.float().abs().max()),
                     "atol": tol["atol"], "rtol": tol["rtol"],
                     "atol_needed": atol_needed(got, want),
                     "faults_refused_atol_needed": faults, "ms": cold,
                     "warm_ms": warm, "bound_ms": bound(n_bytes, 0)[0],
                     "bound_by": "bytes", "bytes": n_bytes,
                     "plain_ms": plain})
    del copies, ck, cv, got, want, wrong
    torch.cuda.empty_cache()

    B, S, KH, G, hd = ATTN_SPLIT
    q, ((ck, cv),) = tensors(B, S, KH, G, hd, 1)
    adk.reset_launch_counts()
    got = adk.attn_decode(q, ck, cv, S - 1)
    torch.cuda.synchronize()
    assert adk.launch_counts == {"attn_decode": 0, "attn_decode_qk": 1,
                                 "attn_decode_pv": 1}, adk.launch_counts
    want = adk.attn_decode_plain(q, ck, cv, S - 1)
    torch.testing.assert_close(got.float(), want.float(),
                               **adk.tolerance(want))
    split = {"shape": f"B={B} S={S} KH={KH} G={G} hd={hd} pos={S - 1}",
             "splits": adk.splits(B * KH, G, S, adk._sm_count(device)),
             "atol_needed": atol_needed(got, want)}

    timing = []
    rule = adk.splits
    sms = adk._sm_count(device)
    try:
        for B, S, KH, G, hd in ATTN_SPLIT_TIMING:
            q, copies = tensors(B, S, KH, G, hd, 8)
            memory = rule(sms, G, S, sms)     # the memory's split alone
            picked = rule(B * KH, G, S, sms)
            ms = {}
            for k in sorted({memory, max(memory, picked // 4),
                             max(memory, picked // 2), picked, 2 * picked}):
                k = -(-S // -(-S // k))       # no split left empty
                adk.splits = lambda *_, k=k: k
                ms[k] = median_ms(lambda i: adk.attn_decode(
                    q, *copies[i % len(copies)], S - 1), 30)
            adk.splits = rule
            timing.append({"shape": f"B={B} S={S} KH={KH} G={G} hd={hd} "
                                    f"pos={S - 1}",
                           "memory_splits": memory, "picked": picked,
                           "ms_by_splits": ms})
    finally:
        adk.splits = rule
    emit({"phase": "attn_decode", "build_s": build_s,
          "shape": f"B={ATTN_CELL[0]} S={ATTN_CELL[1]} KH={ATTN_CELL[2]} "
                   f"G={ATTN_CELL[3]} hd={ATTN_CELL[4]} bfloat16",
          "timing": "median of 30 launches between CUDA events behind a "
                    "held stream; ms: four copies of the caches in turn "
                    "(1.2 GB each: a launch finds no rows in L2); warm_ms: "
                    "one copy; plain_ms: median of 10; split timing: eight "
                    "copies in turn",
          "rows": rows, "split": split, "split_timing": timing})
    del copies, q
    torch.cuda.empty_cache()


# ------------------------------------------------------------- ssm decode
#: the zamba2 cell's decode batch, at which both mixers are held and timed
SSM_BATCH = 16
#: layers of the stack held, layer by layer, through ``MambaStack``
SSM_STACK_LAYERS = 3
#: input sets a cold timing takes in turn: each set's SSM state alone is
#: 29.4 MB (Zamba2-7B) or 41.9 MB (mamba2-2.7b), so a launch finds none
#: of its inputs in the 50 MB L2
SSM_COPIES = 8
#: input sets a cold timing of the norm takes in turn (117 MB in all)
NORM_COPIES = 512
#: rows the norm kernel is timed on: a Mamba layer's input (with the
#: residual add and a site's output) and a site's concat of its input and
#: the embedding
NORM_WIDTHS = ((3584, True), (7168, False))


def ssm_models():
    """(name, SSMDims, norm eps) of the two mixers the decode kernels
    serve: Zamba2-7B's (the zamba2 cell's) and mamba2-2.7b's (the lm
    phase's full-width run)."""
    from repro_torch.configs import get_config, zamba2_7b_instruct
    return [(name, cfg.ssm, cfg.norm_eps)
            for name, cfg in (("zamba2-7b-instruct",
                               zamba2_7b_instruct.config()),
                              ("mamba2-2.7b", get_config("mamba2-2.7b")))]


def ssm_inputs(dims, lead, device, gen):
    """A stack of ``lead`` mixers' params between the projections (the
    published init where ``dt_limits`` is set; conv bias and gains drawn
    around their init), and each layer's bf16 in-projection of one token,
    bf16 conv state and float32 SSM state at ``SSM_BATCH`` rows."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    p = S.init_mamba2(L.Init.torch(gen, device), lead, dims)
    p = {k: v for k, v in p.items() if torch.is_tensor(v)} | {
        "norm": {"g": 1 + 0.1 * torch.randn(
            p["norm"]["g"].shape, generator=gen, device=device)}}
    p["conv_b"] = 0.1 * torch.randn(p["conv_b"].shape, generator=gen,
                                    device=device)
    B, din, N, G, H = (SSM_BATCH, dims.d_inner, dims.d_state, dims.n_groups,
                       dims.n_heads)
    C = din + 2 * G * N

    def draw(*shape, dtype=torch.bfloat16):
        return torch.randn(lead + shape, generator=gen, device=device) \
            .to(dtype)
    return (p, draw(B, din + C + H), draw(B, dims.d_conv - 1, C),
            draw(B, H, N, dims.head_dim, dtype=torch.float32))


def ssm_step_bytes(p, proj, conv, ssm, y) -> int:
    """What a step must move at least: the in-projection, the params and
    both states read, the output and both new states written."""
    leaves = [v for v in p.values() if torch.is_tensor(v)] + [p["norm"]["g"]]
    return (sum(t.numel() * t.element_size() for t in [proj, *leaves])
            + 2 * (conv.numel() * conv.element_size()
                   + ssm.numel() * ssm.element_size())
            + y.numel() * y.element_size())


def atol_needed_rel(got, want, tol) -> float:
    """The atol over max|want| that ``got`` needs beside ``tol``'s rtol."""
    d = (got.float() - want.float()).abs() - tol["rtol"] * want.float().abs()
    return max(0.0, float(d.max()) / float(want.float().abs().max()))


def refused(wrong, want, tol, what) -> float:
    """The atol over max|want| that a planted fault ``wrong`` needs beside
    ``tol``'s rtol; raises if ``tol`` takes it."""
    try:
        torch.testing.assert_close(wrong.float(), want.float(), **tol)
    except AssertionError:
        return atol_needed_rel(wrong, want, tol)
    raise AssertionError(f"the tolerance takes the fault {what}")


def ssm_step_faults(p, proj, conv, ssm, dims, eps):
    """The step's plain version (float32 activations) with one planted
    error each: the
    skip term ``D x`` dropped, the conv bias dropped, and where the norm
    is taken per group, over the whole row."""
    import dataclasses
    from repro_torch.models import ssm as S
    f32 = (proj.float(), conv, ssm)
    out = {"skip_dropped": S._step_plain(
               p | {"D": torch.zeros_like(p["D"])}, *f32, dims,
               torch.float32, eps)[0],
           "conv_bias_dropped": S._step_plain(
               p | {"conv_b": torch.zeros_like(p["conv_b"])}, *f32, dims,
               torch.float32, eps)[0]}
    if dims.group_norm:
        out["norm_over_row"] = S._step_plain(
            p, *f32, dataclasses.replace(dims, group_norm=False),
            torch.float32, eps)[0]
    return out


def check_stack(dims, eps, device, gen) -> dict:
    """``MambaStack`` over ``SSM_STACK_LAYERS`` layers: each layer's norm
    (an out-projection's output added to the stream from the second
    layer on, a site's output beside it at the second) and step, held to
    the plain versions on the same inputs."""
    from repro_torch.kernels.ssm_decode import kernel as sdk
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    n = SSM_STACK_LAYERS
    p, proj, conv, ssm = ssm_inputs(dims, (n,), device, gen)
    D = dims.d_model
    ln = 1 + 0.1 * torch.randn(n, D, generator=gen, device=device)
    h = torch.randn(SSM_BATCH, 1, D, generator=gen, device=device).bfloat16()
    h0 = h.clone()
    run = sdk.MambaStack(p, ln, {"conv": conv, "ssm": ssm}, dims, eps, h)
    need = {"x": 0.0, "y": 0.0, "ssm": 0.0}

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device).bfloat16()
    for i in range(n):
        add = draw(SSM_BATCH, D) if i else None
        extra = draw(SSM_BATCH, 1, D) if i == 1 else None
        want_h = h0 if add is None else h0 + add[:, None]
        v = want_h if extra is None else want_h + extra
        want_x = L.rms_norm({"g": ln[i]}, v.float(), eps)[:, 0]
        x = run.norm(i, h, add, extra)
        torch.cuda.synchronize()
        assert torch.equal(h, want_h), f"layer {i}: the residual add"
        tol = sdk.tolerance(torch.bfloat16, want_x)
        torch.testing.assert_close(x.float(), want_x, **tol)
        need["x"] = max(need["x"], atol_needed_rel(x, want_x, tol))
        pi = {k: v[i] for k, v in p.items() if torch.is_tensor(v)} | {
            "norm": {"g": p["norm"]["g"][i]}}
        y = run.step(i, proj[i])
        torch.cuda.synchronize()
        want_y, _, want_ssm = S._step_plain(
            pi, proj[i].float(), conv[i], ssm[i], dims, torch.float32,
            eps)
        want_conv = S._step_plain(pi, proj[i], conv[i], ssm[i], dims,
                                  torch.bfloat16, eps)[1]
        tol = sdk.tolerance(torch.bfloat16, want_y)
        torch.testing.assert_close(y.float(), want_y, **tol)
        need["y"] = max(need["y"], atol_needed_rel(y, want_y, tol))
        assert torch.equal(run.conv[i], want_conv), f"layer {i}: conv state"
        tol = sdk.tolerance(torch.float32, want_ssm)
        torch.testing.assert_close(run.ssm[i], want_ssm, **tol)
        need["ssm"] = max(need["ssm"], atol_needed_rel(run.ssm[i], want_ssm,
                                                       tol))
        h0 = want_h
    return {"layers": n, "atol_needed": need}


def phase_ssm_decode(device) -> dict:
    """The Mamba2 decode kernels (``kernels/ssm_decode``): their build;
    at the zamba2 cell's batch and both mixers' widths the step
    (``ssm_step``) and the norm (``rms_norm``) against their plain
    versions within ``kernel.tolerance``, which must refuse planted
    faults, and ``MambaStack`` layer by layer; ms cold and warm beside the
    bound of the bytes each must move, the plain versions' ms, and the
    library's fused RMSNorm (``F.rms_norm``).  Returns the two kernels'
    records for the ``kernels`` line."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssm_decode import kernel as sdk
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    t0 = time.perf_counter()
    sdk.build_library(verbose=True)
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device).manual_seed(SEED)
    steps = []
    for name, dims, eps in ssm_models():
        sets = [ssm_inputs(dims, (), device, gen)
                for _ in range(SSM_COPIES)]
        p, proj, conv, ssm = sets[0]
        sdk.reset_launch_counts()
        y, conv_new, ssm_new = sdk.ssm_step(p, proj, conv, ssm, dims, eps)
        torch.cuda.synchronize()
        assert sdk.launch_counts["ssm_decode_step"] == 1, sdk.launch_counts
        want_y, _, want_ssm = S._step_plain(p, proj.float(), conv, ssm,
                                            dims, torch.float32, eps)
        tol = sdk.tolerance(torch.bfloat16, want_y)
        torch.testing.assert_close(y.float(), want_y, **tol)
        assert torch.equal(conv_new, S._step_plain(
            p, proj, conv, ssm, dims, torch.bfloat16, eps)[1])
        tol_ssm = sdk.tolerance(torch.float32, want_ssm)
        torch.testing.assert_close(ssm_new, want_ssm, **tol_ssm)
        faults = {f: refused(w, want_y, tol, f) for f, w in
                  ssm_step_faults(p, proj, conv, ssm, dims, eps).items()}
        stack = check_stack(dims, eps, device, gen)
        n_bytes = ssm_step_bytes(p, proj, conv, ssm, y)
        warm = median_ms(lambda i: sdk.ssm_step(p, proj, conv, ssm, dims,
                                                eps), 30)
        cold = median_ms(lambda i: sdk.ssm_step(
            *sets[i % SSM_COPIES], dims, eps), 30)
        plain = median_ms(lambda i: S._step_plain(
            p, proj, conv, ssm, dims, torch.bfloat16, eps), 10, warmup=1)
        steps.append({
            "model": name, "shape": f"B={SSM_BATCH} H={dims.n_heads} "
            f"P={dims.head_dim} N={dims.d_state} G={dims.n_groups} "
            f"group_norm={dims.group_norm} bf16 act and conv state",
            "atol_needed": {"y": atol_needed_rel(y, want_y, tol),
                            "ssm": atol_needed_rel(ssm_new, want_ssm,
                                                   tol_ssm)},
            "atol": tol["atol"] / float(want_y.abs().max()),
            "rtol": tol["rtol"], "faults_refused_atol_needed": faults,
            "stack": stack, "ms": cold, "warm_ms": warm,
            "bound_ms": bound(n_bytes, 0)[0], "bound_by": "bytes",
            "bytes": n_bytes, "plain_ms": plain})
        del sets, p, proj, conv, ssm
        torch.cuda.empty_cache()

    norms = []
    for D, with_adds in NORM_WIDTHS:
        def draw():
            return torch.randn(SSM_BATCH, 1, D, generator=gen,
                               device=device).bfloat16()
        g = 1 + 0.1 * torch.randn(D, generator=gen, device=device)
        sets = [(draw(), draw() if with_adds else None)
                for _ in range(NORM_COPIES)]
        x, extra = sets[0]
        got = sdk.rms_norm(x, g, 1e-5, extra)
        v = x if extra is None else x + extra
        want = L.rms_norm({"g": g}, v.float(), 1e-5)
        tol = sdk.tolerance(torch.bfloat16, want)
        torch.testing.assert_close(got.float(), want, **tol)
        faults = {"gain_dropped": refused(
            L.rms_norm({"g": torch.ones_like(g)}, v.float(), 1e-5), want,
            tol, "gain_dropped")}
        if extra is not None:
            faults["extra_dropped"] = refused(
                L.rms_norm({"g": g}, x.float(), 1e-5), want, tol,
                "extra_dropped")
        g16 = g.bfloat16()
        n_bytes = (2 + (extra is not None)) * x.numel() * 2 + g.numel() * 4
        norms.append({
            "shape": f"B={SSM_BATCH} rows of {D} bf16"
                     + (", plus a site's output" if with_adds else ""),
            "atol_needed": atol_needed_rel(got, want, tol),
            "faults_refused_atol_needed": faults,
            "ms": median_ms(lambda i: sdk.rms_norm(
                sets[-1 - i][0], g, 1e-5, sets[-1 - i][1]), 30, warmup=0),
            "warm_ms": median_ms(lambda i: sdk.rms_norm(x, g, 1e-5, extra),
                                 30),
            "bound_ms": bound(n_bytes, 0)[0], "bound_by": "bytes",
            "bytes": n_bytes,
            "plain_ms": median_ms(lambda i: L.rms_norm(
                {"g": g}, x if extra is None else x + extra, 1e-5), 30),
            "library_ms": median_ms(lambda i: F.rms_norm(
                x if extra is None else x + extra, (D,), g16, 1e-5), 30)})
    emit({"phase": "ssm_decode", "build_s": build_s,
          "timing": "median of 30 launches between CUDA events behind a "
                    "held stream; ms: input sets in turn (8 for the step, "
                    "no launch finds its state in L2; 512 for the norm); "
                    "warm_ms: one set; plain_ms: the plain version on the "
                    "card (median of 10 for the step); library_ms: "
                    "F.rms_norm, one fused call, its gain rounded to "
                    "bf16 (a float32 gain is not fused), the adds before",
          "steps": steps, "norms": norms})
    return [{"name": "ssm_decode_step", "wrapper": "ssm_step, "
             "MambaStack.step", "rows": steps},
            {"name": "rms_norm", "wrapper": "rms_norm, MambaStack.norm",
             "rows": norms}]


def make_trace(kernels, names, n_requests, lanes, n_tenants):
    rng = np.random.RandomState(SEED)
    trace = []
    for i in range(n_requests):
        k = kernels[names[i % len(names)]]
        xs = [rng.uniform(-2, 2, (lanes,)).astype(np.float32)
              for _ in k.dfg.inputs]
        trace.append((k, xs, f"tenant{i % n_tenants}"))
    return trace


def host_outputs(outs) -> list:
    """A request's outputs as numpy arrays (device tensors read back)."""
    return [u.cpu().numpy() if isinstance(u, torch.Tensor) else np.asarray(u)
            for u in outs]


def same_outputs(a, b, what):
    assert len(a) == len(b), what
    for j, (u, v) in enumerate(zip(host_outputs(a), host_outputs(b))):
        if u.tobytes() != v.tobytes():
            raise AssertionError(f"{what}: output {j} differs")


def phase_serve(kernels, names, device):
    """Drive the serving path; returns the launch counts it caused and the
    oracle of the later phases: per request of the trace, the single-bank
    ``flush_sync`` outputs and the plain executor's, as numpy arrays."""
    from repro_torch.core import vm
    from repro_torch.core.overlay import Overlay
    from repro_torch.kernels.tmfu import kernel as tk
    from repro_torch.launch.serve import OverlayServer
    from repro_torch.telemetry import check_stats
    n_requests, lanes, n_tenants = N_REQUESTS, LANES, N_TENANTS
    trace = make_trace(kernels, names, n_requests, lanes, n_tenants)

    tk.reset_launch_counts()
    reports, delivered = [], {}
    for capacity in (4, 8):
        # half the bank per round, as the demo does: the other half is free
        # for the next round's contexts, so two rounds really are in flight
        srv = OverlayServer(bank_capacity=capacity, tile=TILE,
                            round_kernels=capacity // 2,
                            quantum_tiles=1024, device=device)
        drains = {}
        for mode in ("flush", "as_completed", "flush_sync"):
            tickets = [srv.submit(k, xs, tenant=t) for k, xs, t in trace]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "flush":
                res = srv.flush()
            elif mode == "as_completed":
                res = dict(srv.as_completed())
            else:
                res = srv.flush_sync()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            assert sorted(res) == sorted(tickets), f"{mode}: lost tickets"
            drains[mode] = ([res[t] for t in tickets], dt)
        if capacity == 4:
            oracle_sync = [host_outputs(o) for o in drains["flush_sync"][0]]
        for mode in ("as_completed", "flush_sync"):
            for i in range(n_requests):
                same_outputs(drains[mode][0][i], drains["flush"][0][i],
                             f"bank={capacity} {mode} vs flush, request {i}")
        st = srv.stats()
        check_stats("engine", st)
        assert st["pending"] == 0 and st["pinned"] == 0
        assert st["arena"]["peak_outstanding"] >= 2, "rounds never overlapped"
        if capacity < len(names):
            assert st["evictions"] > 0, "a bank of 4 must evict on 9 kernels"
        dt = drains["flush"][1]
        reports.append({
            "bank_capacity": capacity, "requests": n_requests,
            "lanes_per_request": lanes, "tenants": n_tenants,
            "flush_s": dt, "requests_per_s": n_requests / dt,
            "lanes_per_s": n_requests * lanes / dt,
            "as_completed_s": drains["as_completed"][1],
            "flush_sync_s": drains["flush_sync"][1],
            "round_kernels": srv.round_kernels,
            "rounds": st["rounds"], "loads": st["loads"],
            "evictions": st["evictions"], "hits": st["hits"],
            "stage_walls": st["stage_walls"],
            "arena": st["arena"]})
        delivered[capacity] = drains["flush"][0]
    for i in range(n_requests):
        same_outputs(delivered[4][i], delivered[8][i],
                     f"bank=4 vs bank=8, request {i}")

    # the synchronous oracle: one plain Overlay, one bank of nine, dispatch
    ov = Overlay(device=device)
    bank = ov.load_many(kernels.values(), capacity=len(names))
    half = n_requests // 2
    outs = (ov.dispatch(bank, [(k, xs) for k, xs, _ in trace[:half]])
            + ov.dispatch(bank, [(k, xs) for k, xs, _ in trace[half:]]))
    torch.cuda.synchronize()
    for i in range(n_requests):
        same_outputs(outs[i], delivered[4][i], f"dispatch vs flush, request {i}")

    # one Overlay.__call__ per kernel (the single-context kernel)
    call_outs = {}
    for n in names:
        k, xs, _ = trace[names.index(n)]
        call_outs[n] = ov(ov.load(k), xs)
    torch.cuda.synchronize()
    counts = dict(tk.launch_counts)          # read right behind the main path

    # every request: the DFG oracle on the CPU, the plain executor bit for bit
    oracle_plain = []
    for i, (k, xs, _) in enumerate(trace):
        ref = vm.dfg_eval(k.dfg, {n: torch.from_numpy(v)
                                  for n, v in zip(k.dfg.inputs, xs)})
        ctx = ov.load(k)
        plain = vm.vm_exec(ctx.tree(), ctx.out_idx,
                           vm.pad_inputs([torch.from_numpy(v) for v in xs],
                                         device=device))
        got = delivered[4][i]
        assert len(got) == len(k.dfg.outputs)
        for j, o in enumerate(k.dfg.outputs):
            assert got[j].shape == (lanes,) and got[j].dtype == np.float32
            assert np.isfinite(got[j]).all(), f"request {i}: not finite"
            np.testing.assert_allclose(got[j], ref[o].numpy(),
                                       rtol=1e-5, atol=1e-5)
        same_outputs(got, list(plain), f"plain executor, request {i}")
        oracle_plain.append(host_outputs(list(plain)))
    for n in names:
        same_outputs(call_outs[n], delivered[4][names.index(n)],
                     f"Overlay.__call__ {n}")
    assert tk.launch_counts == counts, "the comparisons launched a kernel"

    for name in ("tmfu_multi", "tmfu_multi_inplace", "tmfu_single"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    emit({"phase": "serve", "servers": reports, "launches": counts,
          "checked": {"requests": n_requests,
                      "dfg_eval_rtol_atol": 1e-5,
                      "plain_executor": "bit-exact",
                      "drains_agree": "bit-exact"}})
    return counts, {"flush_sync": oracle_sync, "plain": oracle_plain}


#: the fleet phase's drains: (replicas, bank capacity, rounds in flight,
#: work stealing).  Two banks of 2 with two rounds in flight hold 4 of the
#: 9 contexts, both slots of a bank pinned while its rounds run: nearly
#: every round evicts, and its slot writes queue behind a running round.
FLEET_CONFIGS = ((2, 4, 2, False), (2, 4, 2, True), (4, 4, 2, False),
                 (4, 4, 2, True), (2, 2, 2, True))
#: every wait of the fleet and edge phases gives up after this long
WAIT_S = 120.0


def check_against(got: dict, tickets, oracle, what) -> None:
    """Every ticket delivered, and each request's outputs equal to both
    oracles bit for bit (the single-bank ``flush_sync`` and the plain
    executor of the serve phase)."""
    missing = [t for t in tickets if t not in got]
    assert not missing, f"{what}: {len(missing)} tickets not delivered"
    for i, t in enumerate(tickets):
        outs = host_outputs(got[t])
        same_outputs(outs, oracle["flush_sync"][i],
                     f"{what}, request {i} vs single-bank flush_sync")
        same_outputs(outs, oracle["plain"][i],
                     f"{what}, request {i} vs plain executor")


def fleet(device, n, cap, inflight, steal, **kw):
    """A fleet of ``n`` replicas on the one card, one stream each."""
    from repro_torch.launch.serve import ShardedOverlayServer
    srv = ShardedOverlayServer(
        n_replicas=n, bank_capacity=cap, tile=TILE, max_inflight=inflight,
        round_kernels=max(1, cap // 2), quantum_tiles=1024, steal=steal,
        devices=[device], **kw)
    streams = {rep.stream.cuda_stream for rep in srv.replicas}
    assert len(streams) == n, "replicas share a stream"
    assert torch.cuda.default_stream(device).cuda_stream not in streams
    return srv


def fleet_elastic(trace, device, oracle) -> dict:
    """The trace in six bursts through ``pump_once`` (the pump thread's
    unit of work), a ``PressureAutoscaler`` (1 to 4 replicas) acting on
    every step, one forced ``add_replica`` and one ``drain_replica`` while
    work is queued and in flight.  Every ticket is claimed exactly once."""
    from repro_torch.sched import PressureAutoscaler
    # grow at more than four requests' tiles queued a replica; shrink a
    # replica idle for eight observations (the bursts keep them busy, the
    # idle ticks at the end do not)
    auto = PressureAutoscaler(up_tiles=4 * LANES // TILE, up_rounds=1,
                              down_rounds=8, cooldown_s=0.0, min_replicas=1,
                              max_replicas=4)
    srv = fleet(device, 1, 4, 2, True, autoscaler=auto)
    tickets, got = [], {}

    def claim():
        for t in tickets:
            if t not in got:
                out = srv.try_result(t)
                if out is not None:
                    got[t] = out

    t0 = time.perf_counter()
    burst = len(trace) // 6
    forced = {}
    for b in range(6):
        tickets += [srv.submit(k, xs, tenant=tn)
                    for k, xs, tn in trace[b * burst:(b + 1) * burst]]
        if b == 0:
            forced["add_replica"] = srv.add_replica()
        if b == 3:      # a burst just queued, earlier rounds in flight
            assert srv.pending > 0 and srv.n_replicas > 1
            forced["drain_replica"] = srv.drain_replica(0)
        for _ in range(3):
            srv.pump_once()
        claim()
    deadline = time.perf_counter() + WAIT_S
    while srv.pending:
        srv.pump_once()
        claim()
        assert time.perf_counter() < deadline, "elastic drain hung"
    claim()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for _ in range(24):                 # idle ticks: where scale-downs come
        srv.pump_once()
    for t in tickets:
        try:
            srv.try_result(t)
        except KeyError:
            continue
        raise AssertionError(f"ticket {t} was claimable twice")
    check_against(got, tickets, oracle, "elastic")
    st = srv.stats()
    assert srv.n_scale_ups > 1 and srv.n_scale_downs >= 1, st
    return {"config": "elastic", "requests": len(trace), "seconds": dt,
            "requests_per_s": len(trace) / dt,
            "forced": {"add_replica": forced["add_replica"],
                       "drain_replica": {k: forced["drain_replica"][k]
                                         for k in ("replica",
                                                   "evacuated_requests",
                                                   "orphaned_results")}},
            "scale_ups": srv.n_scale_ups, "scale_downs": srv.n_scale_downs,
            "evacuated_requests": srv.n_evacuated_requests,
            "peak_replicas": srv.peak_replicas,
            "replicas_at_end": srv.n_replicas,
            "route_hits": srv.n_route_hits, "route_misses": srv.n_route_misses,
            "migrations": srv.n_migrations, "steals": srv.n_steals,
            "delivered_exactly_once": len(got)}


def annotate_replicas(srv) -> None:
    """Mark every replica's device work in a profile: its launch and its
    delivery run inside ``record_function("replica<i>")``.  The stream
    they run on is the replica's own doing; this only names them."""
    from torch.profiler import record_function
    for i, rep in enumerate(srv.replicas):
        for name in ("_launch_round", "_retire_oldest"):
            method = getattr(rep, name)

            def named(*a, _m=method, _n=f"replica{i}", **kw):
                with record_function(_n):
                    return _m(*a, **kw)
            setattr(rep, name, named)


def trace_streams(path, n_replicas) -> dict:
    """Read a chrome trace of the 4-replica flush: the stream of every
    device event, the replica whose annotated host code issued it (by the
    runtime call's correlation id), the marker copies that name each
    stream, the device's busy time and the overlap of kernels of
    different replicas."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    device, runtime, spans = [], {}, []
    for e in events:
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            runtime[args["correlation"]] = e
        elif cat == "user_annotation" and e.get("name", "").startswith(
                "replica"):
            spans.append(e)

    def issuer(e):
        r = runtime.get((e.get("args") or {}).get("correlation"))
        if r is None:
            return None
        for s in spans:
            if (s.get("tid") == r.get("tid") and s["ts"] <= r["ts"]
                    <= s["ts"] + s.get("dur", 0)):
                return int(s["name"][len("replica"):])
        return None

    marker, by_replica, tmfu = {}, {}, []
    for e in device:
        args = e["args"]
        if e["name"].startswith("Memcpy HtoD") and args.get("bytes") in (
                MARK_DEFAULT, *(MARK_REPLICA + i for i in range(n_replicas))):
            marker[args["bytes"]] = args["stream"]
            continue
        who = issuer(e)
        if who is not None:
            by_replica.setdefault(who, {}).setdefault(
                "H2D" if e["name"].startswith("Memcpy HtoD") else
                "other", set()).add(args["stream"])
        if "tmfu_multi" in e["name"]:
            tmfu.append((e["ts"], e["ts"] + e.get("dur", 0), args["stream"],
                         who))
    intervals = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in device
                       if e["args"].get("bytes") not in marker)
    busy, end = 0.0, None
    for a, b in intervals:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    overlap_pairs, overlap_us = 0, 0.0
    for i, (a0, a1, sa, _) in enumerate(tmfu):
        for b0, b1, sb, _ in tmfu[i + 1:]:
            if sa != sb and min(a1, b1) > max(a0, b0):
                overlap_pairs += 1
                overlap_us += min(a1, b1) - max(a0, b0)
    names = sorted({e["name"][:60] for e in device})
    return {"marker": marker, "by_replica": by_replica, "tmfu": tmfu,
            "device_names": names, "n_runtime": len(runtime),
            "n_spans": len(spans),
            "busy_us": busy, "overlap_pairs": overlap_pairs,
            "overlap_us": overlap_us}


#: byte counts of the marker copies that name the streams in a profile
MARK_DEFAULT, MARK_REPLICA = 13, 17


def fleet_profile(srv, trace, device) -> dict:
    """One warm flush of the trace on the 4-replica fleet under
    ``torch.profiler``.  Asserts that the multi-context kernels ran on
    exactly one stream a replica, none of them the default stream, and
    that every device operation a replica issued (its H2D copies above
    all) ran on that replica's stream.  Reports, without asserting,
    whether kernels of two replicas overlapped in time."""
    from torch.profiler import ProfilerActivity, profile
    n = srv.n_replicas
    annotate_replicas(srv)
    tickets = [srv.submit(k, xs, tenant=t) for k, xs, t in trace]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.empty(MARK_DEFAULT, dtype=torch.uint8).to(device)
        for i, rep in enumerate(srv.replicas):
            with rep.on_stream():
                torch.empty(MARK_REPLICA + i, dtype=torch.uint8).to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = srv.flush()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "fleet_profile.json"
    prof.export_chrome_trace(str(path))
    tr = trace_streams(path, n)
    seen = {k: tr[k] for k in ("marker", "device_names", "n_runtime",
                               "n_spans")}
    assert len(tr["marker"]) == n + 1, f"marker copies not traced: {seen}"
    default = tr["marker"][MARK_DEFAULT]
    own = [tr["marker"][MARK_REPLICA + i] for i in range(n)]
    assert len(set(own)) == n and default not in own, tr["marker"]
    kernel_streams = {s for _, _, s, _ in tr["tmfu"]}
    assert tr["tmfu"], f"no tmfu_multi launch in the profile: {seen}"
    assert kernel_streams == set(own), (
        f"tmfu_multi ran on streams {sorted(kernel_streams)}, the replicas "
        f"own {own}, the default stream is {default}")
    for i in range(n):
        seen = tr["by_replica"].get(i, {})
        assert seen.get("H2D") == {own[i]}, (
            f"replica {i}'s H2D copies ran on {seen.get('H2D')}, its "
            f"stream is {own[i]}")
        assert seen.get("other", {own[i]}) == {own[i]}, (
            f"replica {i}'s device work ran on {seen['other']}")
        assert {s for _, _, s, w in tr["tmfu"] if w == i} <= {own[i]}
    path.unlink()                     # kept above only when a check fails
    return {"tickets": tickets, "got": got,
            "report": {"what": "one warm flush, 4 replicas, bank 4",
                       "wall_ms": wall_ms,
                       "device_busy_ms": tr["busy_us"] / 1e3,
                       "device_idle_share": 1 - tr["busy_us"] / 1e3 / wall_ms,
                       "tmfu_launches": len(tr["tmfu"]),
                       "tmfu_streams": len(kernel_streams),
                       "default_stream_used_by_tmfu": default in kernel_streams,
                       "h2d_on_own_stream": True,
                       "kernels_of_two_replicas_overlapped":
                           tr["overlap_pairs"] > 0,
                       "overlap_pairs": tr["overlap_pairs"],
                       "overlap_ms": tr["overlap_us"] / 1e3}}


def phase_fleet(kernels, names, device, oracle) -> dict:
    """``ShardedOverlayServer`` on the card: every configuration of
    ``FLEET_CONFIGS`` drained by ``flush``, ``as_completed`` and
    ``flush_sync``; the elastic run; the profiled 4-replica flush.
    Returns the launch counts of this path."""
    from repro_torch.kernels.tmfu import kernel as tk
    from repro_torch.launch.mesh import device_sharing
    from repro_torch.telemetry import check_stats
    trace = make_trace(kernels, names, N_REQUESTS, LANES, N_TENANTS)
    tk.reset_launch_counts()
    reports, results, profiled = [], [], None
    for n, cap, inflight, steal in FLEET_CONFIGS:
        srv = fleet(device, n, cap, inflight, steal)
        times = {}
        for mode in ("flush", "as_completed", "flush_sync"):
            tickets = [srv.submit(k, xs, tenant=t) for k, xs, t in trace]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "flush":
                res = srv.flush()
            elif mode == "as_completed":
                res = dict(srv.as_completed())
            else:
                res = srv.flush_sync()
            torch.cuda.synchronize()
            times[mode] = time.perf_counter() - t0
            results.append((f"{n} replicas, bank {cap}, steal {steal}: "
                            f"{mode}", res, tickets))
        st = srv.stats()
        check_stats("fleet", st)
        assert st["pending"] == 0
        if n * cap < len(names):
            assert st["evictions"] > 0, "the banks must evict on 9 kernels"
        reports.append({
            "replicas": n, "bank_capacity": cap, "max_inflight": inflight,
            "router": st["router"], "requests": N_REQUESTS,
            "flush_s": times["flush"],
            "requests_per_s": N_REQUESTS / times["flush"],
            "as_completed_s": times["as_completed"],
            "flush_sync_s": times["flush_sync"],
            "device_sharing": device_sharing(srv.devices),
            "route_hits": st["route_hits"],
            "route_misses": st["route_misses"],
            "migrations": st["migrations"], "steals": st["steals"],
            "rounds": st["rounds"], "evictions": st["evictions"],
            "peak_replicas": st["peak_replicas"]})
        if (n, cap, steal) == (4, 4, False):
            profiled = srv
    elastic = fleet_elastic(trace, device, oracle)
    prof = fleet_profile(profiled, trace, device)
    torch.cuda.synchronize()
    counts = dict(tk.launch_counts)          # read right behind the main path
    for what, res, tickets in results:
        check_against(res, tickets, oracle, what)
    check_against(prof["got"], prof["tickets"], oracle, "profiled flush")
    assert tk.launch_counts == counts, "the comparisons launched a kernel"
    if counts["tmfu_multi_inplace"] <= 0:
        raise AssertionError("tmfu_multi_inplace was not launched on the "
                             "fleet path")
    emit({"phase": "fleet", "configs": reports, "elastic": elastic,
          "profile": prof["report"], "launches": counts,
          "checked": {"drains": len(results) + 1, "requests": N_REQUESTS,
                      "against": "single-bank flush_sync and plain "
                                 "executor of the serve phase",
                      "tolerance": "bit-exact"}})
    return counts


class LoopThread:
    """An asyncio event loop on a thread of its own (the socket server's);
    every call into it waits at most ``WAIT_S``."""

    def __init__(self):
        import asyncio
        import threading
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="edge-server-loop", daemon=True)
        self.thread.start()

    def run(self, coro):
        import asyncio
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            WAIT_S)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(WAIT_S)
        assert not self.thread.is_alive(), "the server loop did not stop"
        self.loop.close()


def phase_edge(kernels, names, device, oracle) -> dict:
    """The network edge on the card: an ``OverlaySocketServer`` on
    127.0.0.1 (an ephemeral port; its asyncio loop on a thread of this
    process) serves an ``OverlayGateway`` over a 2-replica
    ``ShardedOverlayServer`` that an ``AutoPump`` thread drives.  The
    port's ``RemoteOverlayClient`` submits the trace and streams the
    results back; each is held against the serve phase's oracles.
    Returns the launch counts of this path."""
    import asyncio
    from repro_torch.kernels.tmfu import kernel as tk
    from repro_torch.launch.gateway import OverlayGateway
    from repro_torch.launch.socket_gateway import (OverlaySocketServer,
                                                   RemoteOverlayClient)
    from repro_torch.launch.transport import HAVE_MSGPACK
    from repro_torch.telemetry import check_stats
    trace = make_trace(kernels, names, N_REQUESTS, LANES, N_TENANTS)
    srv = fleet(device, 2, 4, 2, False)
    loop = LoopThread()
    gateway = OverlayGateway(srv, max_fleet_tiles=8 * LANES // TILE,
                             poll_interval=0.001)
    server = OverlaySocketServer(gateway, "127.0.0.1", 0)
    tk.reset_launch_counts()
    try:
        loop.run(server.start())

        async def client():
            got, t_sub, t_got = {}, {}, {}
            async with RemoteOverlayClient("127.0.0.1", server.port,
                                           tenant="edge",
                                           session="smoke") as c:
                async def collect(n):
                    # results() ends whenever nothing is outstanding, which
                    # happens between submits: go round until all are in
                    while len(got) < n:
                        async for t, outs in c.results():
                            t_got[t] = time.perf_counter()
                            got[t] = outs
                        await asyncio.sleep(0.0005)
                t0 = time.perf_counter()
                reader = None
                tickets = []
                for k, xs, _ in trace:
                    ts = time.perf_counter()
                    t = await asyncio.wait_for(c.submit(k, xs), WAIT_S)
                    t_sub[t] = ts
                    tickets.append(t)
                    if reader is None:
                        reader = asyncio.ensure_future(collect(len(trace)))
                await asyncio.wait_for(reader, WAIT_S)
                dt = time.perf_counter() - t0
                codec = c.codec
            return tickets, got, t_sub, t_got, dt, codec

        tickets, got, t_sub, t_got, dt, codec = asyncio.run(
            asyncio.wait_for(client(), WAIT_S))
        torch.cuda.synchronize()
        counts = dict(tk.launch_counts)      # read right behind the main path
        stats = loop.run(_edge_stats(server))
    finally:
        loop.run(server.aclose())
        loop.run(gateway.aclose())
        loop.close()
    check_stats("socket", stats["socket"])
    assert stats["socket"]["wire_rejects"] == 0
    check_against(got, tickets, oracle, "edge")
    assert tk.launch_counts == counts, "the comparisons launched a kernel"
    if counts["tmfu_multi_inplace"] <= 0:
        raise AssertionError("tmfu_multi_inplace was not launched on the "
                             "edge path")
    lat = np.asarray([t_got[t] - t_sub[t] for t in tickets]) * 1e3
    emit({"phase": "edge", "codec": codec, "msgpack": HAVE_MSGPACK,
          "replicas": 2, "bank_capacity": 4, "requests": len(trace),
          "seconds": dt, "requests_per_s": len(trace) / dt,
          "client_latency_ms": {f"p{q}": float(np.percentile(lat, q))
                                for q in (50, 95, 99)},
          "wire_bytes_in": stats["socket"]["wire_bytes_in"],
          "wire_bytes_out": stats["socket"]["wire_bytes_out"],
          "edge_queued": stats["socket"]["gateway"]["edge_queued"],
          "pump_rounds": stats["pump_rounds"], "launches": counts,
          "checked": {"requests": len(trace), "tolerance": "bit-exact",
                      "against": "single-bank flush_sync and plain "
                                 "executor of the serve phase"}})
    return counts


async def _edge_stats(server):
    return {"socket": server.stats(),
            "pump_rounds": server.gateway.pump.n_pump_rounds}


# ------------------------------------------------------------------- LM path
#: the LM phase's runs: the reference CLI's defaults (batch, prompt, tokens)
LM_BATCH, LM_PROMPT, LM_GEN = 4, 32, 16
#: full-width runs: (arch, layers kept; None = full depth)
LM_FULL = (("deepseek-7b", None), ("mamba2-2.7b", None),
           ("phi3.5-moe-42b-a6.6b", 2), ("qwen2-moe-a2.7b", None))
#: card against the port's CPU path, float32 mode: max|a - b| / max|b|.
#: Both sides are float32 (TF32 off); summation order and exp / sin / cos
#: differ, which the CPU tests measure below 3e-6 against JAX.  TF32
#: (inputs rounded to 2^-11) or one bfloat16 step (2^-8) exceeds it; the
#: ``tf32_control`` entry shows what TF32 gives.
SMOKE_F32_REL = 1e-4
#: full width, bfloat16 prefill + decode through the cache against the
#: float32 forward at the same positions, per position ||a - b|| / ||b||
#: over the vocabulary.  The bfloat16 forward over the same tokens is the
#: precision's own distance from float32 (0.6 % for phi3.5-moe's 2 layers,
#: 2.0 % for deepseek-7b's 30, 6.1 % for mamba2-2.7b's 64: NVIDIA H100 80GB
#: HBM3, 700.00 W), so the decode's median distance may exceed the bf16
#: forward's by at most a quarter (``DECODE_VS_FORWARD``): a decode path
#: that rounds more than the configured bfloat16, or reads a wrong cache
#: slot, is farther.  Every position must also be within 10 % and all of
#: them together correlate above 0.99; a MoE token whose top-2 experts
#: are a near-tie may route differently in the two precisions, so there
#: 90 % of positions must meet the 10 %.
#: For a MoE model both forwards route each token to the experts the
#: decode chose (``moe_routing``): top-k is discontinuous, and a token
#: whose k-th and (k+1)-th experts are nearer than the two precisions'
#: router difference swaps one, after which its later layers part;
#: routed alike, the two precisions differ by rounding alone.  The
#: routing is then held on its own: at every MoE layer the decode's
#: router log-probabilities against the float32 forward's on the same
#: path correlate above ``ROUTER_CC``, and every token whose top-k set
#: differs from the one float32 picks there is one that the two
#: precisions' router difference explains (``routing_check``).  The free
#: forwards' distances are reported beside.
FULL_REL_L2 = 0.1
DECODE_VS_FORWARD = 1.25
ROUTER_CC = 0.99


def rel_max(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def bf16_criterion(got, want, what) -> dict:
    """The reference's own bfloat16 criterion (``tests/test_arch_smoke.py``):
    correlation > 0.99, top-1 agreement >= 0.95, every top-1 mismatch a
    near-tie (top-2 gap under 0.1 of the logits' std) on both sides."""
    a = got.float().cpu().reshape(-1, got.shape[-1])
    b = want.float().cpu().reshape(-1, got.shape[-1])
    cc = float(np.corrcoef(a.numpy().ravel(), b.numpy().ravel())[0, 1])
    am, bm = a.argmax(-1), b.argmax(-1)
    agree = float((am == bm).float().mean())
    tie = 0.1 * float(b.std())
    for i in torch.nonzero(am != bm).flatten().tolist():
        gap = max(abs(float(a[i, am[i]] - a[i, bm[i]])),
                  abs(float(b[i, am[i]] - b[i, bm[i]])))
        assert gap < tie, f"{what}: row {i} flips top-1 by {gap} > {tie}"
    assert cc > 0.99 and agree >= 0.95, f"{what}: cc {cc}, top-1 {agree}"
    return {"cc": cc, "top1": agree}


class compute_dtype:
    """``COMPUTE_DTYPE`` of the port's models set to ``dtype`` inside the
    block (both modules that read it), and the old value back after."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __enter__(self):
        from repro_torch.models import layers, model
        self.mods = (layers, model)
        self.old = [m.COMPUTE_DTYPE for m in self.mods]
        for m in self.mods:
            m.COMPUTE_DTYPE = self.dtype

    def __exit__(self, *exc):
        for m, old in zip(self.mods, self.old):
            m.COMPUTE_DTYPE = old


class moe_routing:
    """The MoE's top-k (``layers.lax_top_k``: one call a MoE layer, in
    layer order) watched inside the block: ``calls`` keeps each call's
    router probabilities and the ids that the top-k picked from them.
    With ``force`` (one [T, k] id tensor a call, in call order) the run
    routes by those ids instead, its gates taken from its own
    probabilities."""

    def __init__(self, force=None):
        self.force = force
        self.calls = []

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, self.top_k = layers, layers.lax_top_k

        def watched(x, k):
            vals, idx = self.top_k(x, k)
            self.calls.append((x.detach(), idx))
            if self.force is not None:
                idx = self.force[len(self.calls) - 1]
                assert idx.shape == (x.shape[0], k), (idx.shape, x.shape)
                vals = x.gather(-1, idx)
            return vals, idx

        layers.lax_top_k = watched
        return self

    def __exit__(self, *exc):
        self.layers.lax_top_k = self.top_k


def moe_routes(calls, runs: int, B: int) -> list:
    """The (probabilities, ids) a generation routed by, per MoE layer,
    over [B * positions] rows, b-major: its ``runs`` model calls (the
    prefill, then one decode step a call) joined along the positions, as
    a forward over the same tokens meets them."""
    n = len(calls) // runs
    assert n * runs == len(calls), (len(calls), runs)
    out = []
    for layer in range(n):
        parts = [calls[s * n + layer] for s in range(runs)]
        out.append(tuple(
            torch.cat([x[j].reshape(B, -1, x[j].shape[-1]) for x in parts],
                      1).flatten(0, 1) for j in (0, 1)))
    return out


def routing_check(routes, calls32) -> dict:
    """The decode's routing (``moe_routes``) against the float32 forward
    that was forced to it, layer by layer.  ``flip_share``: tokens whose
    top-k set differs from the one float32 picks from its own router
    probabilities at that layer; ``router_cc``: the correlation of the
    two router log-probabilities.  A flip is explained when float32's
    k-th probability exceeds the decode's weakest pick (in float32) by at
    most twice the token's largest log-probability difference between
    the precisions — what a correct top-k of the bfloat16 probabilities
    can give; ``unexplained`` counts the others."""
    layers = []
    for (p16, d), (p32, f) in zip(routes, calls32):
        lp16, lp32 = (p.clamp_min(1e-30).log() for p in (p16, p32))
        flips = (d.sort(-1).values != f.sort(-1).values).any(-1)
        err = (lp16 - lp32).abs().amax(-1)
        gap = lp32.gather(-1, f).amin(-1) - lp32.gather(-1, d).amin(-1)
        unexplained = flips & (gap > 2 * err + 1e-6)
        cc = float(np.corrcoef(lp16.cpu().numpy().ravel(),
                               lp32.cpu().numpy().ravel())[0, 1])
        over = gap[flips] / (2 * err[flips]).clamp_min(1e-30)
        layers.append({"flip_share": float(flips.float().mean()),
                       "router_cc": cc,
                       "router_err_median": float(err.median()),
                       "flip_gap_over_bound_max":
                           float(over.max()) if flips.any() else 0.0,
                       "unexplained": int(unexplained.sum())})
    return {"tokens": int(routes[0][1].shape[0]), "layers": layers,
            "flip_share_mean": float(np.mean([r["flip_share"]
                                              for r in layers])),
            "router_cc_min": min(r["router_cc"] for r in layers),
            "unexplained": sum(r["unexplained"] for r in layers)}


def smoke_inputs(cfg, dtype, seed=1, B=2, S=17):
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab, (B, S)))
    kw = {}
    if cfg.vision_tokens:
        kw["extra_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)).to(dtype)
    if cfg.encoder is not None:
        kw["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, S - 1, cfg.d_model)).astype(np.float32)).to(dtype)
    return tokens, kw


def smoke_on(cfg, tree, device, dtype):
    """forward, prefill and one decode step of a smoke config on ``device``
    (the decode on the CPU's prefill caches, passed as ``caches``)."""
    from repro_torch.models import (decode_step, forward, params_from_numpy,
                                    prefill)
    params = params_from_numpy(cfg, tree, device)
    tokens, kw = smoke_inputs(cfg, dtype)
    kw = {k: v.to(device) for k, v in kw.items()}
    tokens = tokens.to(device)
    P = tokens.shape[1] - 1
    logits, aux, _ = forward(cfg, params, tokens, **kw)
    last, caches = prefill(cfg, params, tokens[:, :P],
                           cache_len=P + 8 + cfg.vision_tokens, **kw)
    return params, tokens, logits, aux, last, caches


def lm_smoke(device) -> list:
    """All ten smoke configs: the card against the port's CPU path on the
    same numpy weights (``numpy_params``) and inputs, float32 and bfloat16
    mode; forward logits and aux, prefill's last logits and caches, one
    decode step on the CPU's caches."""
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.models import decode_step, numpy_params
    from repro_torch.models.blocks import tree_leaves, tree_map
    rows = []
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        tree = numpy_params(cfg, SEED)
        row = {"arch": arch}
        for mode, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            with compute_dtype(dtype):
                cpu = smoke_on(cfg, tree, "cpu", dtype)
                gpu = smoke_on(cfg, tree, device, dtype)
                P = cpu[1].shape[1] - 1
                pos = P + cfg.vision_tokens
                tok = cpu[1][:, P:P + 1]
                # the step writes slot ``pos`` of the caches it is given:
                # a copy, so that cpu[5] stays the prefill's
                d_cpu, _ = decode_step(cfg, cpu[0],
                                       tree_map(torch.clone, cpu[5]), tok,
                                       pos)
                d_gpu, _ = decode_step(
                    cfg, gpu[0], tree_map(lambda t: t.to(device), cpu[5]),
                    tok.to(device), pos)
                torch.cuda.synchronize()
            pairs = {"forward": (gpu[2], cpu[2]), "prefill": (gpu[4], cpu[4]),
                     "decode": (d_gpu, d_cpu)}
            caches = list(zip(tree_leaves(gpu[5]), tree_leaves(cpu[5])))
            if mode == "float32":
                errs = {k: rel_max(*v) for k, v in pairs.items()}
                for k, e in errs.items():
                    assert e <= SMOKE_F32_REL, f"{arch} float32 {k}: {e}"
                aux = abs(float(gpu[3]) - float(cpu[3]))
                assert aux <= SMOKE_F32_REL * max(abs(float(cpu[3])), 1.0)
                for g, c in caches:        # bf16 caches: one bf16 ulp
                    torch.testing.assert_close(g.float().cpu(), c.float(),
                                               rtol=2 ** -7, atol=1e-5)
                row["float32_rel_max"] = errs
            else:
                row["bfloat16"] = {k: bf16_criterion(*v, f"{arch} {k}")
                                   for k, v in pairs.items()}
                for g, c in caches:
                    g, c = g.float().cpu().ravel(), c.float().ravel()
                    if c.abs().max() > 0:
                        cc = float(np.corrcoef(g.numpy(), c.numpy())[0, 1])
                        assert cc > 0.99, f"{arch} bfloat16 cache: {cc}"
        rows.append(row)
    # the negative control: TF32 matmuls in the float32 path of one config
    cfg = get_smoke_config("deepseek-7b")
    tree = numpy_params(cfg, SEED)
    with compute_dtype(torch.float32):
        cpu = smoke_on(cfg, tree, "cpu", torch.float32)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            gpu = smoke_on(cfg, tree, device, torch.float32)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    rows.append({"tf32_control": "deepseek-7b smoke, TF32 matmuls",
                 "float32_rel_max": {"forward": rel_max(gpu[2], cpu[2]),
                                     "prefill": rel_max(gpu[4], cpu[4])},
                 "bound": SMOKE_F32_REL})
    return rows


def device_time_by_kernel(prof) -> list:
    """Device-side entries of a ``torch.profiler`` run (kernels, copies,
    memsets), by name, longest first."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append({"name": e.key[:80], "calls": e.count,
                         "device_ms": us / 1e3})
    return sorted(rows, key=lambda r: -r["device_ms"])


def lm_profile(cfg, params, batch, device) -> dict:
    """Two warm decode steps under ``torch.profiler``: wall, device busy
    (one stream: the sum of its entries), idle share, the ten longest
    device entries, and how many kernels a step launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    S = batch["tokens"].shape[1]
    _, caches = make_prefill_step(cfg, cache_len=S + LM_GEN)(params, batch)
    decode = make_decode_step(cfg)
    tok = batch["tokens"][:, -1:]
    _, tok, caches = decode(params, caches, tok, S)      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2):
            _, tok, caches = decode(params, caches, tok[:, None], S + 1 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_time_by_kernel(prof)
    busy = sum(r["device_ms"] for r in rows)
    return {"what": "two warm decode steps", "wall_ms": wall_ms,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms if rows else None,
            "device_entries_per_step": sum(r["calls"] for r in rows) / 2,
            "by_device_time": rows[:10]}


def lm_full(arch, layers, device) -> dict:
    """One model at its published widths (depth cut to ``layers`` where
    given) through ``lm_generate``, the CLI's function: twice (the second
    run timed, and for MoE bit-compared with the first), then the float32
    forward at the same positions (a MoE model's routed as the decode
    was, the routing then checked against float32's own)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import lm_batch, lm_generate
    from repro_torch.models import forward, init_params
    cfg = get_config(arch)
    if layers is not None:
        (stack,) = cfg.stacks
        cfg = dataclasses.replace(
            cfg, stacks=(dataclasses.replace(stack, count=layers),))
    n_params = cfg.param_count()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device).manual_seed(SEED),
                         device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    batch = lm_batch(cfg, LM_BATCH, LM_PROMPT, device)
    with moe_routing() as watched:
        first = lm_generate(cfg, params, batch, LM_GEN, device)
    run = lm_generate(cfg, params, batch, LM_GEN, device)
    peak = torch.cuda.max_memory_allocated(device)
    profiled = lm_profile(cfg, params, batch, device) \
        if arch == LM_FULL[0][0] else None
    repeat = all(torch.equal(a, b) for a, b in zip(first.logits, run.logits)) \
        and torch.equal(first.tokens, run.tokens)
    if cfg.n_experts:
        assert repeat, f"{arch}: two runs differ (the combine must not)"
    # the float32 forward over prompt + generated tokens: position
    # LM_PROMPT - 1 + i predicts generated token i; and the bfloat16
    # forward over the same tokens, the precision's own distance from it.
    # A MoE model's forwards route as the decode did (the first run's
    # routing: the second repeats it bit for bit)
    seq = torch.cat([batch["tokens"], run.tokens[:, :-1]], 1)
    routes = moe_routes(watched.calls, LM_GEN, LM_BATCH) \
        if cfg.n_experts else None
    force = [i for _, i in routes] if routes else None
    with compute_dtype(torch.float32), moe_routing(force) as forced32:
        ref, _, _ = forward(cfg, params, seq)
    ref = ref[:, LM_PROMPT - 1:].float()
    with moe_routing(force):
        fwd_bf16 = forward(cfg, params, seq)[0][:, LM_PROMPT - 1:].float()
    got = torch.stack(run.logits, 1).float()

    def rel_l2(a, b=ref):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).flatten()

    def corr(a, b=ref):
        return float(np.corrcoef(a.cpu().numpy().ravel(),
                                 b.cpu().numpy().ravel())[0, 1])

    rel, rel_fwd = rel_l2(got), rel_l2(fwd_bf16)
    cc = corr(got)
    within = float((rel <= FULL_REL_L2).float().mean())
    top1 = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    need = 0.9 if cfg.n_experts else 1.0
    failures = []
    if not torch.isfinite(got).all():
        failures.append(f"{arch}: logits not finite")
    ratio = float(rel.median() / rel_fwd.median())
    if within < need or cc <= 0.99 or ratio > DECODE_VS_FORWARD:
        failures.append(f"{arch}: bf16 decode vs float32 forward: {within} "
                        f"of positions within {FULL_REL_L2}, cc {cc}, "
                        f"median {ratio} x the bf16 forward's")
    routing = free = None
    if routes:
        routing = routing_check(routes, forced32.calls)
        if routing["router_cc_min"] <= ROUTER_CC or routing["unexplained"]:
            failures.append(f"{arch}: routing: router cc "
                            f"{routing['router_cc_min']}, "
                            f"{routing['unexplained']} flips unexplained")
        # the same distances with every forward routing by itself
        with compute_dtype(torch.float32):
            ref_free = forward(cfg, params, seq)[0][:, LM_PROMPT - 1:].float()
        fwd_free = forward(cfg, params, seq)[0][:, LM_PROMPT - 1:].float()
        free = {"rel_l2_median": float(rel_l2(got, ref_free).median()),
                "cc": corr(got, ref_free),
                "bf16_forward_rel_l2_median":
                    float(rel_l2(fwd_free, ref_free).median()),
                "bf16_forward_rel_l2_max":
                    float(rel_l2(fwd_free, ref_free).max()),
                "bf16_forward_cc": corr(fwd_free, ref_free)}
        del ref_free, fwd_free
    step_bytes = 8 * n_params      # f32 read, bf16 cast written and read
    out = {"arch": arch, "layers": cfg.n_layers, "params": n_params,
           "depth_cut": layers is not None, "init_s": t_init,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
           "prefill_ms": run.prefill_s * 1e3,
           "prefill_tok_s": LM_BATCH * LM_PROMPT / run.prefill_s,
           "decode_ms_per_step": run.decode_s * 1e3 / (LM_GEN - 1),
           "decode_tok_s": LM_BATCH * (LM_GEN - 1) / run.decode_s,
           "first_prefill_ms": first.prefill_s * 1e3,
           "first_decode_ms_per_step": first.decode_s * 1e3 / (LM_GEN - 1),
           "decode_step_bytes": step_bytes,
           "decode_bound_ms": step_bytes / PEAK_BYTES_PER_S * 1e3,
           "max_memory_allocated_gb": peak / 1e9,
           "init_max_memory_allocated_gb": init_peak / 1e9,
           "vs_float32_forward": {
               "rel_l2_median": float(rel.median()),
               "rel_l2_max": float(rel.max()), "within": within,
               "bound": FULL_REL_L2, "cc": cc, "top1": top1,
               "bf16_forward_rel_l2_median": float(rel_fwd.median()),
               "bf16_forward_rel_l2_max": float(rel_fwd.max()),
               "median_vs_bf16_forward": ratio,
               "ratio_bound": DECODE_VS_FORWARD,
               "routed_as_decode": routes is not None},
           "routing": routing, "free_routing": free,
           "repeat_bit_for_bit": repeat, "profile": profiled,
           "sample_ids": run.tokens[0, :12].tolist(),
           "failures": failures}
    emit({"phase": "lm_full", **out})
    del params, first, run, ref, got, fwd_bf16, watched, routes, forced32
    torch.cuda.empty_cache()
    return out


def phase_lm(device) -> tuple[dict, dict]:
    """The LM serving path (``models/``, ``runtime/steps.py``,
    ``lm_generate``): the smoke configs against the CPU, then the
    full-width runs.  Returns the TMFU launch counts it caused (none) and
    the Mamba2 decode kernels' (mamba2-2.7b's decode)."""
    from repro_torch.kernels.attn_decode import kernel as adk
    from repro_torch.kernels.ssm_decode import kernel as sdk
    from repro_torch.kernels.tmfu import kernel as tk
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    t0 = time.perf_counter()
    tk.reset_launch_counts()
    adk.reset_launch_counts()
    sdk.reset_launch_counts()
    full = [lm_full(arch, layers, device) for arch, layers in LM_FULL]
    counts = dict(tk.launch_counts)          # read right behind the main path
    attn = dict(adk.launch_counts)
    ssm = dict(sdk.launch_counts)
    assert ssm["ssm_decode_step"] > 0 and ssm["rms_norm"] > 0, ssm
    failures = [f for row in full for f in row["failures"]]
    assert not failures, failures
    smoke = lm_smoke(device)
    emit({"phase": "lm", "seconds": time.perf_counter() - t0,
          "smoke": smoke, "full": [r["arch"] for r in full],
          "launches": counts, "attn_decode_launches": attn,
          "ssm_decode_launches": ssm,
          "tolerances": {"smoke_float32_rel_max": SMOKE_F32_REL,
                         "smoke_bfloat16": "cc > 0.99, top-1 >= 0.95, "
                                           "mismatches near-ties",
                         "full_rel_l2": FULL_REL_L2,
                         "full_median_vs_bf16_forward": DECODE_VS_FORWARD,
                         "full_router_cc": ROUTER_CC}})
    return counts, ssm


# ------------------------------------------------------------- training path
#: the full-width run: deepseek-7b at its published widths, its 30 layers
#: cut to 12 (p + g + m + v in float32 are 16 B a param: 52.3 GB; all 30
#: layers would need 110.6 GB), with the reference CLI's batch, sequence
#: and optimizer; remat "full", updated in place
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_PARAMS = "deepseek-7b", 12, 3_267_465_216
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 8
#: step 0 of that run, bfloat16 (the models' mode) against float32 (TF32
#: off), before any optimizer state exists: the loss within 1 %, and the
#: cosine of every gradient leaf's two values at least 0.99
TRAIN_BF16_LOSS_REL, TRAIN_BF16_COSINE = 0.01, 0.99
#: the co-scheduled run: a TrainingTenant (deepseek-7b smoke) on a CUDA
#: OverlayServer, latency requests of the serve trace between its rounds
TENANT_STEPS, TENANT_YIELD, TENANT_BANK, TENANT_PER_BEAT = 8, 2, 4, 8
#: published dense bfloat16 tensor-core peak of one H100 SXM
PEAK_BF16_FLOPS = 989e12


def train_config():
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    (stack,) = cfg.stacks
    return dataclasses.replace(
        cfg, stacks=(dataclasses.replace(stack, count=TRAIN_LAYERS),))


def train_step_work(cfg, B: int, S: int) -> dict:
    """Bytes and operations of one training step of ``cfg`` at B x S.

    ``min``: the step as a function: params, m and v read once and
    written once (24 B a param), the weight products' FLOPs (forward,
    backward 2x, the remat's second forward for the stacked layers) and
    the attention products.  ``code``: what this code's structure moves
    on top: per stacked matmul weight, a float32 read and bf16 cast
    written and read in the forward and again in the recompute (16 B),
    the bf16 weight read by the input gradient, the bf16 weight gradient
    written, read and widened to float32, and UnbindBackward's stack of
    the per-layer float32 gradients (18 B); the head likewise without the
    recompute and the stack (18 B); the embedding's cast and its
    gradient's zero fill and widening (14 B); the optimizer's gradient
    norm (4 B) and update (p, g, m, v read, p, m, v written: 28 B) over
    every param."""
    from repro_torch.models import init_params
    from repro_torch.models.blocks import tree_leaves_with_path
    shapes = init_params(cfg, device="meta")
    P = sum(x.numel() for _, x in tree_leaves_with_path(shapes))
    P_stack = sum(x.numel() for p, x in tree_leaves_with_path(
        shapes["stacks"]) if p.endswith("['w']"))
    P_head, P_embed = shapes["head"].numel(), shapes["embed"].numel()
    T = B * (S - 1)
    flops = (8 * P_stack + 6 * P_head) * T \
        + 16 * B * (S - 1) ** 2 * cfg.n_heads * cfg.head_dim * cfg.n_layers
    code = 34 * P_stack + 18 * P_head + 14 * P_embed + 32 * P
    return {"params": P, "stacked_matmul_params": P_stack, "tokens": T,
            "flops": flops, "min_bytes": 24 * P, "code_bytes": code,
            "bound_ms": max(24 * P / PEAK_BYTES_PER_S,
                            flops / PEAK_BF16_FLOPS) * 1e3,
            "bound_by": "bytes" if 24 * P / PEAK_BYTES_PER_S
            >= flops / PEAK_BF16_FLOPS else "operations",
            "code_bytes_bound_ms": code / PEAK_BYTES_PER_S * 1e3,
            "matmul_bound_ms": flops / PEAK_BF16_FLOPS * 1e3}


def leaf_cosines(a, b) -> list:
    from repro_torch.models.blocks import tree_leaves_with_path
    out = []
    for (path, x), (_, y) in zip(tree_leaves_with_path(a),
                                 tree_leaves_with_path(b)):
        x, y = x.float().flatten(), y.float().flatten()
        den = float(x.norm() * y.norm())
        out.append((path, float(torch.dot(x, y)) / den if den else 1.0))
    return out


def train_profile(step_fn, params, opt_state, batch) -> dict:
    """One step under ``torch.profiler``: wall, device busy (the sum of
    its kernels, copies and memsets: one stream), idle share; device time
    by kind — weight casts and copies, matmuls, the optimizer's update
    (the kernels launched inside ``train_step.update``; backward's run on
    autograd's own thread, so only the update is attributed by range),
    the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"casts_and_copies": 0.0, "matmuls": 0.0, "other": 0.0}
    update_ms, n_entries, rows = 0.0, 0, []
    for e in prof.key_averages():
        if e.key == "train_step.update":
            if e.device_type != DeviceType.CUDA:
                update_ms = getattr(e, "device_time_total",
                                    getattr(e, "cuda_time_total", 0)) / 1e3
            continue              # a range, not a device entry of its own
        if e.device_type != DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        name = e.key.lower()
        if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass",
                                   "sm90_")):
            kinds["matmuls"] += ms
        elif "copy" in name or "memcpy" in name or "memset" in name:
            kinds["casts_and_copies"] += ms
        else:
            kinds["other"] += ms
        n_entries += e.count
        rows.append({"name": e.key[:80], "calls": e.count, "device_ms": ms})
    busy = sum(kinds.values())
    # the update launches elementwise kernels only ("other")
    kinds["other"] -= update_ms
    kinds["optimizer_update"] = update_ms
    return {"what": "one step, donate=True", "wall_ms": wall_ms,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms if busy else None,
            "device_entries": n_entries, "by_kind_ms": kinds,
            "top": sorted(rows, key=lambda r: -r["device_ms"])[:8]}, \
        params, opt_state


def train_full(device) -> dict:
    """deepseek-7b, published widths, 12 layers: the step-0 checks, then
    ``run_training`` (donate) for ``TRAIN_STEPS`` steps, one profiled
    step, and one step with ``remat_policy="dots"``."""
    import dataclasses
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.launch.train import run_training
    from repro_torch.models import init_params
    from repro_torch.runtime import optim as O
    from repro_torch.runtime.steps import loss_and_grads, make_train_step
    cfg = train_config()
    work = train_step_work(cfg, TRAIN_BATCH, TRAIN_SEQ)
    assert work["params"] == TRAIN_PARAMS, work["params"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device).manual_seed(SEED),
                         device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    dc = DataConfig(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab)
    corpus = SyntheticCorpus(dc)
    batch = corpus.batch(0)
    batch["tokens"] = batch["tokens"].to(device)
    # step 0, bfloat16 against float32, before any optimizer state
    loss_bf, g_bf = loss_and_grads(cfg, params, batch)
    again = loss_and_grads(cfg, params, batch)
    same_tree_bits(again, (loss_bf, g_bf), "step 0 twice")
    del again
    with compute_dtype(torch.float32):
        loss_f, g_f = loss_and_grads(cfg, params, batch)
    cos = leaf_cosines(g_bf, g_f)
    check_peak = torch.cuda.max_memory_allocated(device)
    del g_bf, g_f
    loss_rel = abs(float(loss_bf) - float(loss_f)) / abs(float(loss_f))
    worst = min(cos, key=lambda c: c[1])
    failures = []
    if loss_rel > TRAIN_BF16_LOSS_REL:
        failures.append(f"step-0 loss bf16 {float(loss_bf)} vs float32 "
                        f"{float(loss_f)}: {loss_rel}")
    if worst[1] < TRAIN_BF16_COSINE:
        failures.append(f"step-0 grad cosine {worst}")
    # the run: the reference CLI's optimizer, in place
    oc = O.OptConfig(lr=3e-4, total_steps=max(TRAIN_STEPS, 10),
                     warmup_steps=max(2, TRAIN_STEPS // 20))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    recs = []
    for rec in run_training(cfg, oc, dc, steps=TRAIN_STEPS, corpus=corpus,
                            params=params, donate=True):
        recs.append({k: rec[k] for k in ("step", "loss", "grad_norm", "lr",
                                         "wall_s")})
        opt_state = rec["opt_state"]
    peak = torch.cuda.max_memory_allocated(device)
    losses = [r["loss"] for r in recs]
    if not all(np.isfinite(losses)):
        failures.append(f"losses not finite: {losses}")
    walls = [r["wall_s"] for r in recs]
    ms = statistics.median(walls[1:]) * 1e3
    step_fn = make_train_step(cfg, oc, donate=True)
    nxt = corpus.batch(TRAIN_STEPS)
    nxt["tokens"] = nxt["tokens"].to(device)
    prof, params, opt_state = train_profile(step_fn, params, opt_state, nxt)
    # remat_policy="dots": two steps (the first pays the policy's set-up),
    # their own peak
    dots = make_train_step(dataclasses.replace(cfg, remat_policy="dots"),
                           oc, donate=True)
    torch.cuda.reset_peak_memory_stats(device)
    dots_ms, dots_loss = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        params, opt_state, m = dots(params, opt_state, nxt)
        dots_loss.append(float(m["loss"]))
        dots_ms.append((time.perf_counter() - t0) * 1e3)
    dots_peak = torch.cuda.max_memory_allocated(device)
    out = {"arch": TRAIN_ARCH, "layers": TRAIN_LAYERS,
           "params": work["params"], "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "remat_policy": "full",
           "init_s": t_init, "ms_per_step": ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
           "first_step_ms": walls[0] * 1e3,
           "max_memory_allocated_gb": peak / 1e9,
           "step0_checks_max_memory_allocated_gb": check_peak / 1e9,
           "trace": recs, "work": work,
           "step0": {"loss_bf16": float(loss_bf), "loss_f32": float(loss_f),
                     "loss_rel": loss_rel, "bound": TRAIN_BF16_LOSS_REL,
                     "min_grad_cosine": worst[1], "min_at": worst[0],
                     "cosine_bound": TRAIN_BF16_COSINE},
           "profile": prof,
           "step0_repeat_bit_for_bit": True,
           "dots": {"step_ms": dots_ms, "loss": dots_loss,
                    "max_memory_allocated_gb": dots_peak / 1e9},
           "failures": failures}
    emit({"phase": "train_full", **out})
    del params, opt_state, recs, step_fn
    torch.cuda.empty_cache()
    return out


def train_smoke(device) -> list:
    """The ten smoke configs: one step's loss and gradients on the card
    against the port's CPU path, float32 mode (TF32 off), the same
    ``numpy_params`` weights and tokens."""
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import numpy_params, params_from_numpy
    from repro_torch.models.blocks import tree_leaves_with_path
    from repro_torch.runtime.steps import decorate_batch, loss_and_grads
    rows = []
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        tree = numpy_params(cfg, SEED)
        tokens = torch.from_numpy(np.random.RandomState(1).randint(
            0, cfg.vocab, (2, 33)).astype(np.int32))
        dc = DataConfig(2, 32, cfg.vocab)
        out = {}
        with compute_dtype(torch.float32):
            for dev in ("cpu", device):
                params = params_from_numpy(cfg, tree, dev)
                batch = decorate_batch(cfg, dc, {"tokens": tokens.to(dev)})
                out[str(dev)] = loss_and_grads(cfg, params, batch)
            torch.cuda.synchronize()
        (lc, gc), (lg, gg) = out["cpu"], out[str(device)]
        loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
        errs = [(path, rel_max(g, c)) for (path, g), (_, c) in zip(
            tree_leaves_with_path(gg), tree_leaves_with_path(gc))]
        worst = max(errs, key=lambda e: e[1])
        assert loss_rel <= SMOKE_F32_REL, f"{arch} train loss: {loss_rel}"
        assert worst[1] <= SMOKE_F32_REL, f"{arch} grad {worst}"
        rows.append({"arch": arch, "loss_rel": loss_rel,
                     "grad_rel_max": worst[1], "grad_rel_max_at": worst[0],
                     "leaves": len(errs)})
    return rows


def same_tree_bits(a, b, what) -> None:
    from repro_torch.models.blocks import tree_leaves_with_path
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, path)
        if not torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"{what}{path}: bits differ")


def train_tenant(kernels, names, device, oracle):
    """A ``TrainingTenant`` on a CUDA ``OverlayServer`` with latency
    requests of the serve trace between its rounds; against a standalone
    ``run_training`` on the card (default stream), bit for bit, and every
    request against the serve phase's oracles.  Then the same beats with
    no tenant: serving latency with and without training.  Returns the
    report and the TMFU launch counts of the co-scheduled drive."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.tmfu import kernel as tk
    from repro_torch.launch.serve import OverlayServer
    from repro_torch.launch.train import run_training
    from repro_torch.launch.trainer_tenant import TrainingTenant
    from repro_torch.runtime import optim as O
    from repro_torch.telemetry import check_stats
    cfg = get_smoke_config(TRAIN_ARCH)
    oc = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    dc = DataConfig(2, 32, cfg.vocab)
    alone = list(run_training(cfg, oc, dc, steps=TENANT_STEPS,
                              device=device))
    trace = make_trace(kernels, names, N_REQUESTS, LANES, N_TENANTS)

    def drive(with_tenant, n_beats=None):
        srv = OverlayServer(bank_capacity=TENANT_BANK, tile=TILE,
                            device=device)
        tenant = (TrainingTenant(srv, cfg, oc, dc, steps=TENANT_STEPS,
                                 yield_every=TENANT_YIELD)
                  if with_tenant else None)
        beats, i = 0, 0
        while (not tenant.done) if tenant else beats < n_beats:
            tickets = []
            for _ in range(TENANT_PER_BEAT):
                k, xs, _ = trace[i % len(trace)]
                tickets.append((i % len(trace),
                                srv.submit(k, xs, tenant="alice")))
                i += 1
            if tenant:
                tenant.tick()
            res = srv.flush()
            for idx, t in tickets:
                assert t in res, f"beat {beats}: request {idx} starved"
                outs = host_outputs(res[t])
                same_outputs(outs, oracle["flush_sync"][idx],
                             f"co-scheduled, request {idx} vs flush_sync")
                same_outputs(outs, oracle["plain"][idx],
                             f"co-scheduled, request {idx} vs plain")
            beats += 1
            assert beats < 64, "the co-scheduled run did not finish"
        check_stats("engine", srv.stats())
        return srv, tenant, beats, i

    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv, tenant, beats, n_req = drive(True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(tk.launch_counts)          # read right behind the main path
    assert (tenant.stream is not None) == (device.type == "cuda")
    assert tenant.losses == [r["loss"] for r in alone], "loss trace differs"
    same_tree_bits(tenant.params, alone[-1]["params"], "tenant params")
    same_tree_bits(tenant.opt_state, alone[-1]["opt_state"],
                   "tenant opt_state")
    st = tenant.stats()
    check_stats("train", st)
    with_lat = srv.tenant_latency_percentiles()["alice"]
    t0 = time.perf_counter()
    ded, _, _, _ = drive(False, beats)
    torch.cuda.synchronize()
    ded_wall = time.perf_counter() - t0
    ded_lat = ded.tenant_latency_percentiles()["alice"]
    return {"arch": cfg.name, "steps": TENANT_STEPS,
            "yield_every": TENANT_YIELD, "bank": TENANT_BANK,
            "beats": beats, "requests": n_req,
            "requests_per_beat": TENANT_PER_BEAT, "lanes": LANES,
            "bit_equal_to_standalone": True, "losses": tenant.losses,
            "tenant_stats": st, "wall_s": wall,
            "dedicated_wall_s": ded_wall,
            "latency_ms": {"with_training": {k: with_lat[k] * 1e3
                                             for k in ("p50", "p99")},
                           "dedicated": {k: ded_lat[k] * 1e3
                                         for k in ("p50", "p99")}}}, counts


#: the train CLI with checkpoints, a simulated failure, the re-mesh and
#: the restore (deepseek-7b smoke)
CLI_ARGS = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "8",
            "--ckpt-every", "4", "--simulate-failure-at", "6"]
#: what starts the CLI: one process (a one-rank group), or torchrun
ONE_PROCESS = []
TORCHRUN_ONE_RANK = ["-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "1"]


def train_cli(launcher) -> dict:
    """The CLI in a subprocess (``launcher``: ``ONE_PROCESS`` or
    ``TORCHRUN_ONE_RANK``): checkpoints every 4 steps, a simulated failure
    before step 6, the re-mesh and restore, and the end."""
    import tempfile
    with tempfile.TemporaryDirectory() as ck:
        cmd = [sys.executable, *launcher, "-m", "repro_torch.launch.train",
               *CLI_ARGS, "--ckpt-dir", ck]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600, cwd=str(ROOT),
                              env={**os.environ,
                                   "PYTHONPATH": str(ROOT / "src")})
        seconds = time.perf_counter() - t0
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(ck)
                       if d.startswith("step_"))
    out = proc.stdout.strip().splitlines()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    elastic = [line for line in out if line.startswith("[elastic]")]
    assert any(e.startswith("[elastic] simulating failure")
               for e in elastic), proc.stdout
    assert any(e.startswith("[elastic] re-meshed onto")
               for e in elastic), proc.stdout
    assert out and out[-1].startswith("done:"), proc.stdout
    assert steps == [4, 8], steps
    return {"cmd": " ".join(["python", *launcher, "-m",
                             "repro_torch.launch.train", *CLI_ARGS]),
            "seconds": seconds, "mesh_line": out[0], "elastic": elastic,
            "done": out[-1], "checkpoints": steps}


def phase_train(kernels, names, device, oracle) -> dict:
    """The training path (``runtime/optim.py``, ``compress.py``,
    ``steps.make_train_step``, ``data/``, ``distributed/checkpoint.py``,
    ``launch/train.py``, ``launch/trainer_tenant.py``).  Returns the TMFU
    launch counts of the co-scheduled drive (K3 on every latency round),
    and the full-width run's report (its trace is the ``mesh`` phase's
    reference)."""
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    t0 = time.perf_counter()
    full = train_full(device)
    assert not full["failures"], full["failures"]
    smoke = train_smoke(device)
    cosched, counts = train_tenant(kernels, names, device, oracle)
    if counts["tmfu_multi_inplace"] <= 0:
        raise AssertionError("the co-scheduled rounds launched no K3")
    cli = train_cli(ONE_PROCESS)
    emit({"phase": "train", "seconds": time.perf_counter() - t0,
          "full": {k: full[k] for k in ("ms_per_step", "tokens_per_s",
                                        "max_memory_allocated_gb")},
          "smoke": smoke, "cosched": cosched, "cli": cli,
          "launches": counts,
          "tolerances": {"step0_loss_rel": TRAIN_BF16_LOSS_REL,
                         "step0_grad_cosine": TRAIN_BF16_COSINE,
                         "smoke_float32_rel_max": SMOKE_F32_REL,
                         "cosched_vs_standalone": "bit-exact"}})
    return counts, full


# ------------------------------------------------------ multi-device path
#: steps of the full-width cell on the one-rank mesh, held bit for bit
#: against the ``train`` phase's first steps
MESH_STEPS = 3


def mesh_full(device, unsharded) -> dict:
    """The ``train`` phase's cell on a (1, 1) ``DeviceMesh`` of a one-rank
    NCCL group: state wrapped as DTensors with no copy, ``MESH_STEPS``
    steps of ``run_training``; losses and grad norms bit-equal to the
    unsharded run's.  Then one profiled step and the step's parts timed
    on DTensors and on plain tensors (``mesh_step_parts``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.distributed.elastic import remesh, reshard_tree
    from repro_torch.launch.train import run_training
    from repro_torch.models import init_params
    from repro_torch.models.blocks import tree_leaves
    from repro_torch.runtime import optim as O
    from repro_torch.runtime import sharding as S
    from repro_torch.runtime.steps import make_train_step
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=device)
    try:
        mesh = remesh([0], model_parallel=1, device_type="cuda")
        cfg = train_config()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        plain = init_params(cfg, torch.Generator(device).manual_seed(SEED),
                            device=device)
        ptrs = [x.data_ptr() for x in tree_leaves(plain)]
        spec = S.sanitize(S.param_shardings(cfg, mesh), plain, mesh)
        params = reshard_tree(plain, spec, mesh)
        del plain
        no_copy = [x.to_local().data_ptr() for x in tree_leaves(params)] \
            == ptrs
        assert no_copy, "reshard_tree copied a leaf on a one-rank mesh"
        opt_state = O.init_opt(params)
        oc = O.OptConfig(lr=3e-4, total_steps=max(TRAIN_STEPS, 10),
                         warmup_steps=max(2, TRAIN_STEPS // 20))
        dc = DataConfig(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab)
        step = make_train_step(cfg, oc, donate=True)
        bspec = S.batch_shardings(cfg, mesh, TRAIN_BATCH, "train")

        def placed(params, opt_state, batch):
            return step(params, opt_state, reshard_tree(
                batch, {k: bspec[k] for k in batch}, mesh))

        recs = []
        for rec in run_training(cfg, oc, dc, steps=MESH_STEPS,
                                corpus=SyntheticCorpus(dc), params=params,
                                opt_state=opt_state, donate=True,
                                step_fn=placed):
            recs.append({k: rec[k] for k in ("step", "loss", "grad_norm",
                                             "wall_s")})
            dtensors = all(isinstance(x, DTensor)
                           for x in tree_leaves(rec["params"]))
        peak = torch.cuda.max_memory_allocated(device)
        params, opt_state = rec["params"], rec["opt_state"]
        del rec
        batch = SyntheticCorpus(dc).batch(MESH_STEPS)
        batch["tokens"] = batch["tokens"].to(device)
        profiled, params, opt_state = train_profile(placed, params,
                                                    opt_state, batch)
        parts = mesh_step_parts(cfg, oc, params, opt_state, batch,
                                lambda b: reshard_tree(
                                    b, {k: bspec[k] for k in b}, mesh))
        del params, opt_state
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    want = [(r["loss"], r["grad_norm"]) for r in unsharded["trace"]]
    got = [(r["loss"], r["grad_norm"]) for r in recs]
    assert dtensors, "the state left the mesh"
    assert got == want[:MESH_STEPS], (got, want[:MESH_STEPS])
    walls = [r["wall_s"] for r in recs]
    ms = statistics.median(walls[1:]) * 1e3
    return {"arch": TRAIN_ARCH, "layers": TRAIN_LAYERS,
            "mesh": S.mesh_axes(mesh), "steps": MESH_STEPS,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "reshard_no_copy": no_copy, "trace": recs,
            "bit_equal_to_unsharded": True, "ms_per_step": ms,
            "first_step_ms": walls[0] * 1e3,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
            "max_memory_allocated_gb": peak / 1e9,
            "profile": profiled, "parts_ms": parts,
            "unsharded": {k: unsharded[k] for k in (
                "ms_per_step", "max_memory_allocated_gb")}}


def mesh_step_parts(cfg, oc, params, opt_state, batch, place) -> dict:
    """Where a step on the mesh spends its time: the batch's placement,
    the loss and gradients (forward, backward, the gradients' placement
    check), and the in-place AdamW update, each timed with the card
    synchronised around it — on the DTensor state, and on the same
    storage as plain tensors (each rank's ``to_local()``: the whole leaf
    on a one-rank mesh).  Two rounds; the second is kept."""
    from repro_torch.models.blocks import tree_map
    from repro_torch.runtime import optim as O
    from repro_torch.runtime.steps import loss_and_grads

    def local(tree):
        return tree_map(lambda x: x.to_local(), tree)

    def timed(params, opt_state, batch, place):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        if place is not None:
            batch = place(batch)
        mark()
        loss, grads = loss_and_grads(cfg, params, batch)
        float(loss)
        mark()
        O.adamw_update_(oc, grads, opt_state, params)
        mark()
        del grads
        names = ("place_batch", "loss_and_grads", "update")
        return {k: (b - a) * 1e3 for k, a, b in zip(names, marks, marks[1:])}

    plain = (local(params), {"m": local(opt_state["m"]),
                             "v": local(opt_state["v"]),
                             "count": opt_state["count"]})
    out = {}
    for _ in range(2):
        out["dtensor"] = timed(params, opt_state, batch, place)
        out["plain"] = timed(*plain, batch, None)
    return out


def phase_mesh(device, unsharded) -> dict:
    """The multi-device path (``runtime/sharding.py``,
    ``distributed/elastic.py``, ``launch/mesh.py``, ``restore(shardings=)``,
    the CLI's re-mesh) on a one-rank mesh.  Returns the TMFU launch counts
    of the drive (none) and the full-width run's report."""
    from repro_torch.kernels.tmfu import kernel as tk
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    t0 = time.perf_counter()
    tk.reset_launch_counts()
    full = mesh_full(device, unsharded)
    counts = dict(tk.launch_counts)          # read right behind the main path
    cli = train_cli(TORCHRUN_ONE_RANK)
    emit({"phase": "mesh", "seconds": time.perf_counter() - t0,
          "full": full, "cli": cli, "launches": counts,
          "tolerances": {"vs_unsharded": "bit-exact losses and grad norms"}})
    return counts, full


#: the four port examples: (script, arguments, timeout s)
EXAMPLES = (("quickstart_torch.py", [], 300),
            ("overlay_pipeline_torch.py", [], 300),
            ("serve_batch_torch.py", [], 300),
            ("train_e2e_torch.py", ["--preset", "100m"], 600))


def run_example(script, args, timeout) -> tuple[list, dict]:
    import tempfile
    with tempfile.TemporaryDirectory() as ck:
        if script.startswith("train_e2e"):
            args = args + ["--ckpt-dir", ck]
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                               *args], capture_output=True, text=True,
                              timeout=timeout, cwd=str(ROOT),
                              env={**os.environ,
                                   "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, f"{script}: {proc.stdout}{proc.stderr}"
    lines = proc.stdout.strip().splitlines()
    report = json.loads(lines[-1])
    if "device" in report:
        assert report["device"].startswith("cuda"), report
    return lines[:-1], report


def phase_examples() -> dict:
    """The four ``examples/*_torch.py`` on the card, each in a subprocess.
    Returns their TMFU launch counts, summed (each example sets its
    counters to 0 before its drive and reports them after it)."""
    t0 = time.perf_counter()
    reports, counts = {}, {}
    for script, args, timeout in EXAMPLES:
        t1 = time.perf_counter()
        lines, rep = run_example(script, args, timeout)
        rep["seconds"] = time.perf_counter() - t1
        for k, v in rep["launches"].items():
            counts[k] = counts.get(k, 0) + v
        if script.startswith("serve_batch"):
            rep["printed"] = [ln for ln in lines if ln.startswith(
                ("prefill", "decode"))]
        if script.startswith("train_e2e"):
            rep["verdict"] = lines[-1]
        reports[rep.pop("example")] = rep
    q, o, t = (reports[k] for k in ("quickstart", "overlay_pipeline",
                                    "train_e2e"))
    assert q["max_err"] == 0.0, q
    assert q["launches"]["tmfu_single"] >= 1, q
    assert set(o["max_err"].values()) == {0.0}, o
    assert o["launches"]["tmfu_single"] >= len(o["max_err"]), o
    assert "LEARNING" in t["verdict"], t
    emit({"phase": "examples", "seconds": time.perf_counter() - t0,
          "examples": reports, "launches": counts})
    return counts


# ------------------------------------------------------ the pipeline ring
#: deepseek-7b at its published widths and full depth (30 layers) over five
#: stages of six; M microbatches of 1 x PIPE_SEQ tokens, bfloat16 hidden
#: states
PIPE_ARCH, PIPE_STAGES, PIPE_M, PIPE_SEQ = "deepseek-7b", 5, 8, 128


def pipe_stage_cfg():
    """deepseek-7b's config with one stage's six layers: (cfg, stack)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(PIPE_ARCH)
    (stack,) = cfg.stacks
    assert stack.count % PIPE_STAGES == 0, stack.count
    stack = dataclasses.replace(stack, count=stack.count // PIPE_STAGES)
    return dataclasses.replace(cfg, stacks=(stack,)), stack


def pipe_stage_params(s, device):
    """Stage ``s``'s six layers, drawn on the card from seed SEED + 100 + s:
    the stack's tree, leaves [6, ...]."""
    from repro_torch.models.blocks import init_stack
    from repro_torch.models.layers import Init
    cfg, stack = pipe_stage_cfg()
    g = torch.Generator(device).manual_seed(SEED + 100 + s)
    return init_stack(Init.torch(g, device), cfg, stack)


def pipe_stage_fn(p, h):
    """One stage: its six decoder layers through ``blocks.block_apply``.
    ``p``: the stack's tree with leaves [6, ...]."""
    from repro_torch.models.blocks import block_apply, tree_map
    cfg, stack = pipe_stage_cfg()
    (spec,) = stack.blocks
    pos = torch.arange(h.shape[1], device=h.device)[None].expand(
        h.shape[:2])
    with torch.no_grad():
        for i in range(stack.count):
            h, _ = block_apply(cfg, spec, tree_map(lambda x: x[i], p[0]), h,
                               pos)
    return h


class TimedStage:
    """``pipe_stage_fn`` timed from outside the ring: each call's compute
    (the device synchronised before and after it), the slot (one call's
    start to the next's) and the link (one call's end to the next's
    start: the hop and the slot's bookkeeping).  ``end`` is the last
    call's end, from which the caller times the ring's tail: the last
    hop and the final all-reduce."""

    def __init__(self, device):
        self.device = device
        self.compute_ms, self.slot_ms, self.link_ms = [], [], []
        self.start = self.end = None

    def __call__(self, p, h):
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        if self.end is not None:
            self.slot_ms.append((t0 - self.start) * 1e3)
            self.link_ms.append((t0 - self.end) * 1e3)
        out = pipe_stage_fn(p, h)
        torch.cuda.synchronize(self.device)
        self.start, self.end = t0, time.perf_counter()
        self.compute_ms.append((self.end - t0) * 1e3)
        return out

    def report(self, returned: float) -> dict:
        """The timings, the tail measured up to ``returned`` (the ring's
        return, the device synchronised)."""
        return {"compute_ms": self.compute_ms, "slot_ms": self.slot_ms,
                "link_ms": self.link_ms,
                "tail_ms": (returned - self.end) * 1e3}


def pipe_microbatches(device):
    g = torch.Generator(device).manual_seed(SEED + 7)
    cfg, _ = pipe_stage_cfg()
    return torch.randn((PIPE_M, 1, PIPE_SEQ, cfg.d_model), generator=g,
                       device=device).to(torch.bfloat16)


def pipeline_rank(rank, port, outdir):
    """One of the PIPE_STAGES gloo ranks on the card (``mp.spawn``): its
    stage's params, the ring, what it returned and what it measured."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.kernels.tmfu import kernel as tk
    from repro_torch.models.blocks import tree_map
    from repro_torch.runtime import pipeline as P
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=PIPE_STAGES)
    try:
        mesh = DeviceMesh("cuda", list(range(PIPE_STAGES)),
                          mesh_dim_names=("stage",))
        own = pipe_stage_params(rank, device)
        params = tree_map(lambda x: DTensor.from_local(
            x[None], mesh, [Shard(0)], run_check=False), own)
        x = pipe_microbatches(device)
        torch.cuda.synchronize()
        dist.barrier()
        tk.reset_launch_counts()
        P.reset_link_counts()
        timed = TimedStage(device)
        t0 = time.perf_counter()
        y = P.pipeline_apply(mesh, timed, params, x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.save({"y": y.cpu(), "stats": timed.report(t1),
                    "wall_s": t1 - t0,
                    "link": dict(P.link_counts),
                    "launches": dict(tk.launch_counts),
                    "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9},
                   os.path.join(outdir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def pipeline_full(device) -> dict:
    """deepseek-7b's 30 layers as five gloo ranks of six layers on the
    card (host-staged link), every rank's ``y`` against
    ``pipeline_reference`` of the whole model in this process, bit for bit;
    then the S = 1 ring on a one-rank NCCL group."""
    import socket
    import tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.kernels.tmfu import kernel as tk
    from repro_torch.models.blocks import tree_map, tree_stack
    from repro_torch.runtime import pipeline as P
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        mp.spawn(pipeline_rank, args=(port, out), nprocs=PIPE_STAGES,
                 join=True)
        ring_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"))
                 for r in range(PIPE_STAGES)]
    tk.reset_launch_counts()
    counts = dict(tk.launch_counts)
    for r in ranks:
        for k, v in r["launches"].items():
            counts[k] += v
    torch.cuda.reset_peak_memory_stats(device)
    x = pipe_microbatches(device)
    whole = tree_stack([pipe_stage_params(s, device)
                        for s in range(PIPE_STAGES)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = P.pipeline_reference(pipe_stage_fn, whole, x)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_peak = torch.cuda.max_memory_allocated(device) / 1e9
    ref_cpu = ref.cpu()
    for r, got in enumerate(ranks):
        assert torch.equal(got["y"], ref_cpu), \
            f"rank {r}: max |y - ref| {(got['y'].float() - ref_cpu.float()).abs().max()}"
        assert got["link"]["staged_hops"] == PIPE_M + PIPE_STAGES - 1 \
            and got["link"]["staged_reduces"] == 1, got["link"]
    # S = 1 on a one-rank NCCL group: no send, the final all-reduce on NCCL
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=device)
    try:
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("stage",))
        one = tree_map(lambda w: w[:1], whole)
        P.reset_link_counts()
        timed1 = TimedStage(device)
        y1 = P.pipeline_apply(mesh, timed1, one, x)
        torch.cuda.synchronize()
        stats1 = timed1.report(time.perf_counter())
        link1 = dict(P.link_counts)
        ref1 = P.pipeline_reference(pipe_stage_fn, one, x)
        assert torch.equal(y1, ref1), "S = 1 ring != its reference"
        assert link1["hops"] == 0 and link1["reduces"] == 1 \
            and link1["staged_reduces"] == 0, link1
    finally:
        dist.destroy_process_group()
    for k, v in tk.launch_counts.items():
        counts[k] += v
    del whole, one, ref, y1, ref1
    torch.cuda.empty_cache()
    cfg, stack = pipe_stage_cfg()
    per_rank = [{"slot_ms": r["stats"]["slot_ms"],
                 "compute_ms": r["stats"]["compute_ms"],
                 "link_ms": r["stats"]["link_ms"],
                 "tail_ms": r["stats"]["tail_ms"],
                 "wall_s": r["wall_s"], "peak_gb": r["peak_gb"],
                 "link": r["link"]} for r in ranks]
    hop_bytes = PIPE_SEQ * cfg.d_model * 2
    return {"arch": PIPE_ARCH, "stages": PIPE_STAGES,
            "layers_per_stage": stack.count, "microbatches": PIPE_M,
            "tokens_per_microbatch": PIPE_SEQ,
            "ii": P.pipeline_ii(PIPE_M, PIPE_STAGES),
            "bit_equal_to_reference": True, "ring_s": ring_s,
            "ms_per_slot_median": statistics.median(
                m for r in per_rank for m in r["slot_ms"]),
            "stage_compute_ms_median": statistics.median(
                m for r in per_rank for m in r["compute_ms"]),
            "link_ms_median": statistics.median(
                m for r in per_rank for m in r["link_ms"]),
            "bytes_per_hop": hop_bytes, "ranks": per_rank,
            "reference": {"seconds": ref_s, "peak_gb": ref_peak},
            "s1_nccl": {"bit_equal": True, "link": link1,
                        "slot_ms": stats1["slot_ms"],
                        "tail_ms": stats1["tail_ms"]},
            "launches": counts}


def phase_pipeline(device) -> dict:
    """The microbatch ring (``runtime/pipeline.py``): deepseek-7b over five
    gloo ranks on the card, the S = 1 NCCL ring, and
    ``examples/pipeline_lm_torch.py``.  Returns the TMFU launch counts
    (none)."""
    t0 = time.perf_counter()
    full = pipeline_full(device)
    counts = full.pop("launches")
    t1 = time.perf_counter()
    lines, ex = run_example("pipeline_lm_torch.py", [], 300)
    ex["seconds"] = time.perf_counter() - t1
    ex["printed"] = lines
    assert ex["max_err"] < 5e-4 and ex["every_rank_same_y"], ex
    assert ex["link"]["staged_hops"] == ex["ii"]["slots"], ex
    assert sum(ex["launches"].values()) == 0, ex
    for k, v in ex["launches"].items():
        counts[k] += v
    emit({"phase": "pipeline", "seconds": time.perf_counter() - t0,
          "full": full, "example": ex, "launches": counts,
          "tolerances": {"ring_vs_reference": "bit-exact, every rank",
                         "example_max_err": 5e-4}})
    return counts


# --------------------------------------------------------------- dry run
#: the estimator against this run's measurements: peak memory within 10 %,
#: FLOPs within 15 %
DRY_MEM_REL, DRY_FLOPS_REL = 0.10, 0.15
#: production cells traced by ``python -m repro_torch.launch.dryrun``
DRY_CELLS = (("deepseek-7b", "train_4k"), ("deepseek-7b", "prefill_32k"),
             ("qwen2-moe-a2.7b", "decode_32k"), ("mamba2-2.7b", "train_4k"),
             ("qwen2-moe-a2.7b", "train_4k"), ("mamba2-2.7b", "decode_32k"))
#: the reference's own cross-check of a train_4k cell
#: (``tests/test_dryrun_unit.py::test_analytic_vs_spatial_dryrun_crosscheck``):
#: analytic FLOPs a device over the traced ones, strictly inside
DRY_ANALYTIC_RATIO = (0.6, 1.7)
#: a train_4k cell's arguments a device against the sharding rule's
#: layout of params, m and v (12 B a param), relative
DRY_ARG_REL = 0.01
#: the reference's dry run of the same cells on the (16, 16) mesh
#: (``python -m repro.launch.dryrun --arch A --shape S --mesh single``,
#: jax 0.9.0 on a CPU host): its roofline terms in seconds under its
#: own constants (``src/repro/launch/dryrun.py``: 197e12 FLOP/s, 819e9
#: B/s, 50e9 B/s a link; the port's link is the same), wire bytes a
#: device, temp GB a device; None where the record was not kept
DRY_REFERENCE = {
    ("deepseek-7b", "train_4k"): {
        "t_compute_s": None, "t_memory_s": 2.14, "t_collective_s": 2.13,
        "collective_wire_bytes_per_device": None, "temp_gb": None},
    ("mamba2-2.7b", "train_4k"): {
        "t_compute_s": None, "t_memory_s": 3.35, "t_collective_s": 1.77,
        "collective_wire_bytes_per_device": 8.87e10, "temp_gb": 114},
    ("qwen2-moe-a2.7b", "train_4k"): {
        "t_compute_s": None, "t_memory_s": 5.23, "t_collective_s": 2.74,
        "collective_wire_bytes_per_device": 1.37e11, "temp_gb": None},
    ("mamba2-2.7b", "decode_32k"): {
        "t_compute_s": None, "t_memory_s": None, "t_collective_s": 0.85e-3,
        "collective_wire_bytes_per_device": 4.24e7, "temp_gb": 0.15},
}
#: the reference's HBM rate, to read its memory term as bytes
REF_HBM_BW = 819e9
#: a cell's wire bytes a device, at most this multiple of the reference's
#: record: mamba2-2.7b x train_4k's in-projection moves its heads'
#: columns alone (one all-to-all, counted by its busiest rank, and an
#: all-gather of B and C), not the whole of it
DRY_WIRE_OVER_REFERENCE = {("mamba2-2.7b", "train_4k"): 1.5}
#: the ``mamba_heads`` entry: mamba2-2.7b at its published widths with its
#: depth CUT to 2 of 64 layers (the script's time), float32, a batch of 4
#: rows of 256 tokens, on four gloo ranks of the host CPU as a (data 2,
#: model 2) mesh (one card holds one NCCL rank)
MH_ARCH, MH_LAYERS, MH_BATCH, MH_SEQ, MH_MESH = "mamba2-2.7b", 2, 4, 256, \
    (2, 2)
#: ``tests/test_torch_sharded_grads.py``'s bounds: the loss relative, each
#: gradient leaf against its largest magnitude
MH_LOSS_REL, MH_GRAD_REL = 1e-5, 1e-4
#: ``benchmarks/analytic.py``'s SSD chunk
SSD_CHUNK = 256


def block_flops(cfg, spec, ctx: float, s_q: int) -> float:
    """Forward FLOPs a query token of one block (whole model, before any
    split): a copy of the reference's closed form
    (``benchmarks/analytic.py::_per_block_flops``) — Mamba2's projections,
    conv and chunked SSD over the causal half of a chunk; attention's
    projections over ``ctx`` keys (the window's where it has one), the
    cross-attention's, and the gated MLP or the MoE's router, top-k experts
    and shared experts."""
    D = cfg.d_model
    if spec.kind == "mamba":
        d = cfg.ssm
        din, N, H, G = d.d_inner, d.d_state, d.n_heads, d.n_groups
        f = 2 * D * (2 * din + 2 * G * N + H)          # in_proj
        f += 2 * d.d_conv * (din + 2 * G * N)          # conv
        q_bar = min(SSD_CHUNK, max(s_q, 1)) / 2        # intra-chunk keys
        f += H * (2 * q_bar * (N + d.head_dim)         # scores + y_diag
                  + 4 * N * d.head_dim)                # states + y_off
        f += 2 * din * D                               # out_proj
        return f
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f = 2 * D * (H + 2 * KH) * hd + 2 * H * hd * D     # qkv + out proj
    win_ctx = min(ctx, spec.window) if spec.window else ctx
    f += 4 * H * hd * win_ctx                          # scores + AV
    if spec.cross:
        f += 2 * D * (H + 2 * KH) * hd + 2 * H * hd * D + 4 * H * hd * ctx
    if spec.moe:
        f += 2 * D * cfg.n_experts                     # router
        f += cfg.top_k * 6 * D * cfg.expert_d_ff
        if cfg.n_shared_experts:
            f += 6 * D * cfg.shared_expert_d_ff
    else:
        f += 6 * D * cfg.d_ff
    return f


def analytic_train_flops(cfg, seq: int, gbatch: int, chips: int) -> float:
    """FLOPs a device of a train step at ``gbatch`` x ``seq`` on ``chips``
    devices: a copy of the reference's closed form
    (``benchmarks/analytic.py``: ``cell_model(...).flops_dev``, remat
    "full") — every block's forward a token (``block_flops``, attention
    over the causal average of ``seq / 2`` keys) and the head, x (seq - 1)
    tokens a row x 4 (forward, recompute, backward twice)."""
    stacks = list(cfg.stacks) + (list(cfg.encoder.stacks)
                                 if cfg.encoder is not None else [])
    fwd = sum(st.count * block_flops(cfg, b, seq / 2, seq)
              for st in stacks for b in st.blocks) \
        + 2 * cfg.d_model * cfg.vocab
    return fwd * gbatch * (seq - 1) * 4 / chips


def rule_argument_bytes(cfg, axes: dict) -> float:
    """Arguments a device of a train step by the sharding rule alone: 12 B
    a param (params, m, v in float32), each leaf split as the sanitized
    ``param_shardings`` splits it over the mesh ``axes`` ({name: size}).
    The embedding is split over ``model`` alone, in the reference's rule
    too, and a vocab the axis does not divide is left whole."""
    from repro_torch.models import init_params
    from repro_torch.models.blocks import tree_leaves, tree_map
    from repro_torch.runtime import sharding as S
    mesh = (tuple(axes), tuple(axes.values()))
    shapes = init_params(cfg, device="meta")
    specs = S.sanitize(S.param_shardings(cfg, mesh), shapes, mesh)
    share = tree_map(lambda x, sp: x.numel() * 12 / math.prod(
        S._axis_size(e, axes) for e in sp), shapes, specs)
    return sum(tree_leaves(share))


def dry_train_checks(rec, arch: str) -> dict:
    """``arch`` x train_4k on the (16, 16) mesh against what does not come
    from the tracer: the analytic FLOPs (the reference's bound), and the
    arguments against the rule's layout (``rule_argument_bytes``)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import production_mesh_shape
    cfg = get_config(arch)
    seq, gbatch, _ = SHAPES["train_4k"]
    chips = rec["roofline"]["chips"]
    shape, names = production_mesh_shape(False)
    want_args = rule_argument_bytes(cfg, dict(zip(names, shape)))
    flops = rec["roofline"]["hlo_flops_per_device"]
    analytic = analytic_train_flops(cfg, seq, gbatch, chips)
    args = rec["memory"]["argument_size_in_bytes"]
    return {"analytic_over_traced": {
                "analytic": analytic, "traced": flops,
                "ratio": analytic / flops, "bounds": DRY_ANALYTIC_RATIO},
            "arguments": {"traced": args, "rule": want_args,
                          "rel": args / want_args - 1,
                          "bound": DRY_ARG_REL}}


def dry_train_cell(mesh) -> dict:
    """The estimator on the ``train`` phase's cell (plain tensors, or a
    mesh): peak (arguments + temp) and FLOPs."""
    from repro_torch.launch import dryrun as D
    cfg = train_config()
    batch = {"tokens": torch.empty((TRAIN_BATCH, TRAIN_SEQ),
                                   dtype=torch.int32, device="meta")}
    traced, _, t_trace = D.trace_step(cfg, batch, "train", TRAIN_SEQ,
                                      TRAIN_BATCH, mesh)
    mem = traced.memory_analysis()
    return {"peak_gb": (mem["argument_size_in_bytes"]
                        + mem["temp_size_in_bytes"]) / 1e9,
            "argument_gb": mem["argument_size_in_bytes"] / 1e9,
            "temp_gb": mem["temp_size_in_bytes"] / 1e9,
            "flops": traced.flops, "bytes_accessed": traced.bytes_accessed,
            "collectives": len(traced.collectives), "trace_s": t_trace}


def mamba_heads_config(layers: int = MH_LAYERS):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(MH_ARCH)
    (stack,) = cfg.stacks
    return dataclasses.replace(
        cfg, stacks=(dataclasses.replace(stack, count=layers),))


def mamba_heads_columns(dims, n: int) -> list:
    """``splits[s][d]``: the in-projection columns ``model`` rank s of
    ``n`` sends rank d (``s == d``: keeps) in one exchange of head
    columns, counted from the shapes: a rank's block is its ``ceil(width
    / n)`` contiguous columns; it gets its heads' z, x and dt, and the
    ``ceil(2GN / n)`` columns of B and C that are its piece of them (an
    all-gather then makes B and C whole on every rank)."""
    din, N, H, G, P = (dims.d_inner, dims.d_state, dims.n_heads,
                       dims.n_groups, dims.head_dim)
    width, bc = 2 * din + 2 * G * N + H, 2 * din
    step, piece = -(-width // n), -(-2 * G * N // n)
    blocks = [set(range(r * step, min((r + 1) * step, width)))
              for r in range(n)]
    wants = []
    for r in range(n):
        heads = range(r * H // n, (r + 1) * H // n)
        z = {c for h in heads for c in range(h * P, (h + 1) * P)}
        wants.append(z | {din + c for c in z}
                     | set(range(bc + r * piece,
                                 min(bc + (r + 1) * piece, bc + 2 * G * N)))
                     | {2 * din + 2 * G * N + h for h in heads})
    return [[len(wants[d] & blocks[s]) for d in range(n)] for s in range(n)]


def mamba_heads_rank(rank, port, outdir, layers):
    """One of the four gloo ranks of the ``mamba_heads`` entry, on the
    host CPU (``mp.spawn``): the sharded loss and gradients of
    ``mamba_heads_config`` on a (data 2, model 2) mesh, every exchange of
    head columns recorded (``layers._all_to_all``'s split matrix and row
    bytes); rank 0 then computes the plain step on the same values."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import repro_torch.models.layers as TL
    import repro_torch.models.model as TM
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.models import init_params
    from repro_torch.models.blocks import tree_leaves_with_path
    from repro_torch.runtime import sharding as S
    from repro_torch.runtime.steps import loss_and_grads
    world = MH_MESH[0] * MH_MESH[1]
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads // world, 1))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        TL.COMPUTE_DTYPE = TM.COMPUTE_DTYPE = torch.float32
        mesh = init_device_mesh("cpu", MH_MESH,
                                mesh_dim_names=("data", "model"))
        cfg = mamba_heads_config(layers)
        params = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
        whole = {"tokens": torch.randint(
            0, cfg.vocab, (MH_BATCH, MH_SEQ), dtype=torch.int32,
            generator=torch.Generator().manual_seed(SEED + 11))}
        placed = reshard_tree(params, S.sanitize(
            S.param_shardings(cfg, mesh), params, mesh), mesh)
        bspec = S.batch_shardings(cfg, mesh, MH_BATCH, "train")
        batch = reshard_tree(whole, {k: bspec[k] for k in whole}, mesh)
        calls, real = [], TL._all_to_all

        def recorded(t, splits, r, group):
            calls.append({"splits": splits.tolist(),
                          "row_bytes": t.shape[1] * t.element_size()})
            return real(t, splits, r, group)

        TL._all_to_all = recorded
        try:
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(cfg, placed, batch)
            sharded_s = time.perf_counter() - t0
        finally:
            TL._all_to_all = real
        got = [(path, TL.full_value(g))
               for path, g in tree_leaves_with_path(grads)]
        report = {"model_rank": mesh.get_local_rank("model"),
                  "calls": calls, "sharded_s": sharded_s}
        if rank == 0:
            torch.set_num_threads(threads)
            t0 = time.perf_counter()
            want_loss, want = loss_and_grads(cfg, params, whole)
            report["plain_s"] = time.perf_counter() - t0
            worst = (0.0, None)
            for (path, g), (_, w) in zip(got, tree_leaves_with_path(want)):
                den = float(w.abs().max()) or 1.0
                worst = max(worst, (float((g - w).abs().max()) / den,
                                    str(path)))
            report.update(loss=float(loss), plain_loss=float(want_loss),
                          grad_rel=worst[0], worst_leaf=worst[1])
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _moved(mats, r: int, row_bytes: int) -> tuple:
    """``(received, sent)``: the bytes rank ``r`` receives from the other
    ranks and sends them over the all-to-alls of split matrices
    ``mats``."""
    return (sum(m[s][r] for m in mats for s in range(len(m)) if s != r)
            * row_bytes,
            sum(m[r][d] for m in mats for d in range(len(m)) if d != r)
            * row_bytes)


def mamba_heads(failures: list, layers: int = MH_LAYERS) -> dict:
    """The ``mamba_heads`` entry: ``mamba_heads_rank`` on four gloo ranks,
    the loss and every gradient leaf held to the plain step's
    (``MH_LOSS_REL``, ``MH_GRAD_REL``), and each rank's exchanges to the
    count from the shapes (``mamba_heads_columns``): at each layer the
    forward and its remat recompute receive the rank's missing columns
    and send the others theirs, and the gradient goes back the reverse
    way; every miss into ``failures``."""
    import socket
    import tempfile
    import torch.multiprocessing as mp
    cfg = mamba_heads_config(layers)
    world = MH_MESH[0] * MH_MESH[1]
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        mp.spawn(mamba_heads_rank, args=(port, out, layers), nprocs=world,
                 join=True)
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    seconds = time.perf_counter() - t0
    first = ranks[0]
    loss_rel = abs(first["loss"] / first["plain_loss"] - 1)
    if loss_rel > MH_LOSS_REL:
        failures.append(f"mamba_heads: loss {first['loss']} vs plain "
                        f"{first['plain_loss']} ({loss_rel:.2e})")
    if first["grad_rel"] > MH_GRAD_REL:
        failures.append(f"mamba_heads: gradient {first['worst_leaf']} off "
                        f"by {first['grad_rel']:.2e} of its largest")
    splits = mamba_heads_columns(cfg.ssm, MH_MESH[1])
    back = [list(col) for col in zip(*splits)]
    row_bytes = MH_BATCH // MH_MESH[0] * (MH_SEQ - 1) * 4
    exchanges = []
    for rep in ranks:
        r = rep["model_rank"]
        want = [splits] * (2 * layers) + [back] * layers
        seen = [c["splits"] for c in rep["calls"]]
        rows = {c["row_bytes"] for c in rep["calls"]}
        if sorted(seen) != sorted(want) or rows != {row_bytes}:
            failures.append(f"mamba_heads: model rank {r} exchanged "
                            f"{seen} columns of {rows} B rows; the shapes "
                            f"give {want} of {row_bytes} B")
        (got_in, got_out), (want_in, want_out) = \
            _moved(seen, r, row_bytes), _moved(want, r, row_bytes)
        exchanges.append({
            "model_rank": r, "calls": len(seen),
            "received_bytes": got_in, "sent_bytes": got_out,
            "expected_received_bytes": want_in,
            "expected_sent_bytes": want_out,
            "sharded_s": rep["sharded_s"]})
    from repro_torch.configs import get_config
    full = sum(st.count for st in get_config(MH_ARCH).stacks)
    return {"config": f"{MH_ARCH} at published widths, depth cut to "
                      f"{layers} of {full} layers",
            "mesh": list(MH_MESH), "ranks": "gloo on the host CPU",
            "batch": MH_BATCH, "seq": MH_SEQ, "dtype": "float32",
            "loss": first["loss"], "plain_loss": first["plain_loss"],
            "loss_rel": loss_rel, "grad_rel": first["grad_rel"],
            "worst_leaf": first["worst_leaf"],
            "bounds": {"loss_rel": MH_LOSS_REL, "grad_rel": MH_GRAD_REL},
            "plain_s": first["plain_s"], "exchanges": exchanges,
            "seconds": seconds}


def production_cells(checks: dict, failures: list) -> dict:
    """``DRY_CELLS`` through ``python -m repro_torch.launch.dryrun``, a
    subprocess a cell, all started together (tracing is host work, one
    core each): each cell's record beside the reference's; each train_4k
    cell's checks (``dry_train_checks``) into ``checks``, every miss into
    ``failures``."""
    import tempfile
    cells = {}
    with tempfile.TemporaryDirectory() as out:
        t1 = time.perf_counter()
        procs = {}
        for arch, shape in DRY_CELLS:
            log = open(os.path.join(out, f"{arch}_{shape}.log"), "w+")
            procs[arch, shape] = log, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", "single",
                 "--out", out], stdout=log, stderr=subprocess.STDOUT,
                text=True, cwd=str(ROOT),
                env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                     "OMP_NUM_THREADS": "1"})
        for (arch, shape), (log, proc) in procs.items():
            try:
                proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.seek(0)
            stdout = log.read()
            log.close()
            seconds = time.perf_counter() - t1
            path = os.path.join(out, f"{arch}_{shape}_single.json")
            rec = {"error": "no record"}
            if os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
            if proc.returncode != 0 or "error" in rec:
                failures.append(f"{arch} x {shape}: rc {proc.returncode} "
                                f"{rec.get('error')} {stdout[-2000:]}")
                continue
            roof = rec["roofline"]
            if shape == "train_4k":
                check = checks[f"{arch} x {shape}"] = \
                    dry_train_checks(rec, arch)
                lo, hi = DRY_ANALYTIC_RATIO
                ratio = check["analytic_over_traced"]["ratio"]
                rel = check["arguments"]["rel"]
                if not lo < ratio < hi:
                    failures.append(f"{arch} x train_4k analytic / traced "
                                    f"FLOPs {ratio:.3f} outside ({lo}, {hi})")
                if abs(rel) > DRY_ARG_REL:
                    failures.append(f"{arch} x train_4k arguments "
                                    f"{rel:+.4f} off the rule's layout")
            over = DRY_WIRE_OVER_REFERENCE.get((arch, shape))
            if over is not None:
                wire = roof["collective_wire_bytes_per_device"]
                bound = over * DRY_REFERENCE[arch, shape][
                    "collective_wire_bytes_per_device"]
                checks[f"{arch} x {shape} wire bytes"] = {
                    "traced": wire, "bound": bound}
                if wire > bound:
                    failures.append(f"{arch} x {shape} wire bytes a device "
                                    f"{wire:.4g} above {bound:.4g}")
            ref = DRY_REFERENCE.get((arch, shape))
            if ref is not None:
                ref = dict(ref, bytes_accessed=None if ref["t_memory_s"]
                           is None else ref["t_memory_s"] * REF_HBM_BW)
            cells[f"{arch} x {shape}"] = {
                "seconds": seconds,
                "printed": [ln for ln in stdout.splitlines()
                            if ln.startswith("[")],
                "t_compute_s": roof["t_compute_s"],
                "t_memory_s": roof["t_memory_s"],
                "t_collective_s": roof["t_collective_s"],
                "hlo_flops_per_device": roof["hlo_flops_per_device"],
                "hlo_bytes_per_device": roof["hlo_bytes_per_device"],
                "collective_wire_bytes_per_device":
                    roof["collective_wire_bytes_per_device"],
                "temp_gb": rec["memory"]["temp_size_in_bytes"] / 1e9,
                "bottleneck": roof["bottleneck"],
                "useful_flops_ratio": roof["useful_flops_ratio"],
                "reference": ref,
                "collectives": rec["collectives"], "memory": rec["memory"],
                "timing": rec["timing"]}
    return cells


def phase_dryrun(unsharded, meshed) -> dict:
    """The dry run (``launch/dryrun.py``): the estimator held against what
    this run measured (the ``train`` phase's peak and its step's FLOPs;
    the ``mesh`` phase's peak on a (1, 1) mesh), then the production
    cells of ``DRY_CELLS`` through the CLI, a subprocess each, every
    train_4k cell held to the analytic FLOPs and the rule's argument
    bytes, each cell beside the reference's record where there is one
    (``DRY_REFERENCE``), mamba2-2.7b x train_4k's wire bytes within
    ``DRY_WIRE_OVER_REFERENCE`` of it; then the ``mamba_heads`` entry
    (``mamba_heads``: four gloo ranks of the host, mamba2-2.7b's published
    widths, depth cut to ``MH_LAYERS``).  Host-side work: returns the TMFU
    launch counts (none)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.kernels.tmfu import kernel as tk
    from repro_torch.launch import dryrun as D
    t0 = time.perf_counter()
    tk.reset_launch_counts()
    failures = []
    work = train_step_work(train_config(), TRAIN_BATCH, TRAIN_SEQ)
    plain = dry_train_cell(None)
    D.fake_world(1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        on_mesh = dry_train_cell(mesh)
    finally:
        dist.destroy_process_group()
    checks = {}
    for name, est, want in (
            ("plain_peak", plain["peak_gb"],
             unsharded["max_memory_allocated_gb"]),
            ("plain_flops", plain["flops"], work["flops"]),
            ("mesh_peak", on_mesh["peak_gb"],
             meshed["max_memory_allocated_gb"])):
        rel = est / want - 1
        bound = DRY_FLOPS_REL if name.endswith("flops") else DRY_MEM_REL
        checks[name] = {"estimate": est, "measured": want, "rel": rel,
                        "bound": bound}
        if abs(rel) > bound:
            failures.append(f"{name}: estimate {est} vs {want} ({rel:+.3f})")
    cells = production_cells(checks, failures)
    heads = mamba_heads(failures)
    counts = dict(tk.launch_counts)
    emit({"phase": "dryrun", "seconds": time.perf_counter() - t0,
          "train_cell": {"plain": plain, "mesh_1x1": on_mesh,
                         "checks": checks,
                         "step_work_flops": work["flops"]},
          "cells": cells, "mamba_heads": heads, "failures": failures,
          "launches": counts})
    assert not failures, failures
    return counts


def phase_context_switch(kernels, names, device) -> None:
    """The paper's comparison on the card: ``Overlay.time_context_switch``
    (median of 20 loads, µs) for each benchmark kernel, beside
    ``time_recompile`` (a fresh ``torch.compile`` of the DFG: trace,
    inductor, a Triton kernel) for two of them."""
    from repro_torch.core.overlay import Overlay, time_recompile
    t0 = time.perf_counter()
    ov = Overlay(device=device)
    switch = {n: ov.time_context_switch(kernels[n], iters=20) * 1e6
              for n in names}
    rng = np.random.RandomState(SEED)
    recompile = {}
    for n in ("chebyshev", "poly6"):
        k = kernels[n]
        xs = [torch.from_numpy(rng.uniform(-2, 2, LANES).astype(np.float32))
              .to(device) for _ in k.dfg.inputs]
        recompile[n] = time_recompile(k.dfg, xs, iters=2)
    emit({"phase": "context_switch", "seconds": time.perf_counter() - t0,
          "context_switch_us": switch,
          "recompile_s": recompile,
          "ratio": {n: recompile[n] / (switch[n] * 1e-6) for n in recompile}})


def phase_profile(kernels, names, device) -> None:
    """``--profile`` only: one warm pipelined ``flush`` of the serving trace
    under ``torch.profiler``; device time by kernel name and the share of
    the drain's wall time in which the device ran nothing."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import OverlayServer
    trace = make_trace(kernels, names, N_REQUESTS, LANES, N_TENANTS)
    srv = OverlayServer(bank_capacity=4, tile=TILE, round_kernels=2,
                        quantum_tiles=1024, device=device)
    for k, xs, t in trace:
        srv.submit(k, xs, tenant=t)
    srv.flush()                                   # warm: arena, bank, allocator
    for k, xs, t in trace:
        srv.submit(k, xs, tenant=t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.flush()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, memcpys): the host-side op that
    # launched one reports the same device time again
    rows = device_time_by_kernel(prof)
    busy_ms = sum(r["device_ms"] for r in rows)
    emit({"phase": "profile", "what": "one warm flush, bank_capacity=4",
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": (1 - busy_ms / wall_ms) if rows else None,
          "by_device_time": rows[:10]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from repro_torch.core.overlay import compile_program
    from repro_torch.core.paper_bench import BENCH_NAMES, benchmark
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()

    smi_line = phase_env(device)
    phase_build()
    names = list(BENCH_NAMES) + ["gradient"]
    kernels = {n: compile_program(benchmark(n)) for n in names}
    records = phase_kernels(kernels, names, device)
    phase_timing(kernels, names, device)
    phase_attn_decode(device)
    ssm_records = phase_ssm_decode(device)
    counts, oracle = phase_serve(kernels, names, device)
    by_path = {"serve": counts,
               "fleet": phase_fleet(kernels, names, device, oracle)}
    by_path["edge"] = phase_edge(kernels, names, device, oracle)
    by_path["lm"], ssm_lm = phase_lm(device)
    by_path["train"], unsharded = phase_train(kernels, names, device, oracle)
    by_path["mesh"], meshed = phase_mesh(device, unsharded)
    by_path["examples"] = phase_examples()
    by_path["pipeline"] = phase_pipeline(device)
    by_path["dryrun"] = phase_dryrun(unsharded, meshed)
    del unsharded, meshed
    phase_context_switch(kernels, names, device)
    for name, rec in records.items():
        rec["launches"] = sum(c[name] for c in by_path.values())
        rec["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
    for rec in ssm_records:
        rec["launches"] = ssm_lm[rec["name"]]
        rec["launches_by_path"] = {"lm": ssm_lm[rec["name"]]}
    torch.cuda.synchronize()
    if "--profile" in sys.argv[1:]:
        phase_profile(kernels, names, device)

    emit({"kernels": list(records.values()) + ssm_records})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
