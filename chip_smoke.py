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
3. kernel checks: every hand-written kernel (``tmfu_multi``,
               ``tmfu_multi_inplace``, ``tmfu_single``) against its plain
               PyTorch version on the card — float32, bfloat16, int32; the
               nine benchmark contexts plus an all-opcodes context on
               special values; G in {1, 8, 2048} tiles of 128 lanes and
               batches of {128, 777 -> 1024, 32768, 65536} lanes.  float32
               and int32 are compared bit for bit (NaN by position), and
               so is bfloat16.  Then the timings (CUDA events, median).
4. ``serve``   ``OverlayServer`` with bank capacities 4 and 8: nine
               kernels, four tenants, 72 requests of 32 768 lanes; ``flush``,
               ``as_completed`` and ``flush_sync`` agree bit for bit with
               each other, with ``Overlay.dispatch``, and with the plain
               executor; every request agrees with ``dfg_eval`` on the CPU
               to rtol = atol = 1e-5.  One ``Overlay.__call__`` per kernel.
               The kernels' launch counters are set to 0 before this phase
               and read after it.
5. ``kernels`` one line with every kernel's launches on the serving path,
               error, time, plain time and bound; the card's line from
               nvidia-smi; and the verdict as the last line.

``--profile`` adds one warm ``flush`` under ``torch.profiler`` (device time
by kernel name, the device's idle share of the drain) before step 5.
"""

import json
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


def median_ms(fn, n: int, warmup: int = 3) -> float:
    """Median over ``n`` launches of ``fn``, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# ------------------------------------------------------------------ phases
def phase_env(device) -> str:
    from repro_torch.kernels.tmfu import kernel as tk
    nvcc = subprocess.run([tk._find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
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


def stacked_bank(kernels, names, dtype, device):
    """The nine contexts plus the all-opcodes context as one bank's stacked
    tensors ``(op, src_a, src_b, imm_i32)`` of shape [10, S_MAX, 32]."""
    from repro_torch.core import vm
    from repro_torch.kernels.tmfu.ops import _imm_to_i32
    kind = "int" if dtype == torch.int32 else "float"
    hosts = [vm.host_context(kernels[n].program, S_MAX, dtype) for n in names]
    fields = {f: [getattr(h, f) for h in hosts]
              for f in ("op", "src_a", "src_b", "imm")}
    special = all_opcodes_context(kind)
    for f in ("op", "src_a", "src_b"):
        fields[f].append(special[f])
    fields["imm"].append(vm.to_host(
        torch.from_numpy(special["imm"]).to(dtype)).astype(vm.host_dtype(dtype)))
    op, a, b = (torch.from_numpy(np.stack(fields[f])).to(device)
                for f in ("op", "src_a", "src_b"))
    imm = torch.from_numpy(np.stack(fields["imm"])).to(device).to(dtype)
    return op, a, b, _imm_to_i32(imm).contiguous()


def tile_stack(n_ctx, G, dtype, device, rng, special=True):
    """[G, 32, 128] tiles and their context ids: tile g runs context
    ``g % n_ctx``; with ``special``, tiles of the last (all-opcodes) context
    carry the special values; int32 tiles alternate small and full-range
    values."""
    kind = "int" if dtype == torch.int32 else "float"
    ids = (np.arange(G) % n_ctx).astype(np.int32)
    if kind == "int":
        x = rng.randint(-6, 7, size=(G, RF, TILE)).astype(np.int32)
        wide = rng.randint(-2**31, 2**31 - 1, size=(G, RF, TILE),
                           dtype=np.int64).astype(np.int32)
        x[1::2] = wide[1::2]
    else:
        x = rng.uniform(-2, 2, (G, RF, TILE)).astype(np.float32)
    sp = special_lanes(kind, 2 * TILE)
    for j, g in enumerate(np.nonzero(ids == n_ctx - 1)[0] if special else ()):
        x[g] = sp[:, (j % 2) * TILE:(j % 2 + 1) * TILE]
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(x).to(device).to(dtype))


def phase_kernels(kernels, names, device) -> dict:
    """Hold every kernel against its plain version; time it.  Returns the
    per-kernel records (without the serving path's launch counts)."""
    from repro_torch.core import vm
    from repro_torch.kernels.tmfu import kernel as tk
    from repro_torch.kernels.tmfu import ops as tops
    rng = np.random.RandomState(SEED)
    err = {"tmfu_multi": 0.0, "tmfu_multi_inplace": 0.0, "tmfu_single": 0.0}
    n_cmp = dict.fromkeys(err, 0)
    timing = {}
    for dname, dtype in DTYPES:
        bank = stacked_bank(kernels, names, dtype, device)
        n_ctx = bank[0].shape[0]
        itemsize = torch.empty((), dtype=dtype).element_size()
        # ---- multi and in-place multi
        for G in (1, 8, 2048):
            ids, x = tile_stack(n_ctx, G, dtype, device, rng)
            want = tk.tmfu_pipeline_rf_multi_plain(*bank, ids, x)
            got = tk.tmfu_pipeline_rf_multi(*bank, ids, x)
            torch.cuda.synchronize()
            e = compare_bits(got, want, f"tmfu_multi/{dname}/G={G}")
            err["tmfu_multi"] = max(err["tmfu_multi"], e)
            n_cmp["tmfu_multi"] += 1
            x2 = x.clone()
            got2 = tk.tmfu_pipeline_rf_multi_donated(*bank, ids, x2)
            torch.cuda.synchronize()
            assert got2 is x2, "the in-place kernel must return its input"
            e = compare_bits(got2, want, f"tmfu_multi_inplace/{dname}/G={G}")
            err["tmfu_multi_inplace"] = max(err["tmfu_multi_inplace"], e)
            n_cmp["tmfu_multi_inplace"] += 1
            if G == 2048:
                used = min(n_ctx, G)
                n_bytes = (2 * x.numel() * itemsize + ids.numel() * 4
                           + used * 4 * S_MAX * RF * 4)
                b_ms, b_by = bound(n_bytes, G * S_MAX * RF * TILE)
                ms = median_ms(lambda: tk.tmfu_pipeline_rf_multi(
                    *bank, ids, x), 30)
                ms_in = median_ms(lambda: tk.tmfu_pipeline_rf_multi_donated(
                    *bank, ids, x2), 30)
                plain = median_ms(lambda: tk.tmfu_pipeline_rf_multi_plain(
                    *bank, ids, x), 5, warmup=1)
                timing[("tmfu_multi", dname)] = (ms, plain, b_ms, b_by)
                timing[("tmfu_multi_inplace", dname)] = (ms_in, plain, b_ms,
                                                         b_by)
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
                e = compare_bits(got, want, f"tmfu_single/{dname}/B={B}/ctx={k}")
                err["tmfu_single"] = max(err["tmfu_single"], e)
                n_cmp["tmfu_single"] += 1
                if B == 32768 and k == 0:
                    n_bytes = 2 * xb.numel() * itemsize + 4 * S_MAX * RF * 4
                    b_ms, b_by = bound(n_bytes, S_MAX * RF * B)
                    ms = median_ms(lambda: tk.tmfu_pipeline_rf(
                        *ctx, xb, block_batch=512), 30)
                    plain = median_ms(lambda: tk.tmfu_pipeline_rf_plain(
                        *ctx, xb), 5, warmup=1)
                    timing[("tmfu_single", dname)] = (ms, plain, b_ms, b_by)
        # ---- the public wrapper's pad / out_idx / trim at a ragged batch
        for n in names:
            ctx = vm.make_context(kernels[n].program, S_MAX, dtype, device)
            xr = tile_stack(1, 7, dtype, device, rng, special=False)[1]
            xr = xr.movedim(1, 0).reshape(RF, 7 * TILE)[:, :777].contiguous()
            want = vm.vm_exec(ctx.tree(), ctx.out_idx, xr)
            got = tops.tmfu_pipeline(ctx, xr)
            torch.cuda.synchronize()
            e = compare_bits(got, want, f"tmfu_pipeline/{dname}/{n}/B=777")
            err["tmfu_single"] = max(err["tmfu_single"], e)
            n_cmp["tmfu_single"] += 1
    replaces = {"tmfu_multi": "src/repro/kernels/tmfu/kernel.py:169",
                "tmfu_multi_inplace": "src/repro/kernels/tmfu/kernel.py:202",
                "tmfu_single": "src/repro/kernels/tmfu/kernel.py:234"}
    shapes = {"tmfu_multi": "G=2048 T=128 S=16",
              "tmfu_multi_inplace": "G=2048 T=128 S=16",
              "tmfu_single": "B=32768 S=16"}
    records = {}
    for name in err:
        ms, plain, b_ms, b_by = timing[(name, "float32")]
        records[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces[name], "launches": None,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": shapes[name] + " float32", "comparisons": n_cmp[name],
            "tolerance": "bit-exact, NaN by position "
                         "(float32, bfloat16, int32)",
            "other_dtypes_ms": {d: timing[(name, d)][0]
                                for d in ("bfloat16", "int32")}}
    emit({"phase": "kernel_checks",
          "compared": n_cmp, "max_abs_err": err,
          "ms": {f"{k}/{d}": v[0] for (k, d), v in timing.items()}})
    return records


def make_trace(kernels, names, n_requests, lanes, n_tenants):
    rng = np.random.RandomState(SEED)
    trace = []
    for i in range(n_requests):
        k = kernels[names[i % len(names)]]
        xs = [rng.uniform(-2, 2, (lanes,)).astype(np.float32)
              for _ in k.dfg.inputs]
        trace.append((k, xs, f"tenant{i % n_tenants}"))
    return trace


def same_outputs(a, b, what):
    assert len(a) == len(b), what
    for j, (u, v) in enumerate(zip(a, b)):
        u = u.cpu().numpy() if isinstance(u, torch.Tensor) else np.asarray(u)
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        if u.tobytes() != v.tobytes():
            raise AssertionError(f"{what}: output {j} differs")


def phase_serve(kernels, names, device) -> dict:
    """Drive the serving path; returns the launch counts it caused."""
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
    return counts


def phase_profile(kernels, names, device) -> None:
    """``--profile`` only: one warm pipelined ``flush`` of the serving trace
    under ``torch.profiler``; device time by kernel name and the share of
    the drain's wall time in which the device ran nothing."""
    from torch.autograd import DeviceType
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
    rows = []
    for e in prof.key_averages():
        # device-side entries only (kernels, memcpys): the host-side op that
        # launched one reports the same device time again
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append({"name": e.key[:80], "calls": e.count,
                         "device_ms": us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
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
    counts = phase_serve(kernels, names, device)
    for name, rec in records.items():
        rec["launches"] = counts[name]
    torch.cuda.synchronize()
    if "--profile" in sys.argv[1:]:
        phase_profile(kernels, names, device)

    emit({"kernels": list(records.values())})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
