"""The traced window: ``torch.profiler`` around it, reduced to numbers.

The harness marks the window with the range ``bench.window`` and its
own calls into each layer with ``bench.*`` ranges.  ``reduce`` reads the
profiler's events once:

* device activity (kernels, copies, sets) merged into busy intervals
  inside the window: ``busy_s`` and the idle gaps between them;
* device seconds by kernel name (``kernel_s``) and inside each device
  range the program marks (``range_s``: ``train_step.update``);
* ``breakdown``: the ten device operations that took most time, and the
  idle seconds of the longest gaps by the innermost host event that
  covered each gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib

WINDOW = "bench.window"
#: device activities counted as busy time
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
#: gaps attributed to a host event (the longest ones)
GAPS_NAMED = 400
#: host events looked back through for one gap
LOOKBACK = 4000
TOP = 10
NAME_CHARS = 160


def span(name: str):
    """A host range the trace records (nothing when not profiling)."""
    from torch.profiler import record_function
    return record_function(name)


@contextlib.contextmanager
def profiled(enabled: bool, out: dict):
    """Profile the block when ``enabled`` and put ``reduce``'s result in
    ``out["trace"]`` when it closes; the block runs inside ``WINDOW``."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    try:
        with span(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    out["trace"] = reduce(events(prof))


def events(prof):
    """``(kind, name, start_ns, end_ns)`` of every profiled event.  The
    kinds are the trace's categories (``kernel``, ``gpu_memcpy``,
    ``user_annotation``, ...): read from the profiler's events where they
    carry them, else from its chrome trace, written under ``TMPDIR`` and
    deleted at once."""
    evs = prof.profiler.kineto_results.events()
    if evs and hasattr(evs[0], "activity_type"):
        return [(e.activity_type(), e.name(), e.start_ns(),
                 e.start_ns() + e.duration_ns()) for e in evs]
    import json
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    out = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "cat" not in e:
            continue
        s = int(round(float(e["ts"]) * 1000))
        out.append((e["cat"], e.get("name", ""), s,
                    s + int(round(float(e.get("dur", 0)) * 1000))))
    return out


def merge(intervals):
    """Sorted, non-overlapping union of ``(start, end)`` pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _clip(iv, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in iv if e > lo and s < hi]


def _covered(merged, lo, hi) -> int:
    """Nanoseconds of ``merged`` inside [lo, hi]."""
    return sum(e - s for s, e in _clip(merged, lo, hi))


def reduce(events) -> dict:
    """The traced window's numbers from ``events``' ``(kind, name,
    start_ns, end_ns)`` (see the module's docstring).  Times in
    seconds."""
    window = None
    device, annotations, host = [], [], []
    for kind, name, s, t in events:
        if kind in DEVICE_KINDS:
            device.append((s, t, name))
        elif kind == "gpu_user_annotation":
            annotations.append((s, t, name))
        elif name == WINDOW and kind == "user_annotation":
            window = (s, t)
        elif t > s and kind != "Trace":
            host.append((s, t, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    lo, hi = window
    busy = merge((s, t) for s, t, _ in _clip_named(device, lo, hi))
    kernel_s: dict = {}
    for s, t, name in _clip_named(device, lo, hi):
        kernel_s[name] = kernel_s.get(name, 0) + (t - s)
    range_s: dict = {}
    range_n: dict = {}
    for s, t, name in annotations:
        if t > lo and s < hi:
            range_s[name] = range_s.get(name, 0) + _covered(busy, s, t)
            range_n[name] = range_n.get(name, 0) + 1
    gaps, prev = [], lo
    for s, t in busy:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, t)
    if hi > prev:
        gaps.append((hi - prev, prev, hi))
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    by_host: dict = {}
    for length, g0, g1 in gaps[:GAPS_NAMED]:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for h in host[max(0, i - LOOKBACK):i]:
            if h[1] >= mid and (best is None or h[1] - h[0]
                                < best[1] - best[0]):
                best = h
        name = best[2] if best is not None else "(no host event)"
        by_host[name] = by_host.get(name, 0) + length
    ns = 1e-9
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (hi - lo) * ns,
        "busy_s": sum(t - s for s, t in busy) * ns,
        "kernel_s": {k: v * ns for k, v in kernel_s.items()},
        "range_s": {k: v * ns for k, v in range_s.items()},
        "range_n": range_n,
        "device_events": len(device),
        "breakdown": {
            "device_ops": [[k[:NAME_CHARS], v * ns] for k, v in top],
            "idle_gaps": [[k[:NAME_CHARS], v * ns] for k, v in idle]},
    }


def _clip_named(events, lo, hi):
    return [(max(s, lo), min(t, hi), n) for s, t, n in events
            if t > lo and s < hi]


def device_seconds(trace: dict, *needles: str) -> float:
    """Device seconds of the kernels whose name holds any of
    ``needles``."""
    return sum(v for k, v in trace["kernel_s"].items()
               if any(n in k for n in needles))
