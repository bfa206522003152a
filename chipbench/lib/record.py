"""One run's record: what a driver measured, and the result line.

A driver fills a ``Record``: ``setup_done()`` when set-up ends, the
end-to-end values in ``e2e``, the counters the per-layer readers take in
``counters``, the traced window's numbers in ``trace``, and every number
compared with the reference in ``check(name, value, limit)``.  The run
is correct when every compared number is at most its limit and nothing
was lost.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time


@dataclasses.dataclass
class Record:
    seed: int
    seconds: float
    traced: bool
    t_start: float                       # perf_counter at process start
    device: object = None                # torch.device
    setup_s: float | None = None
    e2e: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    trace: dict | None = None
    checks: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0

    def window_s(self, traffic: dict) -> float:
        """The window's length: ``--seconds``, and in a traced run at most
        the traffic's ``trace_seconds`` (the profile of every step of a
        long window takes longer to read than a run may last)."""
        if self.traced and "trace_seconds" in traffic:
            return min(self.seconds, float(traffic["trace_seconds"]))
        return self.seconds

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values())


def seed_int(seed: int, salt: int = 0) -> int:
    """A seed folded into [0, 2**63) (a generator's ``manual_seed`` and
    numpy's ``default_rng`` take any such number), with ``salt`` for an
    independent stream."""
    return (int(seed) * 6364136223846793005 + salt * 1442695040888963407
            + 1) % (1 << 63)


def read_metrics(cell, rec: Record) -> dict:
    """The metrics of the result line: the cell's end-to-end metrics with
    ``--trace 0``, its per-layer metrics (each by its reader; one that
    finds nothing is left out) with ``--trace 1``."""
    from chipbench.lib.spec import load_module
    out = {}
    if not rec.traced:
        for m in cell.end_to_end:
            name = m["name"]
            if name == "setup_s":
                value = rec.setup_s
            else:
                value = rec.e2e.get(name)
            if value is None:
                raise RuntimeError(f"the driver measured no {name}")
            out[name] = {"value": float(value), "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        value = load_module(cell.metric_path(m["name"])).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(cell, rec: Record, cpu_core=None) -> dict:
    """The result line as a dict: every metric read (each per-layer
    reader loaded and run here), ``checks`` last.  ``cpu_core`` is the
    core the run kept to, or None where it could not pin itself."""
    import torch
    metrics = read_metrics(cell, rec)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(rec.memory_peak_bytes),
              "cpu_core": cpu_core}
    out = {"correct": rec.correct, "attempted": int(rec.attempted),
           "failed": int(rec.failed), "metrics": metrics, "device": device}
    if rec.traced and rec.trace is not None:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
        out["breakdown"] = rec.trace["breakdown"]
    out["checks"] = rec.checks
    return out


def emit(res: dict) -> None:
    """Print the compared numbers on standard error and the result line
    last on standard output."""
    sys.stdout.flush()
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
