"""The 95th percentile of the host clock's gaps between decode steps
issued in the window (a statistic of pieces: per-layer only)."""


def read(rec):
    return rec.counters.get("step_ms_p95")
