"""Device time inside the program's own profiler ranges: ``range_s`` of
the traced window (``chipbench/lib/trace.py``: the device busy time
under each range's device-side annotation), per unit of a counter in the
run's record."""

from __future__ import annotations


def range_ms(rec, names, per: str):
    """Device milliseconds inside the ranges ``names``, summed, per unit of
    the counter ``per``; None where a range is absent from the trace (a
    program without it) or the counter is missing or zero."""
    t, n = rec.trace, rec.counters.get(per)
    if not t or not n or not all(t["range_n"].get(r) for r in names):
        return None
    return 1e3 * sum(t["range_s"][r] for r in names) / n
