"""Readers shared by the per-layer metrics of several cells: each takes
the run's record and returns the metric, or None where the run has
nothing to read."""

from __future__ import annotations

from chipbench.lib.trace import device_seconds
from chipbench.metrics import _arith


def _counter(rec, key):
    return rec.counters.get(key)


def ratio(rec, num: str, den: str, scale: float = 1.0):
    n, d = _counter(rec, num), _counter(rec, den)
    if n is None or not d:
        return None
    return scale * n / d


def hit_rate(rec):
    """Per cent of the contexts a round needed that the bank held."""
    hits, loads = _counter(rec, "hits"), _counter(rec, "loads")
    if hits is None or loads is None or hits + loads == 0:
        return None
    return 100.0 * hits / (hits + loads)


def idle_share(rec):
    """Per cent of the traced window in which nothing ran on the device."""
    t = rec.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def tmfu_roofline(rec):
    """Per cent of the TMFU kernels' bound: the bytes the window's
    requests need (``_arith.dfg_request_bytes``, counted from the DFG)
    at the HBM peak, over the kernels' device time in the trace."""
    t, need = rec.trace, _counter(rec, "tmfu_bytes")
    if not t or not need:
        return None
    dev = device_seconds(t, "tmfu")
    if dev <= 0:
        return None
    return 100.0 * need / _arith.PEAK_HBM_BYTES / dev
