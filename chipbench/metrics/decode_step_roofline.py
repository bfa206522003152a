"""The decode step's share of its HBM bound: the bytes the window's
steps need (``_arith.decode_step_bytes``: bf16 weights and the cache read
once, the new K and V written once) at the HBM peak, over the window."""

from chipbench.metrics import _arith


def read(rec):
    c = rec.counters
    if not c.get("bytes") or not c.get("window_s"):
        return None
    return 100.0 * c["bytes"] / _arith.PEAK_HBM_BYTES / c["window_s"]
