"""Per cent of the chip's bf16 peak that the decode window's FLOPs reach
(``_arith.decode_step_flops`` at each step's position)."""

from chipbench.metrics import _arith


def read(rec):
    c = rec.counters
    if not c.get("flops") or not c.get("window_s"):
        return None
    return 100.0 * c["flops"] / c["window_s"] / _arith.PEAK_BF16_FLOPS
