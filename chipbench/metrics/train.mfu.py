"""Per cent of the chip's bf16 peak that the training window's model
FLOPs reach: ``_arith.train_step_flops`` (no recompute) a step, times the
steps, over the window."""

from chipbench.metrics import _arith


def read(rec):
    c = rec.counters
    if not c.get("steps") or not c.get("window_s"):
        return None
    return 100.0 * c["step_flops"] * c["steps"] / c["window_s"] \
        / _arith.PEAK_BF16_FLOPS
