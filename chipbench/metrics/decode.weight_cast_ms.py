"""Device milliseconds a decode step inside the program's range
``weights.cast`` (``layers.project``'s cast of a float32 weight to the
bfloat16 of its input)."""

from chipbench.metrics._ranges import range_ms


def read(rec):
    return range_ms(rec, ("weights.cast",), "steps")
