"""Device milliseconds a decode step inside the program's range
``decode.ssm_step`` (each Mamba2 mixer's decode step: 81 a step)."""

from chipbench.metrics._ranges import range_ms


def read(rec):
    return range_ms(rec, ("decode.ssm_step",), "steps")
