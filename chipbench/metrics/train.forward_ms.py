"""Device milliseconds a training step inside the program's range
``train_step.forward`` (the loss's forward; full remat's recompute runs
in the backward)."""

from chipbench.metrics._ranges import range_ms


def read(rec):
    return range_ms(rec, ("train_step.forward",), "steps")
