"""Device milliseconds a decode step inside the program's range
``decode.shared_block`` (each site's shared block, from the concat of
its input and the embedding to the site's ``linear``: 13 a step)."""

from chipbench.metrics._ranges import range_ms


def read(rec):
    return range_ms(rec, ("decode.shared_block",), "steps")
