"""Device milliseconds a decode step inside the program's ranges
``decode.cache_write`` (each attention layer's copy of its K/V cache and
the new token's write) and ``decode.cache_stack`` (the layers' new
caches stacked into one tree)."""

from chipbench.metrics._ranges import range_ms


def read(rec):
    return range_ms(rec, ("decode.cache_write", "decode.cache_stack"),
                    "steps")
