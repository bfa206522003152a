"""Device milliseconds a decode step inside the program's range
``decode.attn_core`` (each attention layer's attention over its cache:
on the card, the decode-attention kernel)."""

from chipbench.metrics._ranges import range_ms


def read(rec):
    return range_ms(rec, ("decode.attn_core",), "steps")
