"""Host milliseconds a round in the overlay's stages (``stage_walls``
plan + assemble + collect) over the window."""

from chipbench.metrics._readers import ratio


def read(rec):
    return ratio(rec, "host_s", "rounds", 1e3)
