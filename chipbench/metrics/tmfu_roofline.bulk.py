"""The TMFU kernels' share of their HBM bound (see
``_readers.tmfu_roofline``)."""

from chipbench.metrics._readers import tmfu_roofline


def read(rec):
    return tmfu_roofline(rec)
