"""Per cent of the contexts the window's rounds needed that the
``ContextBank`` held: ``hits / (hits + loads)``."""

from chipbench.metrics._readers import hit_rate


def read(rec):
    return hit_rate(rec)
