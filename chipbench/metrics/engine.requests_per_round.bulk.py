"""Requests delivered a round over the window (``OverlayServer.stats()``
``requests`` / ``rounds``): how much one launch carries."""

from chipbench.metrics._readers import ratio


def read(rec):
    return ratio(rec, "requests", "rounds")
