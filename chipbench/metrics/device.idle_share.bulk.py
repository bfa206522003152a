"""Per cent of the traced window with nothing running on the device."""

from chipbench.metrics._readers import idle_share


def read(rec):
    return idle_share(rec)
