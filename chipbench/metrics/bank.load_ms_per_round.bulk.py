"""Device milliseconds a round inside the program's range ``bank.load``
(``ContextBank.load``'s writes of a context into a slot on a miss: five
pageable copies), over the window's rounds."""

from chipbench.metrics._ranges import range_ms


def read(rec):
    return range_ms(rec, ("bank.load",), "rounds")
