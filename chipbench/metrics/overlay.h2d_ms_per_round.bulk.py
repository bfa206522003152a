"""Device milliseconds a round inside the program's range ``overlay.h2d``
(``Overlay.assemble``'s two pageable copies: the context ids and the
register-file tile stack), over the window's rounds."""

from chipbench.metrics._ranges import range_ms


def read(rec):
    return range_ms(rec, ("overlay.h2d",), "rounds")
