"""Property-testing compat layer: hypothesis when available, else fallback
(the port's own copy of the reference's ``testing.py``).

Tests use a small subset of the hypothesis API (``given``, ``settings``,
``strategies.integers/sampled_from/data``).  Hypothesis is an *optional*
dev dependency (see requirements-dev.txt): when it is installed this
module re-exports the real thing; otherwise a deterministic seeded-random
fallback with the same call surface runs a fixed number of examples per
test (the reference's seeds, so both packages draw the same examples), so
the tests collect and run everywhere.
"""

from __future__ import annotations

import random

try:  # pragma: no cover - exercised implicitly when hypothesis is present
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

    _DEFAULT_EXAMPLES = 25

    class _Strategy:
        """A value source drawing from a seeded ``random.Random``."""

        def __init__(self, draw):
            self._draw = draw

        def example_with(self, rng: random.Random):
            return self._draw(rng)

    class _DataObject:
        """Runtime stand-in for hypothesis' interactive ``data()`` draws."""

        def __init__(self, rng: random.Random):
            self._rng = rng

        def draw(self, strategy: _Strategy):
            return strategy.example_with(self._rng)

    class _Strategies:
        @staticmethod
        def integers(min_value: int, max_value: int) -> _Strategy:
            return _Strategy(lambda rng: rng.randint(min_value, max_value))

        @staticmethod
        def sampled_from(seq) -> _Strategy:
            pool = list(seq)
            return _Strategy(lambda rng: pool[rng.randrange(len(pool))])

        @staticmethod
        def data() -> _Strategy:
            return _Strategy(lambda rng: _DataObject(rng))

    st = _Strategies()

    def settings(max_examples: int = _DEFAULT_EXAMPLES, **_ignored):
        """Outer decorator: records the example budget on the runner."""

        def deco(fn):
            fn._max_examples = max_examples
            return fn

        return deco

    def given(*arg_strats, **kw_strats):
        def deco(fn):
            # NB: no functools.wraps — copying fn's signature would make
            # pytest treat the drawn parameters as fixtures.
            def runner(*args, **kwargs):
                n = getattr(runner, "_max_examples", _DEFAULT_EXAMPLES)
                for i in range(n):
                    rng = random.Random(0xC0FFEE ^ (i * 0x9E3779B9))
                    drawn = [s.example_with(rng) for s in arg_strats]
                    drawn_kw = {k: s.example_with(rng)
                                for k, s in kw_strats.items()}
                    fn(*args, *drawn, **kwargs, **drawn_kw)

            runner.__name__ = fn.__name__
            runner.__qualname__ = fn.__qualname__
            runner.__doc__ = fn.__doc__
            runner.__module__ = fn.__module__
            runner.hypothesis_fallback = True
            return runner

        return deco

__all__ = ["given", "settings", "st", "HAVE_HYPOTHESIS"]
