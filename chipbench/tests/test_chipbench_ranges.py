"""The readers of the program's profiler ranges, on synthetic records:
each value against a hand count, and None where a range, the trace or
the counter it is divided by is missing."""

from types import SimpleNamespace

import pytest

from chipbench.lib.spec import load_module
from chipbench.tests.support import ROOT


def reader(name: str):
    return load_module(ROOT / "chipbench" / "metrics" / f"{name}.py").read


def record(ranges: dict, busy_s: float = 0.0, **counters):
    """A run's record whose trace holds ``ranges`` (name -> (device
    seconds, count))."""
    trace = {"window_s": 20.0, "busy_s": busy_s,
             "range_s": {k: s for k, (s, _) in ranges.items()},
             "range_n": {k: n for k, (_, n) in ranges.items()}}
    return SimpleNamespace(trace=trace, counters=counters)


#: metric, its ranges in a sound trace, its counter, the value by hand
CASES = [
    ("overlay.h2d_ms_per_round.bulk", {"overlay.h2d": (21.0, 2000)},
     {"rounds": 2000}, 10.5),
    ("bank.load_ms_per_round.bulk", {"bank.load": (1.6, 8000)},
     {"rounds": 2000}, 0.8),
    ("decode.cache_copy_ms", {"decode.cache_write": (9.0, 2500),
                              "decode.cache_stack": (3.5, 250)},
     {"steps": 250}, 50.0),
    ("decode.weight_cast_ms", {"weights.cast": (2.5, 17750)},
     {"steps": 250}, 10.0),
    ("train.forward_ms", {"train_step.forward": (4.8, 12)},
     {"steps": 12}, 400.0),
]


@pytest.mark.parametrize("name,ranges,counters,want", CASES,
                         ids=[c[0] for c in CASES])
def test_a_range_over_its_counter(name, ranges, counters, want):
    read = reader(name)
    assert read(record(ranges, **counters)) == pytest.approx(want)
    # a program without one of the ranges: nothing to read
    for gone in ranges:
        rest = {k: v for k, v in ranges.items() if k != gone}
        assert read(record(rest, **counters)) is None
    assert read(record({}, **counters)) is None
    # no counter, a zero counter, an untraced run
    assert read(record(ranges)) is None
    assert read(record(ranges, **{k: 0 for k in counters})) is None
    assert read(SimpleNamespace(trace=None, counters=counters)) is None


def test_backward_is_the_steps_remainder():
    read = reader("train.backward_ms")
    sound = {"train_step.forward": (4.8, 12),
             "train_step.update": (2.04, 12)}
    # 19.8 s busy over 12 steps: 1650 ms a step, less 400 and 170
    assert read(record(sound, busy_s=19.8, steps=12)) == \
        pytest.approx(1080.0)
    for gone in sound:
        rest = {k: v for k, v in sound.items() if k != gone}
        assert read(record(rest, busy_s=19.8, steps=12)) is None
    assert read(record(sound, busy_s=19.8)) is None
    assert read(record(sound, busy_s=0.0, steps=12)) is None
    assert read(SimpleNamespace(trace=None, counters={"steps": 12})) is None
