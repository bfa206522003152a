"""The reader of ``decode.attn_core_ms`` on synthetic records: the device
time under the program's ``decode.attn_core`` range a decode step, and
None for a program without the range (a parent that has none), an
untraced run or a missing step count."""

from types import SimpleNamespace

import pytest

from chipbench.lib.spec import load_module
from chipbench.tests.support import ROOT

read = load_module(ROOT / "chipbench" / "metrics"
                   / "decode.attn_core_ms.py").read


def record(ranges: dict, **counters):
    trace = {"window_s": 20.0, "busy_s": 19.0,
             "range_s": {k: s for k, (s, _) in ranges.items()},
             "range_n": {k: n for k, (_, n) in ranges.items()}}
    return SimpleNamespace(trace=trace, counters=counters)


@pytest.mark.parametrize("steps,seconds,want", [(500, 2.5, 5.0),
                                                (271, 12.466, 46.0)])
def test_the_range_a_step(steps, seconds, want):
    rec = record({"decode.attn_core": (seconds, 10 * steps),
                  "decode.cache_write": (4.0, 10 * steps)}, steps=steps)
    assert read(rec) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_range", "untraced", "no_steps",
                                  "zero_steps"])
def test_nothing_to_read(case):
    ranges = {"decode.attn_core": (2.5, 5000)}
    rec = {"no_range": record({"decode.cache_write": (4.0, 5000)},
                              steps=500),
           "untraced": SimpleNamespace(trace=None, counters={"steps": 500}),
           "no_steps": record(ranges),
           "zero_steps": record(ranges, steps=0)}[case]
    assert read(rec) is None
