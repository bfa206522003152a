"""Profiler ranges inside the program, entered only while a profiler
records.

``span(name)`` marks a block of the program with a ``torch.profiler``
range, on the clock of the device trace: a range that launches device
work shows up again on the device's timeline (a ``gpu_user_annotation``),
so a trace attributes that work to the program's own layer.  With no
profiler recording it returns one shared null context: an ungated
``record_function`` costs a dispatched op a block (10-16 us on a CPU
host) and shows up as an op in any ``TorchDispatchMode`` (the dry run's
tracer), a gated one a flag test.

The flag is read through its module on every call, never imported once:
the profiler sets it on entry and clears it on exit, process-wide, so
blocks on autograd's device thread are recorded too.  See
docs/TELEMETRY.md ("Spans") and docs/PORT.md ("Spans of the in-place
decode", "Spans of the hybrid model") for the names the program uses.
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

_NULL = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else a shared
    null context."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _NULL
