"""Pluggable scheduling subsystem for the overlay serving engine.

The paper's core trade is time-multiplexing one FU array across kernels
via cheap context switches; the serving engine makes the analogous trade
in software.  This package separates every scheduling DECISION from the
engine MECHANICS (``launch.serve`` keeps the staged pipeline, pinning,
ticket bookkeeping):

* :mod:`repro_torch.sched.admission` — per-tenant token-bucket admission
  (``TokenBucket``, ``AdmissionControl``, ``AdmissionError``);
* :mod:`repro_torch.sched.rounds` — round formation (``RoundPolicy``
  protocol: ``DeficitRoundRobin``, ``CoalescingPolicy``,
  ``DynamicTilePolicy``).
"""

from repro_torch.sched.admission import (AdmissionControl, AdmissionError,
                                         TokenBucket)
from repro_torch.sched.rounds import (ROUND_POLICIES, CoalescingPolicy,
                                      DeficitRoundRobin, DynamicTilePolicy,
                                      Flow, OverlayRequest, RoundPolicy,
                                      WorkRequest, make_round_policy)

__all__ = [
    "AdmissionControl", "AdmissionError", "TokenBucket",
    "ROUND_POLICIES", "RoundPolicy", "DeficitRoundRobin",
    "CoalescingPolicy", "DynamicTilePolicy", "Flow", "OverlayRequest",
    "WorkRequest", "make_round_policy",
]
