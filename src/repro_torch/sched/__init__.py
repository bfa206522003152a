"""Pluggable scheduling subsystem for the overlay serving engines.

The paper's core trade is time-multiplexing one FU array across kernels
via cheap context switches; the serving engines make the analogous trade
in software.  This package separates every scheduling DECISION from the
engine MECHANICS (``launch.serve`` keeps the staged pipeline, pinning,
ticket bookkeeping), the way JIT-assembly overlays separate the compute
fabric from placement policy:

* :mod:`repro_torch.sched.admission` — per-tenant token-bucket admission
  (``TokenBucket``, ``AdmissionControl``, ``AdmissionError``);
* :mod:`repro_torch.sched.autoscale` — elastic fleet sizing
  (``AutoscalePolicy`` protocol: ``PressureAutoscaler`` grows/drains
  replicas from observed queue pressure);
* :mod:`repro_torch.sched.rounds` — round formation (``RoundPolicy`` protocol:
  ``DeficitRoundRobin``, ``CoalescingPolicy``, ``DynamicTilePolicy``);
* :mod:`repro_torch.sched.routing` — replica selection for the sharded fleet
  (``RouterPolicy`` protocol: ``ResidencyRouter``, ``WorkStealingRouter``);
* :mod:`repro_torch.sched.pump` — ``AutoPump``, a background drain thread so
  concurrent ``submit`` makes progress without an explicit ``flush``.
"""

from repro_torch.sched.admission import (AdmissionControl, AdmissionError,
                                         TokenBucket)
from repro_torch.sched.autoscale import AutoscalePolicy, PressureAutoscaler
from repro_torch.sched.preempt import BULK_PREFIX, PreemptibleTier
from repro_torch.sched.pump import AutoPump
from repro_torch.sched.rounds import (ROUND_POLICIES, CoalescingPolicy,
                                      DeficitRoundRobin, DynamicTilePolicy,
                                      Flow, OverlayRequest, RoundPolicy,
                                      WorkRequest, make_round_policy)
from repro_torch.sched.routing import (ResidencyRouter, RouterPolicy,
                                       WorkStealingRouter, make_router)

__all__ = [
    "AdmissionControl", "AdmissionError", "TokenBucket",
    "AutoscalePolicy", "PressureAutoscaler",
    "AutoPump",
    "BULK_PREFIX", "PreemptibleTier",
    "ROUND_POLICIES", "RoundPolicy", "DeficitRoundRobin",
    "CoalescingPolicy", "DynamicTilePolicy", "Flow", "OverlayRequest",
    "WorkRequest", "make_round_policy",
    "RouterPolicy", "ResidencyRouter", "WorkStealingRouter", "make_router",
]
