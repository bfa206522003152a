"""Round-formation policies: which queued requests form the next round.

The engine (``launch.serve.OverlayServer``) owns the queues — one
:class:`Flow` per tenant plus a round-robin order — and the staged
launch/retire mechanics.  A :class:`RoundPolicy` owns only the DECISION:
given the flows, pick the next round's requests.  Policies mutate the
flow queues/deficits in place (requests they take leave the queues) and
may keep feedback state fed by :meth:`RoundPolicy.observe`.

Shipped policies:

* :class:`DeficitRoundRobin` — the engine's original scheduler, extracted
  bit for bit (tests/test_sched_policies.py replays a recorded golden
  trace and asserts identical rounds + identical result bytes).  Classic
  DRR semantics: a flow's deficit grows by ``quantum_tiles`` per
  scheduling pass, whole head-of-queue kernel groups are taken while the
  deficit covers their tile cost, and the deficit resets ONLY when the
  flow goes idle — a backlogged flow that could not afford its head this
  round keeps its credit, so a request costing more than one quantum is
  always eventually served (the classic-DRR starvation bound).
* :class:`CoalescingPolicy` — DRR base round, then same-kernel requests
  from other tenants' queues are merged into the round's existing kernel
  groups (deficit-free, up to ``coalesce_tiles`` extra tiles).  Trades
  strict per-tenant pacing for launch batching: one device launch covers
  more of the fleet-wide demand for a hot kernel.
* :class:`DynamicTilePolicy` — DRR with an adaptive per-round tile
  budget (AIMD on observed round latency): rounds shrink when delivery
  latency overshoots ``target_latency_s`` and grow while there is
  headroom, trading launch batching against tail latency automatically.

``make_round_policy`` builds a policy by name; the ``REPRO_ROUND_POLICY``
environment knob selects the default for engines that were not handed an
explicit policy (this is how CI runs the serving suite under every
policy).  docs/SCHEDULING.md describes how to write a policy.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections import OrderedDict, deque
from typing import Protocol, runtime_checkable

import numpy as np

#: tenant label used when ``submit`` is not given one
DEFAULT_TENANT = "default"

#: environment knob: default round policy name for engines constructed
#: without an explicit ``round_policy`` (CI's policy matrix sets this)
POLICY_ENV = "REPRO_ROUND_POLICY"


@dataclasses.dataclass
class OverlayRequest:
    """One queued kernel invocation: a batch of iterations of one kernel."""

    ticket: int
    kernel: object            # core.overlay.CompiledKernel
    xs: list                  # per-primary-input 1-D arrays, equal length
    tenant: str = DEFAULT_TENANT
    key: tuple = ()           # context identity (bank.context_key)
    cost: int = 1             # dispatch tiles this request occupies
    t_submit: float = 0.0

    @property
    def name(self) -> str:
        return self.kernel.program.name

    @property
    def batch(self) -> int:
        return int(np.shape(self.xs[0])[0])


@dataclasses.dataclass
class WorkRequest(OverlayRequest):
    """One queued host-side work item (e.g. a training micro-round).

    A work request rides the SAME flows, rounds, tickets, and telemetry
    as kernel requests — that is the whole point: the scheduler decides
    when bulk work runs, not a side channel.  It carries no kernel
    (``kernel is None``) and no inputs; instead the engine calls ``fn()``
    at round launch and delivers its return value through the ticket.
    ``cost`` is the tile budget the work charges against its flow's
    deficit (how big the work "looks" to the round policy), and ``key``
    groups consecutive work items the way a context key groups kernel
    requests (steal/evacuation move whole key groups).
    """

    fn: object = None             # zero-arg callable, run at round launch
    label: str = "work"

    @property
    def name(self) -> str:        # no kernel.program to read the name off
        return self.label

    @property
    def batch(self) -> int:       # no primary inputs; tile math uses cost
        return 0


@dataclasses.dataclass
class Flow:
    """Per-tenant FIFO queue + deficit-round-robin state."""

    queue: deque
    deficit: float = 0.0


@runtime_checkable
class RoundPolicy(Protocol):
    """What the engine needs from a round-formation policy.

    ``form_round`` may mutate ``flows`` (take requests, adjust deficits)
    and ``rr`` (rotate the service order); the engine guarantees every
    flow in ``rr`` exists in ``flows`` and prunes drained flows between
    calls.  Returning ``None`` means nothing is queued.  ``observe`` is
    the feedback edge: the engine reports every retired round's tile
    cost — the sum of its requests' ``cost`` fields, the SAME units
    policies budget rounds in — and wall-clock seconds (launch ->
    delivery, on the engine's injectable clock).  Both drain paths
    (pipelined and ``flush_sync``) report identical units.
    """

    def form_round(self, flows: dict[str, Flow], rr: deque,
                   round_kernels: int) -> list | None: ...

    def observe(self, n_tiles: int, wall_s: float) -> None: ...


class DeficitRoundRobin:
    """Deficit round-robin across tenant flows (the engine's original
    scheduler, extracted).

    ``quantum_tiles`` is the per-pass deficit increment in dispatch
    tiles; ``None`` means unbounded (pure round-robin over tenants).

    ``tenant_quanta`` maps individual tenants to their OWN per-pass
    quantum (tiles, or ``None`` for unbounded), overriding
    ``quantum_tiles`` flow by flow — the SLO-class mechanism the
    slo_study sweeps: a latency tier gets a large quantum (its requests
    clear in the next round), a preemptible bulk tier gets a small one
    (its backlog trickles through without crowding the round).  Tenants
    absent from the map use ``quantum_tiles``.
    """

    def __init__(self, quantum_tiles: float | None = None,
                 tenant_quanta: dict | None = None):
        if quantum_tiles is not None and quantum_tiles <= 0:
            raise ValueError(
                f"quantum_tiles must be > 0 or None (unbounded), got "
                f"{quantum_tiles}; a non-positive quantum can never cover "
                f"a request's tile cost")
        self.quantum_tiles = quantum_tiles
        self.tenant_quanta = dict(tenant_quanta or {})
        for tenant, q in self.tenant_quanta.items():
            if q is not None and q <= 0:
                raise ValueError(
                    f"tenant_quanta[{tenant!r}] must be > 0 or None "
                    f"(unbounded), got {q}")

    def quantum_for(self, tenant: str) -> float | None:
        """The per-pass deficit increment for one tenant's flow."""
        return self.tenant_quanta.get(tenant, self.quantum_tiles)

    # ------------------------------------------------------------- hooks
    def _max_round_tiles(self) -> float:
        """Per-round tile budget; ``inf`` = unbounded (pure DRR).
        :class:`DynamicTilePolicy` overrides this with its adaptive
        target."""
        return math.inf

    def observe(self, n_tiles: int, wall_s: float) -> None:
        """Feedback no-op for static policies."""

    # ----------------------------------------------------------- service
    def _serve_flow(self, flow: Flow, keys: set, cap: int,
                    used: int) -> tuple[list, int]:
        """DRR service of one flow: whole kernel groups, head-first, until
        the flow's deficit, the round's distinct-kernel budget, or the
        round's tile budget runs out.  Returns ``(taken, used)`` where
        ``used`` is the round's running tile total.

        Untaken requests keep their ARRIVAL order in the queue (never the
        grouped order) — a skipped kernel's old request must reach the
        queue head ahead of newer traffic, or a live stream on one kernel
        would starve a tenant's own requests on another.

        Classic-DRR deficit semantics: the deficit resets ONLY when the
        flow drains (goes idle).  A backlogged flow — queued work it
        could not afford this round — keeps its accumulated credit, so a
        request costing more than one quantum is served once enough
        rounds have passed instead of starving forever
        (tests/test_sched_policies.py::test_deficit_preserved_for_backlogged_flow).
        """
        limit = self._max_round_tiles()
        taken: list[OverlayRequest] = []
        taken_ids: set[int] = set()
        by_key: OrderedDict[tuple, list] = OrderedDict()
        for r in flow.queue:
            by_key.setdefault(r.key, []).append(r)
        exhausted = False
        for key, rs in by_key.items():
            if exhausted or (key not in keys and len(keys) >= cap):
                continue
            for r in rs:
                if used and used + r.cost > limit:
                    # round full: stop WITHOUT charging the flow — its
                    # deficit (and queue order) carry to the next round
                    exhausted = True
                    break
                if flow.deficit >= r.cost:
                    flow.deficit -= r.cost
                    keys.add(key)
                    taken.append(r)
                    taken_ids.add(r.ticket)
                    used += r.cost
                else:
                    exhausted = True
                    break
        flow.queue = deque(r for r in flow.queue
                           if r.ticket not in taken_ids)
        if not flow.queue:
            flow.deficit = 0.0          # classic DRR: only idle flows reset
        return taken, used

    def form_round(self, flows: dict[str, Flow], rr: deque,
                   round_kernels: int) -> list | None:
        """Pick the next round via deficit round-robin across tenants."""
        if not flows:
            return None
        keys: set = set()
        round_reqs: list[OverlayRequest] = []
        used = 0
        while not round_reqs:
            for tenant in list(rr):
                flow = flows[tenant]
                if not flow.queue:
                    continue
                quantum = self.quantum_for(tenant)
                flow.deficit = (math.inf if quantum is None
                                else flow.deficit + quantum)
                taken, used = self._serve_flow(flow, keys, round_kernels,
                                               used)
                round_reqs.extend(taken)
        rr.rotate(-1)             # a different tenant leads next round
        return round_reqs


class CoalescingPolicy(DeficitRoundRobin):
    """DRR base round + cross-tenant same-kernel coalescing.

    After the base DRR pass, requests elsewhere in the queues whose
    context key already appears in the round are pulled in deficit-free,
    up to ``coalesce_tiles`` extra tiles per round.  The merged group
    rides the SAME device launch (round assembly batches per kernel), so
    fleet-wide demand for a hot kernel is served in fewer, fuller
    launches.  The trade: per-tenant pacing is looser (coalesced requests
    bypass their flow's deficit) and within-kernel delivery order can mix
    tenants' submission order.
    """

    def __init__(self, quantum_tiles: float | None = None,
                 coalesce_tiles: int = 32,
                 tenant_quanta: dict | None = None):
        super().__init__(quantum_tiles, tenant_quanta=tenant_quanta)
        if coalesce_tiles < 0:
            raise ValueError(
                f"coalesce_tiles must be >= 0, got {coalesce_tiles}")
        self.coalesce_tiles = coalesce_tiles
        self.n_coalesced = 0

    def form_round(self, flows: dict[str, Flow], rr: deque,
                   round_kernels: int) -> list | None:
        round_reqs = super().form_round(flows, rr, round_kernels)
        if round_reqs is None or not self.coalesce_tiles:
            return round_reqs
        keys = {r.key for r in round_reqs}
        budget = self.coalesce_tiles
        for tenant in list(rr):
            if budget <= 0:
                break
            flow = flows.get(tenant)
            if flow is None or not flow.queue:
                continue
            taken_ids: set[int] = set()
            for r in flow.queue:
                if r.key not in keys:
                    continue
                if r.cost > budget:
                    # stop scanning this flow: pulling a NEWER request
                    # past an unaffordable older one would invert the
                    # tenant's arrival order (the same invariant
                    # _serve_flow keeps for skipped kernels)
                    break
                budget -= r.cost
                taken_ids.add(r.ticket)
                round_reqs.append(r)
            if taken_ids:
                self.n_coalesced += len(taken_ids)
                flow.queue = deque(r for r in flow.queue
                                   if r.ticket not in taken_ids)
                if not flow.queue:
                    flow.deficit = 0.0
        return round_reqs


class DynamicTilePolicy(DeficitRoundRobin):
    """DRR with an adaptive per-round tile budget (AIMD on latency).

    The engine reports every retired round's live tiles and wall-clock
    via :meth:`observe`.  When a round's latency overshoots
    ``target_latency_s`` the budget shrinks multiplicatively
    (``shrink``); when latency sits below half the target AND the round
    actually filled most of the budget (low latency on a near-empty
    round says nothing), it grows (``grow``), clamped to
    ``[min_tiles, max_tiles]``.  Small budgets mean more, shallower
    rounds — more pipeline overlap and tighter tails; large budgets mean
    fuller launches — better batching.  This policy walks that trade-off
    (the DRR-quantum/``round_kernels`` study in the ROADMAP) instead of
    freezing it at construction.
    """

    def __init__(self, quantum_tiles: float | None = None,
                 target_latency_s: float = 0.05, init_tiles: int = 32,
                 min_tiles: int = 4, max_tiles: int = 4096,
                 grow: float = 1.25, shrink: float = 0.5,
                 tenant_quanta: dict | None = None):
        super().__init__(quantum_tiles, tenant_quanta=tenant_quanta)
        if target_latency_s <= 0:
            raise ValueError(
                f"target_latency_s must be > 0, got {target_latency_s}")
        if not (0 < min_tiles <= init_tiles <= max_tiles):
            raise ValueError(
                f"need 0 < min_tiles <= init_tiles <= max_tiles, got "
                f"{min_tiles}/{init_tiles}/{max_tiles}")
        if grow <= 1.0 or not (0.0 < shrink < 1.0):
            raise ValueError(
                f"need grow > 1 and 0 < shrink < 1, got {grow}/{shrink}")
        self.target_latency_s = target_latency_s
        self.min_tiles = min_tiles
        self.max_tiles = max_tiles
        self.grow = grow
        self.shrink = shrink
        #: current per-round tile budget (the adapted knob)
        self.round_tiles = float(init_tiles)
        self.n_grown = 0
        self.n_shrunk = 0

    def _max_round_tiles(self) -> float:
        return self.round_tiles

    def observe(self, n_tiles: int, wall_s: float) -> None:
        if wall_s > self.target_latency_s:
            self.round_tiles = max(float(self.min_tiles),
                                   self.round_tiles * self.shrink)
            self.n_shrunk += 1
        elif (wall_s < self.target_latency_s / 2
              and n_tiles >= 0.75 * self.round_tiles):
            self.round_tiles = min(float(self.max_tiles),
                                   self.round_tiles * self.grow)
            self.n_grown += 1


#: name -> class, for ``make_round_policy`` and the CLI/CI knobs
ROUND_POLICIES: dict[str, type] = {
    "drr": DeficitRoundRobin,
    "coalesce": CoalescingPolicy,
    "dynamic": DynamicTilePolicy,
}


def make_round_policy(name: str | None = None,
                      quantum_tiles: float | None = None, **kw):
    """Build a round policy by name.

    ``name=None`` consults the ``REPRO_ROUND_POLICY`` environment knob
    (default ``"drr"``) — engines constructed without an explicit policy
    go through here, which is how the CI policy matrix swaps the
    scheduler under the whole serving suite without touching the tests.
    """
    name = name or os.environ.get(POLICY_ENV) or "drr"
    try:
        cls = ROUND_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown round policy {name!r}; choose from "
            f"{sorted(ROUND_POLICIES)}") from None
    return cls(quantum_tiles=quantum_tiles, **kw)
