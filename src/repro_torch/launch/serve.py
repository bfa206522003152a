"""Serving launcher: the async overlay engine and the LM path on one GPU.

LM serving (prefill, then greedy decode through the cache)::

  python -m repro_torch.launch.serve --arch deepseek-7b
  python -m repro_torch.launch.serve --arch gemma3-4b --smoke --device cpu

Multi-tenant overlay serving (the paper's one-pipeline-many-kernels claim
at request scale)::

  python -m repro_torch.launch.serve --overlay-demo --bank 4 --requests 64
  python -m repro_torch.launch.serve --overlay-demo --stream --tenants 4
  python -m repro_torch.launch.serve --overlay-demo --device cpu

``OverlayServer`` is an ASYNC STREAMING engine over the staged dispatch
pipeline (``Overlay.plan/assemble/execute/collect``, see core/overlay.py):

* ``submit`` returns a ticket immediately; results are retrieved with
  ``result(ticket)``, the ``as_completed()`` iterator (completion order,
  not barrier order), or a bulk ``flush()``.
* Rounds are PIPELINED: while round N executes on device, round N+1's
  host tile stack is assembled and its contexts prefetched into the bank
  (CUDA launches are async — the engine waits on a round's event only at
  result delivery).  ``flush_sync()`` keeps the drain-the-queue barrier
  loop as the bit-for-bit oracle and baseline.
* Scheduling DECISIONS are pluggable policies from :mod:`repro_torch.sched`
  (the engine here is only the mechanics — queues, staged launch,
  pinning, tickets): per-tenant token-bucket ADMISSION
  (``sched.admission``) and round formation via a ``RoundPolicy``
  (``sched.rounds``: deficit round-robin by default, cross-tenant
  coalescing and latency-adaptive round sizing as drop-ins), and — for
  the sharded fleet — replica ROUTING via a ``RouterPolicy``
  (``sched.routing``: residency affinity, optionally with cross-replica
  work stealing).  ``sched.pump.AutoPump`` wraps either engine with a
  background drain thread so concurrent ``submit`` makes progress
  without an explicit ``flush``.
* In-flight rounds pin their contexts in the ``ContextBank`` so LRU
  eviction can never reassign a slot under a launched round.
* Every device operation of a server runs on the server's own CUDA
  stream, whichever thread drives it (``OverlayServer.on_stream``).

``ShardedOverlayServer`` scales the engine to N replicas, each an
``OverlayServer`` with its own bank, behind the router policy; on one GPU
the replicas share the card, one stream each.  The fleet is ELASTIC:
``add_replica``/``drain_replica`` mutate the replica set under live
traffic (drains are loss-free — queued work evacuates over the
steal/adopt path, in-flight rounds retire, delivered results survive in
an orphan store), and an optional ``sched.autoscale.AutoscalePolicy``
drives both from observed queue pressure.

The engines run on the CUDA device unless ``device="cpu"`` (or
``devices=[torch.device("cpu"), ...]`` for the fleet) is passed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import sys
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from repro_torch.sched import (AdmissionControl, AdmissionError, AutoPump,
                               DeficitRoundRobin, Flow, OverlayRequest,
                               TokenBucket, WorkRequest, make_round_policy,
                               make_router)
from repro_torch.sched.rounds import DEFAULT_TENANT
from repro_torch.telemetry import (InMemorySink, MultiSink, adopt_counters,
                                   span)

__all__ = [
    "AdmissionControl", "AdmissionError", "AutoPump", "DEFAULT_TENANT",
    "DeficitRoundRobin", "OverlayRequest", "OverlayServer",
    "Generation", "ShardedOverlayServer", "TokenBucket", "WorkRequest",
    "lm_batch", "lm_generate", "main", "overlay_demo",
    "tenant_latency_summary",
]


#: latency percentiles reported by ``latency_percentiles`` and the
#: per-tenant ``stats()["tenant_latency"]`` tables
LATENCY_QS = (50, 95, 99)


def tenant_latency_summary(samples, qs=LATENCY_QS, slo_s=None) -> dict:
    """Per-tenant latency percentiles + SLO-attainment from raw samples.

    ``samples`` is an iterable of ``(tenant, latency_seconds)`` pairs —
    both engines feed it from their existing per-ticket records, and the
    gateway's shed decisions and the benchmark tables read the SAME
    summary, so there is one source of truth for "how is tenant X doing".
    Returns ``{tenant: {p50, p95, p99, mean, n[, slo_attained, slo_total,
    slo_attainment]}}``.

    ``slo_s`` is a delivery-latency target in seconds — attained means
    ``latency <= slo_s``.  A float applies the same target to every
    tenant; a ``{tenant: seconds}`` dict sets per-tenant SLO classes
    (the slo_study's latency vs bulk tiers) and tenants absent from the
    dict get no SLO fields; None disables SLO accounting entirely.
    """
    by_tenant: dict[str, list] = {}
    for tenant, lat in samples:
        by_tenant.setdefault(tenant, []).append(lat)
    out: dict[str, dict] = {}
    for tenant in sorted(by_tenant):
        lats = by_tenant[tenant]
        row = {f"p{q}": float(np.percentile(lats, q)) for q in qs}
        row["mean"] = float(np.mean(lats))
        row["n"] = len(lats)
        slo = slo_s.get(tenant) if isinstance(slo_s, dict) else slo_s
        if slo is not None:
            attained = sum(1 for lat in lats if lat <= slo)
            row["slo_attained"] = attained
            row["slo_total"] = len(lats)
            row["slo_attainment"] = attained / len(lats)
        out[tenant] = row
    return out


#: the staged-pipeline wall-clock counters surfaced as stats()["stage_walls"]
STAGE_WALL_KEYS = ("plan_s", "assemble_s", "execute_s", "collect_s")


def _stage_walls(telemetry) -> dict:
    """Cumulative per-stage walls of the streaming pipeline (seconds).

    ``plan_s``/``assemble_s`` are pure host work, ``execute_s`` is launch
    dispatch plus the retire-time device wait, ``collect_s`` is the
    readback + slicing.  The ``flush_sync`` barrier oracle goes through
    ``Overlay.dispatch`` and does not contribute.
    """
    return {k: float(telemetry.counter(f"engine.{k}"))
            for k in STAGE_WALL_KEYS}


def _on_own_stream(method):
    """Run an ``OverlayServer`` method with the server's stream current.

    Every method that causes a device operation (a bank write, an H2D
    copy, a launch, the ``out_idx`` gather, the delivery event, a D2H
    readback, a stream sync) enters the stream itself, so the caller's
    thread and its current stream do not matter: the ``AutoPump`` thread,
    the gateway's executor and the fleet all drive replicas safely."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with self.on_stream():
            return method(self, *args, **kwargs)
    return wrapped


def _record_event(ys):
    """An event on the current stream behind a round's launch; waiting on
    it is the round's device wait.  None where there is nothing to wait
    for (an empty round, or a CPU tensor, which is complete on return)."""
    if ys is None or not ys.is_cuda:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(ys.device))
    return event


@dataclasses.dataclass
class _Inflight:
    """A launched-but-undelivered round of the staged pipeline."""

    reqs: list                # [OverlayRequest]
    plan: object              # core.overlay.DispatchPlan (holds the pins)
    ys: object                # device result tensor, or None (empty round)
    done: object              # CUDA event behind the launch (None on the CPU)
    round_no: int
    t_launch: float = 0.0     # engine clock at launch (RoundPolicy.observe)
    work_outs: dict | None = None   # ticket -> WorkRequest fn() output


class OverlayServer:
    """Async streaming front-end over the staged dispatch pipeline.

    Lifecycle of a request:

    1. ``submit(kernel, xs, tenant=...)`` — token-bucket admission check,
       then enqueue on the tenant's flow; returns a ticket.
    2. Round formation — delegated to the injected ``RoundPolicy``
       (default :class:`~repro_torch.sched.rounds.DeficitRoundRobin`, or the
       ``REPRO_ROUND_POLICY`` env knob): at most ``round_kernels``
       distinct kernels per round, policy-specific pacing across tenant
       flows.
    3. Staged launch — ``Overlay.plan`` (pins contexts, assigns slots) →
       ``assemble`` (host tile stack) → ``execute`` (async device call).
       Up to ``max_inflight`` rounds run concurrently: round N+1 is
       planned/assembled while round N executes on device.
    4. Delivery — ``result(ticket)`` / ``as_completed()`` / ``flush()``
       block (on the round's CUDA event) only on the round actually being
       delivered; per-ticket latency is recorded, and the round's tile
       count + wall time are fed back to ``RoundPolicy.observe``.

    ``flush_sync()`` serves the same queue through the one-round-at-a-time
    barrier loop (launch, wait, deliver, repeat) — the bit-for-bit oracle
    the tests hold the streaming path to, and the baseline the benchmark
    must beat.
    """

    def __init__(self, bank_capacity: int = 8, tile: int = 128,
                 s_max: int = 16,
                 dtype=torch.float32, max_outputs: int = 8,
                 max_inflight: int = 2, round_kernels: int | None = None,
                 quantum_tiles: float | None = None,
                 round_policy=None,
                 admission: dict | None = None,
                 default_admission: tuple | None = None,
                 clock=time.monotonic, metrics_window: int = 65536,
                 device=None, slo_s=None, telemetry=None):
        from repro_torch.core.arena import RoundArena
        from repro_torch.core.bank import ContextBank
        from repro_torch.core.overlay import Overlay
        #: delivery-latency SLO target in seconds (None = no SLO
        #: accounting); a float applies to every tenant, a
        #: ``{tenant: seconds}`` dict sets per-tenant targets (tenants
        #: absent from the dict get no SLO fields).  Drives the
        #: slo_attained/slo_total counters in
        #: ``tenant_latency_percentiles`` and ``stats()``
        self.slo_s = slo_s
        #: the structured telemetry sink (see repro_torch.telemetry) every
        #: engine counter and delivery event flows through; ``stats()``
        #: and the ``n_rounds``/``n_requests``/``n_submits`` properties
        #: are read-throughs over it.
        self.telemetry = (telemetry if telemetry is not None
                          else InMemorySink(clock=clock))
        from repro_torch.core.vm import resolve_device
        #: device this server's bank + rounds live on (None = the CUDA
        #: device; raises without one)
        self.device = device = resolve_device(device)
        #: the CUDA stream every device operation of this server runs on
        #: (None on the CPU).  A replica's "device" is this (card, stream)
        #: pair: replicas of one fleet share the card, each on its own
        #: stream.  Bank writes, H2D copies, launches and readbacks are
        #: ordered on it whichever thread drives the server (see
        #: ``on_stream``), and every tensor of the server is allocated
        #: while it is current, so the caching allocator only ever hands
        #: a freed block back to this stream.
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        #: zero-copy round pipeline: the overlay assembles into pooled
        #: arena blocks (recycled at ``plan.release`` after delivery, so
        #: pipelined rounds N/N+1 each own their block) and donates the
        #: device tile stack to the executor (the kernel then runs in
        #: place) — the engine consumes each batch exactly once, which is
        #: the donation contract.  The
        #: ``flush_sync`` oracle goes through ``Overlay.dispatch``, which
        #: recycles its own block after launch.
        self.overlay = Overlay(s_max=s_max, dtype=dtype, device=device,
                               arena=RoundArena(), donate=True)
        with self.on_stream():
            self.bank = ContextBank(bank_capacity, s_max=s_max, dtype=dtype,
                                    max_outputs=max_outputs, device=device)
        self.bank.attach_arena(self.overlay.arena)
        self.tile = tile
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.max_inflight = max_inflight
        #: distinct kernels per round; <= bank capacity.  Smaller rounds
        #: trade per-launch batching for pipeline overlap (see SERVING.md).
        if round_kernels is not None and round_kernels < 1:
            raise ValueError(
                f"round_kernels must be >= 1 or None (= bank capacity), "
                f"got {round_kernels}")
        self.round_kernels = min(round_kernels or bank_capacity,
                                 bank_capacity)
        #: DRR quantum in tiles; None = unbounded (pure round-robin).
        #: Only consulted when no explicit ``round_policy`` is given —
        #: kept as a constructor knob (and validated here) for
        #: compatibility with the pre-sched engine surface.
        self.quantum_tiles = quantum_tiles
        #: the round-formation policy (see repro_torch.sched.rounds).  A string
        #: picks a registered policy by name; None consults the
        #: REPRO_ROUND_POLICY env knob (default deficit round-robin).
        if round_policy is None or isinstance(round_policy, str):
            round_policy = make_round_policy(round_policy,
                                             quantum_tiles=quantum_tiles)
        elif quantum_tiles is not None:
            # an injected policy instance carries its own quantum; the
            # engine-level knob would be silently ignored — refuse loudly
            # rather than drop the fairness bound the caller asked for
            raise ValueError(
                "quantum_tiles was given alongside a round_policy "
                "instance; set the quantum on the policy itself "
                "(engine-level quantum_tiles only configures the "
                "default/named policy)")
        self.round_policy = round_policy
        self.clock = clock
        self.admission = AdmissionControl(admission, default_admission,
                                          clock=clock)
        self._flows: dict[str, Flow] = {}
        self._rr: deque[str] = deque()      # tenant round-robin order
        self._inflight: deque[_Inflight] = deque()
        self._done: OrderedDict[int, list] = OrderedDict()
        self._records: dict[int, dict] = {}
        #: telemetry of CLAIMED tickets is kept for the last
        #: ``metrics_window`` claims only — a long-lived server must not
        #: grow per-request state forever
        self.metrics_window = metrics_window
        self._claimed: deque[int] = deque()
        self._next_ticket = 0
        self._pending_tiles = 0

    def on_stream(self):
        """Context manager making this server's stream current (a no-op on
        the CPU).  The server's own entry points enter it; code outside
        the server that writes its bank (a router's prefetch, a fleet's
        move of queued work) enters it too."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # ------------------------------------------------- counters (read-through)
    @property
    def n_submits(self) -> int:
        """Requests accepted by ``submit`` (admission-rejected excluded)."""
        return int(self.telemetry.counter("engine.submits"))

    @property
    def n_rounds(self) -> int:
        """Rounds launched (streaming and sync paths both count)."""
        return int(self.telemetry.counter("engine.rounds"))

    @property
    def n_requests(self) -> int:
        """Requests delivered to the done-store (claimed or not)."""
        return int(self.telemetry.counter("engine.delivered"))

    # ----------------------------------------------------------------- queue
    def submit(self, kernel, xs, tenant: str = DEFAULT_TENANT) -> int:
        """Admit + enqueue one request; returns its ticket immediately.

        Raises :class:`AdmissionError` (without enqueueing) when the
        tenant's token bucket cannot cover the request's tile cost.
        """
        from repro_torch.core.bank import context_key
        xs = list(xs)
        cost = -(-int(np.shape(xs[0])[0]) // self.tile)
        self.admission.admit(tenant, max(1, cost))
        t = self._next_ticket
        self._next_ticket += 1
        req = OverlayRequest(ticket=t, kernel=kernel, xs=xs, tenant=tenant,
                             key=context_key(kernel.program), cost=cost,
                             t_submit=self.clock())
        self._enqueue(req)
        self._records[t] = {"tenant": tenant, "t_submit": req.t_submit,
                            "cost": cost, "t_done": None, "round": None}
        self.telemetry.inc("engine.submits")
        return t

    def submit_work(self, fn, tenant: str = DEFAULT_TENANT, *,
                    cost: int = 1, label: str = "work",
                    key: tuple | None = None) -> int:
        """Admit + enqueue one host-side work item; returns its ticket.

        ``fn`` is a zero-arg callable the engine runs when the round
        policy grants this flow a round slot; its return value is the
        ticket's result (claimed via ``result``/``try_result``/
        ``flush``/``as_completed`` like any kernel request).  ``cost``
        is the tile budget the work charges against the tenant's
        admission bucket and flow deficit — how large the work "looks"
        to the scheduler.  This is how a bulk host-side tenant rides the
        SAME rounds/tickets/telemetry as serving traffic: the scheduler
        decides when bulk work runs, not a side channel.
        """
        cost = max(1, int(cost))
        self.admission.admit(tenant, cost)
        t = self._next_ticket
        self._next_ticket += 1
        req = WorkRequest(ticket=t, kernel=None, xs=[], tenant=tenant,
                          key=key if key is not None
                          else ("__work__", tenant, label),
                          cost=cost, t_submit=self.clock(), fn=fn,
                          label=label)
        self._enqueue(req)
        self._records[t] = {"tenant": tenant, "t_submit": req.t_submit,
                            "cost": cost, "t_done": None, "round": None}
        self.telemetry.inc("engine.submits")
        return t

    def _enqueue(self, req: OverlayRequest) -> None:
        flow = self._flows.get(req.tenant)
        if flow is None:
            flow = self._flows[req.tenant] = Flow(queue=deque())
            self._rr.append(req.tenant)
        flow.queue.append(req)
        self._pending_tiles += req.cost

    @property
    def pending(self) -> int:
        """Requests submitted but not yet delivered (queued + in flight)."""
        queued = sum(len(f.queue) for f in self._flows.values())
        return queued + sum(len(i.reqs) for i in self._inflight)

    @property
    def pending_tiles(self) -> int:
        """Undelivered work in dispatch tiles — the sharded router's load
        signal for least-loaded fallback and migration decisions.  A
        running counter (submit adds, delivery subtracts): the router
        reads this for every replica on every submit, so it must not
        scan the queues."""
        return self._pending_tiles

    @property
    def queued(self) -> int:
        """Requests queued but not yet launched (excludes in flight)."""
        return sum(len(f.queue) for f in self._flows.values())

    @property
    def queued_tiles(self) -> int:
        """Queued-only work in dispatch tiles — what a work-stealing
        router may move (in-flight rounds are never stolen).  Scans the
        queues, so it is read at rebalance time, not per submit."""
        return sum(r.cost for f in self._flows.values() for r in f.queue)

    def queued_by_tenant(self) -> dict[str, int]:
        """Queued-only tiles per tenant (drained flows absent).  A bulk
        tenant's yield-point probe — "is latency-tier work waiting?".
        Scans the queues, so it is for boundary checks, not per-submit
        hot paths."""
        return {t: sum(r.cost for r in f.queue)
                for t, f in self._flows.items() if f.queue}

    # ------------------------------------------------------- round formation
    def _form_round(self) -> list | None:
        """Prune drained flows, then ask the round policy for the next
        round (None = nothing queued)."""
        # prune drained flows: a long-lived server over an unbounded
        # tenant-label space must not scan every tenant ever seen per
        # round (flows are recreated on the tenant's next submit)
        with span("engine.form_round"):
            for tenant in [t for t in self._rr if not self._flows[t].queue]:
                del self._flows[tenant]
                self._rr.remove(tenant)
            return self.round_policy.form_round(self._flows, self._rr,
                                                self.round_kernels)

    def make_preemptible(self, bulk_tenants=(), bulk_prefix=None):
        """Wrap this engine's round policy in a
        :class:`~repro_torch.sched.preempt.PreemptibleTier` in place and
        return the tier.  Idempotent: repeated calls merge their
        ``bulk_tenants`` into the existing tier.  After this, flows of
        the named tenants (or any tenant matching the bulk prefix) only
        form rounds when every latency-tier flow is idle."""
        from repro_torch.sched.preempt import BULK_PREFIX, PreemptibleTier
        if isinstance(self.round_policy, PreemptibleTier):
            self.round_policy.add_bulk(bulk_tenants)
            return self.round_policy
        self.round_policy = PreemptibleTier(
            self.round_policy, bulk_tenants=bulk_tenants,
            bulk_prefix=bulk_prefix if bulk_prefix is not None
            else BULK_PREFIX)
        return self.round_policy

    # ------------------------------------------------------- round formation
    # ---------------------------------------------------------- work stealing
    def queued_group_keys(self) -> dict:
        """``{context key: kernel}`` over every QUEUED request — the units
        ``steal_queued`` moves.  A work-stealing router or a drain path
        enumerates an engine's evacuable work through this."""
        groups: dict = {}
        for flow in self._flows.values():
            for r in flow.queue:
                groups.setdefault(r.key, r.kernel)
        return groups

    def steal_queued(self, key: tuple) -> list[tuple[OverlayRequest, dict]]:
        """Remove every QUEUED request whose context key is ``key`` and
        hand back ``(request, telemetry record)`` pairs, per-tenant
        arrival order preserved.

        The work-stealing router's victim hook: in-flight rounds (and
        their pins) are untouched — only queued work moves.  The caller
        must re-home every pair via ``adopt_queued`` on another replica;
        the tickets in the returned requests are STALE (this engine has
        forgotten them).
        """
        stolen: list[tuple[OverlayRequest, dict]] = []
        for flow in self._flows.values():
            if not any(r.key == key for r in flow.queue):
                continue
            kept: deque = deque()
            for r in flow.queue:
                if r.key == key:
                    stolen.append((r, self._records.pop(r.ticket)))
                else:
                    kept.append(r)
            flow.queue = kept
            if not kept:
                flow.deficit = 0.0      # drained by the steal = idle
        self._pending_tiles -= sum(r.cost for r, _ in stolen)
        return stolen

    def adopt_queued(self, req: OverlayRequest, record: dict) -> int:
        """Enqueue a request stolen from another replica under a fresh
        local ticket; returns it.  The original submit telemetry
        (tenant, cost, t_submit) rides along, so delivery latency spans
        the steal."""
        t = self._next_ticket
        self._next_ticket += 1
        req = dataclasses.replace(req, ticket=t)
        self._enqueue(req)
        self._records[t] = record
        return t

    # ------------------------------------------------------ staged pipeline
    def _run_work(self, work_reqs: list) -> dict:
        """Run a round's work callables (request order) host-side; the
        shared execution point of the streaming and ``flush_sync``
        paths, so a work item's observable order is identical on both."""
        return {r.ticket: r.fn() for r in work_reqs}

    @_on_own_stream
    def _launch_round(self, reqs: list) -> None:
        """plan (pinned) -> assemble -> execute; delivery happens later.

        Work requests carry no kernel: the device stages skip them, their
        callables run host-side at launch (after the device call is
        dispatched, so host work overlaps device execution), and their
        outputs deliver through the normal ticket path at retire."""
        from repro_torch.core.bank import BankError
        kern_reqs = [r for r in reqs if not isinstance(r, WorkRequest)]
        work_reqs = [r for r in reqs if isinstance(r, WorkRequest)]
        if not kern_reqs:
            work_outs = self._run_work(work_reqs)
            round_no = int(self.telemetry.inc("engine.rounds")) - 1
            self._inflight.append(_Inflight(reqs=reqs, plan=None, ys=None,
                                            done=None, round_no=round_no,
                                            t_launch=self.clock(),
                                            work_outs=work_outs))
            return
        round_kernels = {r.key: r.kernel for r in kern_reqs}
        needed = sum(1 for k in round_kernels.values() if k not in self.bank)
        # retire in-flight rounds until the round's NEW contexts fit the
        # unpinned portion of the bank; the round's own resident kernels
        # are excluded — they will be pinned, not evicted, so their slots
        # cannot satisfy a new context's demand
        while self._inflight and self.bank.evictable_capacity(
                excluding=round_kernels) < needed:
            self._retire_oldest()
        pairs = [(r.kernel, r.xs) for r in kern_reqs]
        plan_s = 0.0
        with span("overlay.plan"):
            while True:
                t0 = self.clock()
                try:
                    plan = self.overlay.plan(self.bank, pairs,
                                             tile=self.tile, pin=True)
                    plan_s += self.clock() - t0
                    break
                except BankError:
                    # belt-and-braces: plan unwinds its own pins on failure,
                    # so retiring one more round and retrying is always safe
                    plan_s += self.clock() - t0
                    if not self._inflight:
                        raise
                    self._retire_oldest()
        t1 = self.clock()
        batch = self.overlay.assemble(plan)
        t2 = self.clock()
        with span("overlay.launch"):
            ys = self.overlay.execute(self.bank, batch)
            done = _record_event(ys)
        # stage walls (streaming path only; flush_sync goes through the
        # dispatch oracle): plan/assemble are host work, execute here is
        # launch dispatch — the device wait lands in execute_s at retire
        self.telemetry.inc("engine.plan_s", plan_s)
        self.telemetry.inc("engine.assemble_s", t2 - t1)
        self.telemetry.inc("engine.execute_s", self.clock() - t2)
        work_outs = self._run_work(work_reqs) if work_reqs else None
        round_no = int(self.telemetry.inc("engine.rounds")) - 1
        self._inflight.append(_Inflight(reqs=reqs, plan=plan, ys=ys,
                                        done=done, round_no=round_no,
                                        t_launch=self.clock(),
                                        work_outs=work_outs))

    @_on_own_stream
    def _retire_oldest(self) -> list:
        """Deliver the oldest in-flight round; returns its tickets."""
        inf = self._inflight.popleft()
        t0 = self.clock()
        with span("engine.wait"):     # the device wait, apart from readback
            if inf.done is not None:
                inf.done.synchronize()
        t1 = self.clock()
        # host=True: live tiles/rows sliced device-side, one readback;
        # per-request slicing is numpy views, never device-op dispatch
        # (pure-work rounds have no plan and skip the device stages)
        with span("overlay.collect"):
            outs = (self.overlay.collect(inf.plan, inf.ys, host=True)
                    if inf.plan is not None else [])
        now = self.clock()
        self.telemetry.inc("engine.execute_s", t1 - t0)   # device wait
        self.telemetry.inc("engine.collect_s", now - t1)
        with span("engine.deliver"):
            tickets = []
            kern_outs = iter(outs)
            for r in inf.reqs:
                y = (inf.work_outs[r.ticket] if isinstance(r, WorkRequest)
                     else next(kern_outs))
                self._done[r.ticket] = y
                rec = self._records[r.ticket]
                rec["t_done"] = now
                rec["round"] = inf.round_no
                tickets.append(r.ticket)
                self.telemetry.event("deliver", tenant=r.tenant,
                                     cost=r.cost, round=inf.round_no,
                                     latency_s=now - rec["t_submit"])
            if inf.plan is not None:
                inf.plan.release(self.bank)
            round_cost = sum(r.cost for r in inf.reqs)
            self._pending_tiles -= round_cost
            self.telemetry.inc("engine.delivered", len(inf.reqs))
            self.telemetry.log_step(inf.round_no, tiles=round_cost,
                                    requests=len(inf.reqs),
                                    wall_s=now - inf.t_launch)
            # feedback edge: adaptive policies size future rounds off this.
            # Units are per-request ceil tiles (r.cost) — the SAME units the
            # policies budget rounds in (and flush_sync reports), never the
            # plan's merged group tiles, or a budget-vs-observation mismatch
            # would stall DynamicTilePolicy's growth on sub-tile requests
            self.round_policy.observe(round_cost, now - inf.t_launch)
            return tickets

    def _fill_pipeline(self) -> None:
        while len(self._inflight) < self.max_inflight:
            reqs = self._form_round()
            if reqs is None:
                return
            self._launch_round(reqs)

    def pump_once(self) -> bool:
        """One unit of drain work: top up the pipeline, deliver the
        oldest in-flight round.  Returns False when idle (nothing queued,
        nothing in flight) — the loop edge for a background drain thread."""
        self._fill_pipeline()
        if not self._inflight:
            return False
        self._retire_oldest()
        return True

    def _note_claimed(self, tickets) -> None:
        """Record claims and prune telemetry beyond ``metrics_window``."""
        self._claimed.extend(tickets)
        while len(self._claimed) > self.metrics_window:
            self._records.pop(self._claimed.popleft(), None)

    # -------------------------------------------------------------- retrieve
    def try_result(self, ticket: int):
        """Non-blocking claim: the ticket's outputs if already delivered,
        else None (still queued or in flight).  Raises KeyError for
        unknown or already-claimed tickets, like ``result``."""
        if ticket in self._done:
            self._note_claimed([ticket])
            return self._done.pop(ticket)
        if ticket not in self._records:
            raise KeyError(f"unknown ticket {ticket}")
        if self._records[ticket]["t_done"] is not None:
            raise KeyError(f"ticket {ticket} already claimed")
        return None

    def result(self, ticket: int):
        """Block until ``ticket``'s outputs are ready and return them.

        Drives the pipeline as needed; each claim pops the result (a
        ticket can be claimed once, via ``result``/``as_completed``/
        ``flush``).
        """
        if ticket not in self._records and ticket not in self._done:
            raise KeyError(f"unknown ticket {ticket}")
        while ticket not in self._done:
            if self._records[ticket]["t_done"] is not None:
                raise KeyError(f"ticket {ticket} already claimed")
            self._fill_pipeline()
            if not self._inflight:
                raise KeyError(f"ticket {ticket} is not queued (lost?)")
            self._retire_oldest()
        self._note_claimed([ticket])
        return self._done.pop(ticket)

    def as_completed(self):
        """Yield ``(ticket, outputs)`` in COMPLETION order, streaming.

        Rounds are delivered as they finish (arrival order, not the
        submission-barrier order of ``flush``); within a round, tickets
        come back grouped by kernel (round assembly batches per kernel),
        in submission order within each kernel.  New ``submit`` calls
        made while iterating are picked up — iteration ends when the
        server is idle.
        """
        while True:
            if self._done:
                ticket, outs = self._done.popitem(last=False)
                self._note_claimed([ticket])
                yield ticket, outs
                continue
            self._fill_pipeline()
            if not self._inflight:
                return
            self._retire_oldest()

    def flush(self) -> dict[int, list]:
        """Serve everything queued; returns {ticket: outputs}.

        Pipelined drain: up to ``max_inflight`` rounds overlap, so round
        N+1's host assembly and context prefetch hide under round N's
        device execution; the device is never left idle waiting for the
        host between rounds (compare ``flush_sync``).
        """
        while True:
            self._fill_pipeline()
            if not self._inflight:
                break
            self._retire_oldest()
        results = dict(self._done)
        self._done.clear()
        self._note_claimed(results)
        return results

    def flush_sync(self) -> dict[int, list]:
        """Barrier drain: one round at a time, waiting on each.

        Identical round formation and dispatch math to ``flush`` — only
        the overlap is missing, which makes this the bit-for-bit oracle
        for the streaming path and the baseline it must beat.  Outputs
        are device tensors, complete on return.
        """
        caller = (torch.cuda.current_stream(self.device)
                  if self.stream is not None else None)
        results = self._flush_sync()
        if caller is not None and caller != self.stream:
            # the one place a tensor of this server leaves its stream: the
            # caller reads the outputs on its own stream, so their blocks
            # must not return to this stream's pool before that stream
            # has finished with them
            for outs in results.values():
                for y in outs:
                    if isinstance(y, torch.Tensor) and y.is_cuda:
                        y.record_stream(caller)
        return results

    @_on_own_stream
    def _flush_sync(self) -> dict[int, list]:
        # rounds already launched by the pipelined API belong to this
        # drain too: deliver them first (releasing their pins) so no
        # ticket is dropped and no pin outlives its round
        while self._inflight:
            self._retire_oldest()
        results: dict[int, list] = {}
        while (reqs := self._form_round()) is not None:
            t_launch = self.clock()
            kern_reqs = [r for r in reqs if not isinstance(r, WorkRequest)]
            work_reqs = [r for r in reqs if isinstance(r, WorkRequest)]
            outs = (self.overlay.dispatch(
                self.bank, [(r.kernel, r.xs) for r in kern_reqs],
                tile=self.tile) if kern_reqs else [])
            if self.stream is not None:
                self.stream.synchronize()
            work_outs = self._run_work(work_reqs) if work_reqs else {}
            now = self.clock()
            round_no = int(self.telemetry.inc("engine.rounds")) - 1
            kern_outs = iter(outs)
            for r in reqs:
                y = (work_outs[r.ticket] if isinstance(r, WorkRequest)
                     else next(kern_outs))
                results[r.ticket] = y
                self._records[r.ticket].update(t_done=now, round=round_no)
                self.telemetry.event(
                    "deliver", tenant=r.tenant, cost=r.cost, round=round_no,
                    latency_s=now - self._records[r.ticket]["t_submit"])
            round_cost = sum(r.cost for r in reqs)
            self._pending_tiles -= round_cost
            self.telemetry.inc("engine.delivered", len(reqs))
            self.telemetry.log_step(round_no, tiles=round_cost,
                                    requests=len(reqs),
                                    wall_s=now - t_launch)
            self.round_policy.observe(round_cost, now - t_launch)
        results.update(self._done)
        self._done.clear()
        self._note_claimed(results)
        return results

    # --------------------------------------------------------------- metrics
    def latencies(self) -> dict[int, float]:
        """Per-delivered-ticket submit->delivery seconds."""
        return {t: rec["t_done"] - rec["t_submit"]
                for t, rec in self._records.items()
                if rec["t_done"] is not None}

    def latency_percentiles(self, qs=LATENCY_QS) -> dict[str, float]:
        lats = list(self.latencies().values())
        if not lats:
            return {f"p{q}": float("nan") for q in qs}
        return {f"p{q}": float(np.percentile(lats, q)) for q in qs}

    def tenant_latencies(self):
        """Yield ``(tenant, latency_seconds)`` per delivered ticket."""
        for rec in self._records.values():
            if rec["t_done"] is not None:
                yield rec["tenant"], rec["t_done"] - rec["t_submit"]

    def tenant_latency_percentiles(self, qs=LATENCY_QS) -> dict:
        """Per-tenant p50/p95/p99 + SLO attainment (see
        :func:`tenant_latency_summary`); SLO fields appear when the
        engine was built with ``slo_s``."""
        return tenant_latency_summary(self.tenant_latencies(), qs=qs,
                                      slo_s=self.slo_s)

    def record(self, ticket: int) -> dict:
        """Telemetry for one ticket (tenant, cost, submit/done, round)."""
        return dict(self._records[ticket])

    def reset_metrics(self) -> None:
        """Drop delivered-ticket telemetry (e.g. after a warmup drain) so
        percentiles reflect steady state, not the kernel's build.

        Records of pending tickets and of delivered-but-unclaimed results
        (still claimable via ``result``/``flush``) are kept.
        """
        self._records = {t: r for t, r in self._records.items()
                         if r["t_done"] is None or t in self._done}
        self._claimed.clear()

    def stats(self) -> dict:
        s = dict(self.bank.stats())
        s.update({"submits": self.n_submits,
                  "rounds": self.n_rounds, "requests": self.n_requests,
                  "pending": self.pending, "inflight": len(self._inflight),
                  "queued": self.queued, "queued_tiles": self.queued_tiles,
                  "tenants": len(self._flows),
                  "round_policy": type(self.round_policy).__name__,
                  "stage_walls": _stage_walls(self.telemetry),
                  "tenant_latency": self.tenant_latency_percentiles()})
        return s


# ==================================================== sharded serving layer
class ShardedOverlayServer:
    """Policy-routed serving over N per-replica context banks.

    The paper keeps ONE time-multiplexed FU pipeline hot by making a
    kernel switch an index; the single-bank ``OverlayServer`` scales that
    to one device.  This layer scales it ACROSS devices the way many-core
    overlays replicate the overlay fabric — except replicas are not
    mirrors: each hosts its own ``ContextBank`` working set (affinity, not
    replication), so aggregate residency grows with the fleet while each
    replica's instruction store stays small.

    * ROUTING + REBALANCING are delegated to a
      :class:`~repro_torch.sched.routing.RouterPolicy`.  The default
      :class:`~repro_torch.sched.routing.ResidencyRouter` keys every request by
      context content, routes residency hits to the owning replica
      (directory entries validated by residency generation), falls back
      least-loaded on miss/stale, and migrates hot contexts with
      hysteresis + cooldown.  ``steal=True`` swaps in the
      :class:`~repro_torch.sched.routing.WorkStealingRouter`: at drain time an
      idle replica pulls whole queued kernel-groups from the
      most-backlogged replica (context prefetched on the thief first,
      directory republished, in-flight rounds never touched).
    * ADMISSION — token buckets live HERE, spanning replicas, so a
      tenant's rate cannot be dodged by its kernels landing on different
      replicas.  Per-replica round-policy fairness is unchanged
      underneath.
    * DELIVERY — tickets are global; ``flush``/``as_completed``/``result``
      merge the per-replica pipelines.  The drain interleaves round
      launches across replicas before blocking on any of them, so rounds
      of different replicas may execute concurrently (CUDA launches are
      asynchronous, and each replica has its own stream).
      ``flush_sync`` drains replica-by-replica with the barrier loop — the
      oracle path (no pipelining, no stealing).

    Every replica is a full ``OverlayServer`` on one device of
    ``launch.mesh.make_serving_mesh`` (devices wrap when the fleet is
    larger than the machine — correctness never depends on real device
    count).  On one GPU every replica shares the card, each on its own
    CUDA stream; fleet code that writes a replica's bank (the router's
    prefetch, ``move_group``) enters that replica's stream, and a
    replica's own methods enter it for everything else.

    * ELASTICITY — the replica set is mutable under live traffic:
      ``add_replica()`` grows the fleet onto the least-shared physical
      device, ``drain_replica(i)`` decommissions one replica loss-free
      (evacuate queued work via steal/adopt, retire in-flight rounds,
      orphan delivered-but-unclaimed results at the fleet level,
      unpublish + generation-bump its directory entries, compact
      indices).  Passing ``autoscaler=`` (see
      :mod:`repro_torch.sched.autoscale`) automates both from queue pressure,
      observed on every drain pass and autopump tick; ``flush_sync``
      never scales — it stays the oracle.
    """

    def __init__(self, n_replicas: int = 2, bank_capacity: int = 8,
                 tile: int = 128, s_max: int = 16,
                 dtype=torch.float32, max_outputs: int = 8,
                 max_inflight: int = 2, round_kernels: int | None = None,
                 quantum_tiles: float | None = None,
                 round_policy=None, router=None, steal: bool = False,
                 admission: dict | None = None,
                 default_admission: tuple | None = None,
                 clock=time.monotonic, metrics_window: int = 65536,
                 devices=None, migrate_factor: float = 4.0,
                 migrate_min_tiles: int = 16, migrate_cooldown: int = 32,
                 steal_min_tiles: int = 4, autoscaler=None,
                 slo_s=None, telemetry=None):
        from repro_torch.core.vm import resolve_device
        from repro_torch.launch.mesh import cuda_devices, make_serving_mesh
        #: fleet-wide delivery-latency SLO target (seconds, or a
        #: ``{tenant: seconds}`` dict of SLO classes); replicas inherit
        #: it, so per-tenant SLO attainment aggregates cleanly
        self.slo_s = slo_s
        #: the fleet's shared telemetry sink: every replica writes
        #: through ``MultiSink(own, this)``, so fleet aggregates (rounds,
        #: deliveries, evictions) accumulate here across replicas that
        #: have since been drained — no hand-folded ``_retired_*`` state.
        #: The router and autoscaler are re-bound to it too.
        self.telemetry = (telemetry if telemetry is not None
                          else InMemorySink(clock=clock))
        #: candidate devices for replica placement — the pool elastic
        #: scale-ups draw from (add_replica picks its least-shared member).
        #: None = every CUDA device (raises without one).
        self._device_pool = ([resolve_device(d) for d in devices]
                             if devices is not None else cuda_devices())
        self.devices = make_serving_mesh(n_replicas, self._device_pool)
        self.tile = tile
        # each replica builds its OWN round policy (policies may carry
        # feedback state, e.g. DynamicTilePolicy's adapted budget): a
        # string/None resolves per replica, a zero-arg factory is invoked
        # per replica.  Passing one policy INSTANCE shares it across
        # replicas — fine for stateless pacing, use a factory otherwise.
        def _policy_for_replica():
            return round_policy() if callable(round_policy) else round_policy
        self._policy_factory = _policy_for_replica
        #: constructor knobs every replica shares — kept so elastic
        #: scale-ups (``add_replica``) build replicas identical to the
        #: founding fleet.  Replicas do NOT get admission policies:
        #: admission is global.
        self._replica_kw = dict(
            bank_capacity=bank_capacity, tile=tile,
            s_max=s_max, dtype=dtype, max_outputs=max_outputs,
            max_inflight=max_inflight, round_kernels=round_kernels,
            quantum_tiles=quantum_tiles, clock=clock,
            metrics_window=metrics_window, slo_s=slo_s)
        self.replicas = [
            OverlayServer(round_policy=_policy_for_replica(), device=d,
                          telemetry=self._replica_sink(),
                          **self._replica_kw)
            for d in self.devices]
        #: the routing policy (see repro_torch.sched.routing); ``steal=True``
        #: without an explicit router builds a WorkStealingRouter
        self.router = router if router is not None else make_router(
            steal=steal, migrate_factor=migrate_factor,
            migrate_min_tiles=migrate_min_tiles,
            migrate_cooldown=migrate_cooldown,
            steal_min_tiles=steal_min_tiles)
        #: the fleet-sizing policy (see repro_torch.sched.autoscale); None =
        #: static fleet.  Observed once per drain pass / pump tick.
        self.autoscaler = autoscaler
        # re-bind the router's and autoscaler's sinks onto the fleet's,
        # carrying over anything they counted pre-binding, so one sink
        # holds the whole serving story (guarded: the protocols don't
        # require a telemetry attribute of custom policies)
        for part in (self.router, self.autoscaler):
            sink = getattr(part, "telemetry", None)
            if sink is not None and sink is not self.telemetry:
                adopt_counters(self.telemetry, sink)
                part.telemetry = self.telemetry
        self.admission = AdmissionControl(admission, default_admission,
                                          clock=clock)
        self.clock = clock
        self.metrics_window = metrics_window
        #: (bulk tenant set, bulk prefix) once make_preemptible was
        #: called — future add_replica replicas get the tier installed
        self._bulk_spec: tuple[set, str] | None = None
        self._owner: dict[int, tuple[int, int]] = {}   # global -> (rep, loc)
        self._global: list[dict[int, int]] = [
            {} for _ in self.replicas]                 # rep: loc -> global
        #: results whose replica was decommissioned before the client
        #: claimed them: global ticket -> outputs (and the matching
        #: telemetry records).  Every claim path checks here first.
        self._orphaned: OrderedDict[int, list] = OrderedDict()
        self._orphan_records: dict[int, dict] = {}
        self._claimed: deque[int] = deque()
        self._next_ticket = 0
        self._rr = 0                                   # retire fan-in ptr
        # elastic-fleet telemetry
        self._born = [self.clock() for _ in self.replicas]
        #: high-water fleet size since construction (benchmarks reset it
        #: per measurement window to integrate capacity over time)
        self.peak_replicas = len(self.replicas)

    def _replica_sink(self):
        """A fresh replica's sink: its own store fanned into the fleet's.

        Reads (per-replica ``stats()``) come from the replica's own
        store; every write also lands in the shared fleet sink, which is
        how rounds/deliveries/evictions served by since-retired replicas
        stay in the fleet aggregates after ``drain_replica``.
        """
        return MultiSink(InMemorySink(clock=self._replica_kw["clock"]),
                         self.telemetry)

    # ------------------------------------------------- counters (read-through)
    @property
    def n_submits(self) -> int:
        return int(self.telemetry.counter("fleet.submits"))

    @property
    def n_scale_ups(self) -> int:
        return int(self.telemetry.counter("fleet.scale_ups"))

    @property
    def n_scale_downs(self) -> int:
        return int(self.telemetry.counter("fleet.scale_downs"))

    @property
    def n_evacuated_requests(self) -> int:
        return int(self.telemetry.counter("fleet.evacuated_requests"))

    @property
    def n_evacuated_tiles(self) -> int:
        return int(self.telemetry.counter("fleet.evacuated_tiles"))

    @property
    def n_replicas_retired(self) -> int:
        return int(self.telemetry.counter("fleet.replicas_retired"))

    @property
    def retired_lifetime_s(self) -> float:
        return float(self.telemetry.counter("fleet.retired_lifetime_s"))

    @property
    def n_replicas(self) -> int:
        """Live replica count (mutates under elastic autoscaling)."""
        return len(self.replicas)

    @property
    def banks(self):
        """Per-replica ContextBanks, replica order."""
        return [rep.bank for rep in self.replicas]

    # --------------------------------------------- router-facing delegation
    @property
    def directory(self):
        """The router's shared BankDirectory (residency cache)."""
        return self.router.directory

    @property
    def n_route_hits(self) -> int:
        return self.router.n_hits

    @property
    def n_route_misses(self) -> int:
        return self.router.n_misses

    @property
    def n_migrations(self) -> int:
        return self.router.n_migrations

    @property
    def n_steals(self) -> int:
        return getattr(self.router, "n_steals", 0)

    @property
    def residency_hit_rate(self) -> float:
        """Routed-to-resident-replica fraction (stale hits count as
        misses); NaN before any routing decision."""
        return self.router.hit_rate

    def adopt_stolen(self, victim: int, thief: int, stolen) -> None:
        """Re-home stolen queued requests' global tickets — the router's
        bookkeeping hook after ``replicas[victim].steal_queued``.  Each
        request gets a fresh local ticket on the thief; its global ticket
        (what the client holds) follows it."""
        for req, rec in stolen:
            g = self._global[victim].pop(req.ticket)
            loc = self.replicas[thief].adopt_queued(req, rec)
            self._owner[g] = (thief, loc)
            self._global[thief][loc] = g

    def move_group(self, victim: int, thief: int, key: tuple,
                   kernel) -> list:
        """Move one queued kernel-group from ``victim`` to ``thief``;
        returns the moved requests (possibly empty).

        THE single implementation of the cross-replica move sequence —
        ``WorkStealingRouter.rebalance`` and ``drain_replica`` both call
        it — so the ordering invariant lives in one place: the thief's
        bank prefetches the context FIRST (a ``BankError`` propagates
        with nothing moved — the caller picks another thief or skips),
        the directory is republished so follow-up traffic chases the
        work, then the queued requests leave the victim and are adopted
        under fresh thief tickets with their global tickets re-homed.
        In-flight rounds and pins are never touched.

        Work-request groups (``kernel is None`` — host-side work has no
        context) skip the prefetch/republish steps: they are moved by
        queue surgery alone, which is how ``drain_replica`` evacuates a
        training tenant's queued micro-rounds loss-free.
        """
        thief_rep = self.replicas[thief]
        if kernel is not None:
            with thief_rep.on_stream():     # a write of the thief's bank
                thief_rep.bank.prefetch([kernel])
            self.directory.republish_current(kernel, thief, thief_rep.bank)
        stolen = self.replicas[victim].steal_queued(key)
        self.adopt_stolen(victim, thief, stolen)
        return [req for req, _ in stolen]

    # ------------------------------------------------------- elastic fleet
    def add_replica(self, device=None) -> int:
        """Grow the fleet by one replica; returns its index.

        The new replica is a full ``OverlayServer`` built with the
        founding fleet's knobs (its own round policy instance, its own
        device-committed ``ContextBank``), placed on ``device`` or — the
        autoscaling default — on the physical device currently hosting
        the FEWEST replicas (``launch.mesh.least_shared_device``), so
        grown capacity is real parallelism before it is time-slicing.
        The router needs no registration: an empty bank simply never
        validates a directory entry, and the least-loaded fallback (plus
        a stealing router's ``rebalance``) starts feeding the newcomer
        immediately.
        """
        from repro_torch.core.vm import resolve_device
        from repro_torch.launch.mesh import least_shared_device
        device = (least_shared_device(self._device_pool, self.devices)
                  if device is None else resolve_device(device))
        rep = OverlayServer(round_policy=self._policy_factory(),
                            device=device, telemetry=self._replica_sink(),
                            **self._replica_kw)
        if self._bulk_spec is not None:
            rep.make_preemptible(self._bulk_spec[0],
                                 bulk_prefix=self._bulk_spec[1])
        self.replicas.append(rep)
        self.devices.append(device)
        self._global.append({})
        self._born.append(self.clock())
        self.peak_replicas = max(self.peak_replicas, len(self.replicas))
        self.telemetry.inc("fleet.scale_ups")
        self.telemetry.event("scale_up", replica=len(self.replicas) - 1,
                             device=str(device), fleet=len(self.replicas))
        return len(self.replicas) - 1

    def drain_replica(self, i: int) -> dict:
        """Loss-free decommission of replica ``i``; returns telemetry.

        The drain lifecycle:

        1. EVACUATE queued work: every queued kernel-group moves to the
           least-loaded surviving replica over the existing steal/adopt
           path — context prefetched on the target FIRST, directory
           republished, global tickets re-homed (``adopt_stolen``), so
           clients notice nothing.  A momentarily all-pinned target
           retires one of its in-flight rounds and the evacuation
           retries.
        2. RETIRE in-flight rounds: delivered through the normal path,
           releasing their pins — pins are never broken, launched rounds
           always complete on the device that planned them.
        3. ORPHAN delivered-but-unclaimed results (and the replica's
           ticket telemetry) into a fleet-level store; every claim path
           (``result``/``try_result``/``as_completed``/``flush``) checks
           it first, so tickets survive their replica.
        4. UNPUBLISH the replica's ``BankDirectory`` entries and retire
           its bank (generation bump): any stale residency snapshot now
           fails validation and falls back to the miss path instead of
           resolving to a decommissioned replica.
        5. DECOMMISSION: the replica leaves the fleet and indices
           compact (directory + ticket maps renumbered).

        Raises ``ValueError`` for the last replica (a fleet of zero can
        serve nothing; ``AutoscalePolicy.min_replicas`` should prevent
        this upstream) and ``IndexError`` for an unknown index.
        """
        from repro_torch.core.bank import BankError
        if not 0 <= i < len(self.replicas):
            raise IndexError(
                f"drain_replica: no replica {i} (fleet has "
                f"{len(self.replicas)})")
        if len(self.replicas) <= 1:
            raise ValueError("drain_replica: cannot drain the last replica")
        rep = self.replicas[i]
        evac_requests = evac_tiles = 0
        while rep.queued:
            # one scan per pass: queued_group_keys walks every queued
            # request, so iterate the whole group map rather than
            # rebuilding it per group (the outer while normally runs
            # once — it only re-enters if a move legitimately left work)
            for key, kernel in list(rep.queued_group_keys().items()):
                while True:
                    order = sorted(
                        (j for j in range(len(self.replicas)) if j != i),
                        key=lambda j: self.replicas[j].pending_tiles)
                    moved = None
                    for j in order:
                        try:
                            moved = self.move_group(i, j, key, kernel)
                            break
                        except BankError:
                            continue
                    if moved is not None:
                        break
                    # every surviving bank is momentarily all pinned:
                    # retire the least-loaded survivor's oldest round
                    # (released pins free slots) and retry — pins only
                    # exist while rounds are in flight, so this always
                    # makes progress
                    survivor = self.replicas[order[0]]
                    if not survivor._inflight:
                        raise BankError(
                            "drain_replica: no surviving replica can "
                            "host the evacuated context")
                    survivor._retire_oldest()   # on the survivor's stream
                evac_requests += len(moved)
                evac_tiles += sum(r.cost for r in moved)
        while rep._inflight:
            rep._retire_oldest()        # on the drained replica's stream
        orphaned_now = len(rep._done)
        for loc, outs in rep._done.items():
            self._orphaned[self._global[i][loc]] = outs
        rep._done.clear()
        for loc, record in rep._records.items():
            g = self._global[i].get(loc)
            if g is not None:      # claimed + pruned records have no global
                self._orphan_records[g] = record
        for g in self._global[i].values():
            self._owner.pop(g, None)
        self.directory.remove_replica(i)
        rep.bank.retire()
        # the replica's rounds/deliveries already live in the shared
        # fleet sink (every replica writes through MultiSink(own, fleet))
        # so fleet stats() keeps them for free; bank evictions are the
        # one per-replica counter that does NOT flow through the engine
        # sink — fold them here before the bank goes away
        self.telemetry.inc("fleet.retired_evictions", rep.bank.n_evictions)
        self.replicas.pop(i)
        self.devices.pop(i)
        self._global.pop(i)
        lifetime = self.clock() - self._born.pop(i)
        self.telemetry.inc("fleet.scale_downs")
        self.telemetry.inc("fleet.replicas_retired")
        self.telemetry.inc("fleet.retired_lifetime_s", lifetime)
        self.telemetry.inc("fleet.evacuated_requests", evac_requests)
        self.telemetry.inc("fleet.evacuated_tiles", evac_tiles)
        self.telemetry.inc("fleet.orphaned_results", orphaned_now)
        self.telemetry.event("scale_down", replica=i, lifetime_s=lifetime,
                             evacuated_requests=evac_requests,
                             evacuated_tiles=evac_tiles,
                             orphaned_results=orphaned_now,
                             fleet=len(self.replicas))
        self._owner = {t: ((r - 1, loc) if r > i else (r, loc))
                       for t, (r, loc) in self._owner.items()}
        return {"replica": i, "evacuated_requests": evac_requests,
                "evacuated_tiles": evac_tiles,
                "orphaned_results": orphaned_now,
                "lifetime_s": lifetime}

    def autoscale_once(self) -> int:
        """Observe the autoscaler and apply its decisions; returns how
        many actions were applied.  Called from every drain pass and the
        pump tick; a no-op without an autoscaler.  The shell re-checks
        its own invariants (never below one replica, index still live),
        so a policy bug degrades to a skipped action."""
        if self.autoscaler is None:
            return 0
        # "down" indices refer to the fleet AS OBSERVED: applying an
        # earlier action compacts indices, so resolve each index to its
        # replica object first and re-look it up at apply time — a later
        # action from the same snapshot can never target the wrong
        # replica, and one already drained degrades to a skipped action
        snapshot = list(self.replicas)
        # the shell-side runaway guard: honor the policy's own declared
        # ceiling (PressureAutoscaler always carries one), so a buggy
        # observe() that returns "up" forever degrades to skipped
        # actions instead of growing the fleet to OOM under a pump tick
        limit = getattr(self.autoscaler, "max_replicas", None)
        applied = 0
        for kind, idx in self.autoscaler.observe(self):
            if kind == "up":
                if limit is not None and len(self.replicas) >= limit:
                    continue
                self.add_replica()
                applied += 1
            elif (kind == "down" and idx is not None
                    and 0 <= idx < len(snapshot)):
                try:
                    live = self.replicas.index(snapshot[idx])
                except ValueError:
                    continue
                if len(self.replicas) > 1:
                    self.drain_replica(live)
                    applied += 1
        return applied

    # ----------------------------------------------------------------- queue
    def submit(self, kernel, xs, tenant: str = DEFAULT_TENANT) -> int:
        """Admit globally, route via the router policy, enqueue on one
        replica; returns a global ticket."""
        xs = list(xs)
        cost = max(1, -(-int(np.shape(xs[0])[0]) // self.tile))
        self.admission.admit(tenant, cost)
        rep = self.router.route(kernel, self)
        loc = self.replicas[rep].submit(kernel, xs, tenant=tenant)
        t = self._next_ticket
        self._next_ticket += 1
        self._owner[t] = (rep, loc)
        self._global[rep][loc] = t
        self.telemetry.inc("fleet.submits")
        return t

    def submit_work(self, fn, tenant: str = DEFAULT_TENANT, *,
                    cost: int = 1, label: str = "work",
                    key: tuple | None = None) -> int:
        """Admit globally, enqueue host-side work on the least-loaded
        replica (work has no context residency to chase); returns a
        global ticket.  See ``OverlayServer.submit_work``."""
        cost = max(1, int(cost))
        self.admission.admit(tenant, cost)
        rep = min(range(len(self.replicas)),
                  key=lambda i: self.replicas[i].pending_tiles)
        loc = self.replicas[rep].submit_work(fn, tenant=tenant, cost=cost,
                                             label=label, key=key)
        t = self._next_ticket
        self._next_ticket += 1
        self._owner[t] = (rep, loc)
        self._global[rep][loc] = t
        self.telemetry.inc("fleet.submits")
        return t

    def queued_by_tenant(self) -> dict[str, int]:
        """Fleet-wide queued-only tiles per tenant (see
        ``OverlayServer.queued_by_tenant``)."""
        out: dict[str, int] = {}
        for rep in self.replicas:
            for tenant, tiles in rep.queued_by_tenant().items():
                out[tenant] = out.get(tenant, 0) + tiles
        return out

    def make_preemptible(self, bulk_tenants=(), bulk_prefix=None):
        """Install the preemptible bulk tier on EVERY replica's round
        policy (idempotent; replicas added later inherit it).  Returns
        the per-replica tiers, replica order."""
        from repro_torch.sched.preempt import BULK_PREFIX
        prefix = bulk_prefix if bulk_prefix is not None else BULK_PREFIX
        if self._bulk_spec is None:
            self._bulk_spec = (set(bulk_tenants), prefix)
        else:
            self._bulk_spec[0].update(bulk_tenants)
        return [rep.make_preemptible(self._bulk_spec[0],
                                     bulk_prefix=self._bulk_spec[1])
                for rep in self.replicas]

    @property
    def pending(self) -> int:
        return sum(rep.pending for rep in self.replicas)

    @property
    def pending_tiles(self) -> int:
        """Fleet-wide undelivered work in dispatch tiles — the gateway's
        edge-backpressure signal (the depth its ``max_fleet_tiles`` bound
        is enforced against)."""
        return sum(rep.pending_tiles for rep in list(self.replicas))

    # -------------------------------------------------------------- retrieve
    def _to_global(self, rep: int, local_results: dict) -> dict:
        return {self._global[rep][loc]: ys
                for loc, ys in local_results.items()}

    def _forget(self, ticket: int) -> None:
        """Drop one claimed ticket's bookkeeping: its routing maps, or —
        for a ticket whose replica was decommissioned — its orphan
        telemetry.  The single forget path shared by the metrics-window
        prune and ``reset_metrics``."""
        rep_loc = self._owner.pop(ticket, None)
        if rep_loc is not None:
            self._global[rep_loc[0]].pop(rep_loc[1], None)
        else:
            self._orphan_records.pop(ticket, None)

    def _note_claimed(self, tickets) -> None:
        self.telemetry.inc("fleet.claims", len(tickets))
        self._claimed.extend(tickets)
        while len(self._claimed) > self.metrics_window:
            self._forget(self._claimed.popleft())

    def _claim_orphan(self, ticket: int):
        """Claim/inspect a ticket whose replica was decommissioned:
        returns its outputs, raises KeyError if already claimed, or
        returns None when the ticket is not an orphan at all."""
        if ticket in self._orphaned:
            self.telemetry.inc("fleet.orphan_claims")
            self._note_claimed([ticket])
            return self._orphaned.pop(ticket)
        if ticket in self._orphan_records:
            # record survives, result gone: it was claimed already
            raise KeyError(f"ticket {ticket} already claimed")
        return None

    def try_result(self, ticket: int):
        """Non-blocking claim across the fleet (see
        ``OverlayServer.try_result``)."""
        if ticket in self._orphaned or ticket in self._orphan_records:
            return self._claim_orphan(ticket)
        if ticket not in self._owner:
            raise KeyError(f"unknown ticket {ticket}")
        rep, loc = self._owner[ticket]
        out = self.replicas[rep].try_result(loc)
        if out is not None:
            self._note_claimed([ticket])
        return out

    def result(self, ticket: int):
        """Block until the ticket's outputs are ready (drives only the
        owning replica's pipeline); one claim per ticket.  A ticket whose
        replica was drained is served from the fleet's orphan store (the
        drain delivered it) or from its adoptive replica (the drain
        evacuated it) — the client never sees the difference."""
        if ticket in self._orphaned or ticket in self._orphan_records:
            return self._claim_orphan(ticket)
        if ticket not in self._owner:
            raise KeyError(f"unknown ticket {ticket}")
        rep, loc = self._owner[ticket]
        out = self.replicas[rep].result(loc)
        self._note_claimed([ticket])
        return out

    def as_completed(self):
        """Yield ``(ticket, outputs)`` in completion order across ALL
        replicas; keeps every replica's pipeline full while iterating
        (observing the autoscaler and rebalancing queued work first) and
        retires rounds fan-in round-robin so no replica's results are
        held back behind another's backlog.  Results orphaned by a
        replica drain are yielded like any other completion."""
        while True:
            yielded = False
            while self._orphaned:
                t, outs = self._orphaned.popitem(last=False)
                self.telemetry.inc("fleet.orphan_claims")
                self._note_claimed([t])
                yielded = True
                yield t, outs
            for rep_id, rep in enumerate(self.replicas):
                while rep._done:
                    loc, outs = rep._done.popitem(last=False)
                    rep._note_claimed([loc])
                    t = self._global[rep_id][loc]
                    self._note_claimed([t])
                    yielded = True
                    yield t, outs
            if yielded:
                continue
            self.autoscale_once()
            self.router.rebalance(self)
            for rep in self.replicas:
                rep._fill_pipeline()
            live = [rep for rep in self.replicas if rep._inflight]
            if not live:
                if self._orphaned:      # a scale-down orphaned results
                    continue
                return
            live[self._rr % len(live)]._retire_oldest()
            self._rr += 1

    def pump_once(self) -> bool:
        """One unit of fleet drain work for ``sched.pump.AutoPump``:
        observe the autoscaler (this tick is how BACKGROUND serving
        scales — including idle ticks, which is where scale-downs come
        from), rebalance queued work (stealing routers), top up every
        replica's pipeline, deliver one round (fan-in round-robin).
        Returns True when any round was delivered or the fleet changed
        size, so the pump keeps ticking through a scaling burst."""
        scaled = self.autoscale_once()
        self.router.rebalance(self)
        for rep in self.replicas:
            rep._fill_pipeline()
        live = [rep for rep in self.replicas if rep._inflight]
        if not live:
            return scaled > 0
        live[self._rr % len(live)]._retire_oldest()
        self._rr += 1
        return True

    def flush(self) -> dict[int, list]:
        """Serve everything queued on every replica; {ticket: outputs}.

        Launches rounds on ALL replicas before blocking on any one of
        them, so the per-device rounds execute concurrently; within each
        replica the usual round pipelining applies.  A stealing router
        rebalances queued work each pass, so an idle replica picks up a
        backlogged replica's queue instead of going dark.  The
        autoscaler is observed once per pass, so the replica set may
        GROW or SHRINK mid-flush: the pass re-reads the fleet after
        every mutation, a drained replica's queued work re-homes through
        the same steal/adopt path, and its delivered results join the
        returned dict via the orphan store — no ticket is lost to a
        resize.
        """
        while True:
            self.autoscale_once()
            self.router.rebalance(self)
            for rep in self.replicas:
                rep._fill_pipeline()
            live = [rep for rep in self.replicas if rep._inflight]
            if not live:
                break
            for rep in live:
                rep._retire_oldest()
        results: dict[int, list] = {}
        for rep_id, rep in enumerate(self.replicas):
            results.update(self._to_global(rep_id, rep.flush()))
        self.telemetry.inc("fleet.orphan_claims", len(self._orphaned))
        results.update(self._orphaned)
        self._orphaned.clear()
        self._note_claimed(results)
        return results

    def flush_sync(self) -> dict[int, list]:
        """Barrier drain, replica by replica — the sharded oracle path
        (no cross-replica overlap, no intra-replica pipelining, no
        stealing, no autoscaling).  Results already orphaned by an
        earlier drain are still returned — the oracle claims everything
        undelivered, it just never mutates the fleet itself."""
        results: dict[int, list] = {}
        for rep_id, rep in enumerate(self.replicas):
            results.update(self._to_global(rep_id, rep.flush_sync()))
        self.telemetry.inc("fleet.orphan_claims", len(self._orphaned))
        results.update(self._orphaned)
        self._orphaned.clear()
        self._note_claimed(results)
        return results

    # --------------------------------------------------------------- metrics
    def record(self, ticket: int) -> dict:
        """Telemetry for one global ticket (adds the serving replica;
        ``replica=None`` for tickets whose replica was decommissioned)."""
        rep_loc = self._owner.get(ticket)
        if rep_loc is None:
            rec = dict(self._orphan_records[ticket])
            rec["replica"] = None
            return rec
        rep, loc = rep_loc
        rec = self.replicas[rep].record(loc)
        rec["replica"] = rep
        return rec

    def latencies(self) -> dict[int, float]:
        out: dict[int, float] = {}
        for rep_id, rep in enumerate(self.replicas):
            for loc, lat in rep.latencies().items():
                t = self._global[rep_id].get(loc)
                if t is not None:
                    out[t] = lat
        for t, rec in self._orphan_records.items():
            if rec["t_done"] is not None:
                out[t] = rec["t_done"] - rec["t_submit"]
        return out

    def latency_percentiles(self, qs=LATENCY_QS) -> dict[str, float]:
        lats = list(self.latencies().values())
        if not lats:
            return {f"p{q}": float("nan") for q in qs}
        return {f"p{q}": float(np.percentile(lats, q)) for q in qs}

    def tenant_latencies(self):
        """Yield ``(tenant, latency_seconds)`` per delivered ticket,
        fleet-wide: every live replica's records plus the orphan records
        of tickets whose replica was decommissioned — a drained replica's
        served traffic still counts against its tenants' SLOs."""
        for rep in self.replicas:
            yield from rep.tenant_latencies()
        for rec in self._orphan_records.values():
            if rec["t_done"] is not None:
                yield rec["tenant"], rec["t_done"] - rec["t_submit"]

    def tenant_latency_percentiles(self, qs=LATENCY_QS) -> dict:
        """Fleet-wide per-tenant p50/p95/p99 + SLO attainment (one source
        of truth shared by the gateway's shed decisions and the benchmark
        tables — see :func:`tenant_latency_summary`)."""
        return tenant_latency_summary(self.tenant_latencies(), qs=qs,
                                      slo_s=self.slo_s)

    def reset_metrics(self) -> None:
        """Drop delivered-ticket telemetry AND routing counters (e.g.
        after a warmup drain) so hit rates reflect steady state."""
        for rep in self.replicas:
            rep.reset_metrics()
        # release the claimed tickets' routing maps too — the replicas
        # just dropped those tickets' records, and leaving entries in
        # _owner/_global would leak them for the server's lifetime
        # (delivered-but-unclaimed tickets are not in _claimed and keep
        # their routing)
        while self._claimed:
            self._forget(self._claimed.popleft())
        self.router.reset_metrics()
        # scaling counters are per-study telemetry like hit rates; the
        # autoscaler's own decision counters reset with them (its control
        # state — streaks, cooldown — is not a metric and survives)
        self.telemetry.reset(names=(
            "fleet.scale_ups", "fleet.scale_downs",
            "fleet.evacuated_requests", "fleet.evacuated_tiles"))
        if self.autoscaler is not None:
            self.autoscaler.reset_metrics()

    def stats(self) -> dict:
        per = [rep.stats() for rep in self.replicas]
        # rounds/requests aggregate from the SHARED sink, not the live
        # replicas: every replica writes through MultiSink(own, fleet),
        # so work served by since-drained replicas is already in there
        s = {"replicas": self.n_replicas,
             "submits": self.n_submits,
             "pending": self.pending,
             "queue_depth": [p["queued"] for p in per],
             "queued_tiles": [p["queued_tiles"] for p in per],
             "per_replica": per,
             "rounds": int(self.telemetry.counter("engine.rounds")),
             "requests": int(self.telemetry.counter("engine.delivered")),
             "evictions": (sum(p["evictions"] for p in per)
                           + int(self.telemetry.counter(
                               "fleet.retired_evictions"))),
             "scale_ups": self.n_scale_ups,
             "scale_downs": self.n_scale_downs,
             "evacuated_requests": self.n_evacuated_requests,
             "evacuated_tiles": self.n_evacuated_tiles,
             "replicas_retired": self.n_replicas_retired,
             "retired_lifetime_s": self.retired_lifetime_s,
             "peak_replicas": self.peak_replicas,
             "orphaned_results": len(self._orphaned),
             "orphan_claims": int(
                 self.telemetry.counter("fleet.orphan_claims")),
             "claims": int(self.telemetry.counter("fleet.claims")),
             # replicas write through MultiSink(own, fleet), so these
             # walls aggregate the whole fleet incl. drained replicas
             "stage_walls": _stage_walls(self.telemetry),
             "tenant_latency": self.tenant_latency_percentiles()}
        s.update(self.router.stats())
        if self.autoscaler is not None:
            s.update(self.autoscaler.stats())
        return s


def overlay_demo(argv_ns) -> int:
    """Mixed-kernel serving demo over the paper's Table II benchmark set.

    Default mode drains with the pipelined ``flush``; ``--stream`` submits
    per-tenant and consumes ``as_completed`` to show completion-order
    delivery plus per-tenant latency percentiles.  ``--policy`` swaps the
    round-formation policy (see repro_torch.sched.rounds).
    """
    from repro_torch.core.overlay import compile_program
    from repro_torch.core.paper_bench import BENCH_NAMES, benchmark
    from repro_torch.core.vm import dfg_eval, resolve_device

    names = list(BENCH_NAMES) + ["gradient"]
    kernels = {n: compile_program(benchmark(n)) for n in names}
    device = resolve_device(argv_ns.device)
    srv = OverlayServer(bank_capacity=argv_ns.bank, tile=argv_ns.tile,
                        device=device,
                        round_kernels=max(1, argv_ns.bank // 2),
                        round_policy=argv_ns.policy)
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(argv_ns.requests):
        k = kernels[names[i % len(names)]]
        xs = [rng.uniform(-2, 2, (argv_ns.req_batch,)).astype(np.float32)
              for _ in k.dfg.inputs]
        tenant = f"tenant{i % argv_ns.tenants}"
        reqs.append((srv.submit(k, xs, tenant=tenant), k, xs, tenant))
    srv.flush()  # warmup (builds and loads the kernel)
    srv.reset_metrics()
    for _, k, xs, tenant in reqs:
        srv.submit(k, xs, tenant=tenant)
    t0 = time.perf_counter()
    if argv_ns.stream:
        results = {}
        for ticket, outs in srv.as_completed():
            results[ticket] = outs
    else:
        results = srv.flush()
    dt = time.perf_counter() - t0     # results are host arrays: delivered
    # verify a sample against the DFG oracle
    _, k, xs, _ = reqs[-1]
    ref = dfg_eval(k.dfg, {n: torch.from_numpy(v)
                           for n, v in zip(k.dfg.inputs, xs)})
    np.testing.assert_allclose(np.asarray(results[max(results)][0]),
                               ref[k.dfg.outputs[0]].numpy(),
                               rtol=1e-5, atol=1e-5)
    st = srv.stats()
    pct = {k_: f"{v * 1e3:.2f}ms"
           for k_, v in srv.latency_percentiles().items()}
    mode = "as_completed stream" if argv_ns.stream else "pipelined flush"
    print(f"served {len(reqs)} mixed requests over {len(names)} kernels "
          f"x {argv_ns.tenants} tenants on {device} "
          f"(bank={argv_ns.bank}, {mode}, "
          f"policy={st['round_policy']}) "
          f"in {dt * 1e3:.1f} ms = {len(reqs) / dt:,.0f} req/s")
    print(f"delivery latency percentiles: {pct}")
    print(f"server stats: {st}")
    return 0


@dataclasses.dataclass
class Generation:
    """What ``lm_generate`` returns: ``tokens`` [B, gen] int32 (the first
    from the prefill's last logits, then one a decode step), ``logits``
    the ``gen`` [B, V] logits each token was taken from, and the wall
    seconds of the prefill and of the ``gen - 1`` decode steps (each
    ending in a device sync)."""

    tokens: torch.Tensor
    logits: list
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lm_batch(cfg, batch_size: int, prompt_len: int, device, seed: int = 1):
    """The CLI's batch: seeded prompt ids (drawn on the CPU, so every
    device gets the same ones) and the zero vision / frame embeds of the
    archs with those towers."""
    from repro_torch.runtime.steps import decorate_batch
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch_size, prompt_len),
                           generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens.to(device)}
    dc = argparse.Namespace(local_batch=batch_size, seq_len=prompt_len)
    return decorate_batch(cfg, dc, batch)


def lm_generate(cfg, params, batch, gen: int, device=None) -> Generation:
    """Prefill the prompts of ``batch``, then ``gen - 1`` greedy decode
    steps through the cache (the cache holds prompt + vision tokens +
    ``gen``), as the reference CLI does."""
    from repro_torch.core.vm import resolve_device
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    device = resolve_device(device)
    S = batch["tokens"].shape[1]
    cache_len = S + gen + cfg.vision_tokens
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    decode = make_decode_step(cfg)

    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out, all_logits = [tok], [logits]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, tok, caches = decode(params, caches, tok,
                                     S + cfg.vision_tokens + i)
        tok = tok[:, None]
        out.append(tok)
        all_logits.append(logits)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return Generation(tokens=torch.cat(out, 1), logits=all_logits,
                      prefill_s=t_prefill, decode_s=t_decode)


def lm_demo(args) -> int:
    """``--arch``: seeded weights, B prompts of ``--prompt-len`` ids,
    prefill then greedy decode; prints the reference CLI's three lines."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.vm import resolve_device
    from repro_torch.models import init_params
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, torch.Generator(device).manual_seed(0),
                         device=device)
    B, S, G = args.batch, args.prompt_len, args.gen
    g = lm_generate(cfg, params, lm_batch(cfg, B, S, device), G, device)
    ids = g.tokens.cpu().numpy()
    print(f"prefill: {B}x{S} in {g.prefill_s * 1e3:.1f} ms "
          f"({B * S / g.prefill_s:,.0f} tok/s)")
    print(f"decode:  {G - 1} steps in {g.decode_s * 1e3:.1f} ms "
          f"({B * (G - 1) / max(g.decode_s, 1e-9):,.0f} tok/s)")
    print("sample token ids:", ids[0][:12].tolist())
    return 0


def main(argv=None):
    from repro_torch.sched.rounds import ROUND_POLICIES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--overlay-demo", action="store_true",
                    help="serve mixed overlay kernels from a ContextBank")
    ap.add_argument("--bank", type=int, default=4,
                    help="context-bank capacity for --overlay-demo")
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the CPU only when "
                         "asked for by name)")
    ap.add_argument("--policy", default=None,
                    choices=sorted(ROUND_POLICIES),
                    help="round-formation policy for --overlay-demo "
                         "(default: REPRO_ROUND_POLICY env or drr)")
    ap.add_argument("--requests", type=int, default=36)
    ap.add_argument("--req-batch", type=int, default=256)
    ap.add_argument("--tenants", type=int, default=3,
                    help="tenant labels round-robined over --overlay-demo "
                         "requests")
    ap.add_argument("--stream", action="store_true",
                    help="consume results via as_completed instead of flush")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)

    if args.overlay_demo:
        return overlay_demo(args)
    if args.arch is None:
        ap.error("--arch is required unless --overlay-demo is given")
    return lm_demo(args)


if __name__ == "__main__":
    sys.exit(main())
