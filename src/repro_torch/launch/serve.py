"""Serving launcher: the async overlay engine on one GPU.

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
  coalescing and latency-adaptive round sizing as drop-ins).
* In-flight rounds pin their contexts in the ``ContextBank`` so LRU
  eviction can never reassign a slot under a launched round.

The engine runs on the CUDA device unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from repro_torch.sched import (AdmissionControl, AdmissionError,
                               DeficitRoundRobin, Flow, OverlayRequest,
                               TokenBucket, WorkRequest, make_round_policy)
from repro_torch.sched.rounds import DEFAULT_TENANT
from repro_torch.telemetry import InMemorySink

__all__ = [
    "AdmissionControl", "AdmissionError", "DEFAULT_TENANT",
    "DeficitRoundRobin", "OverlayRequest", "OverlayServer", "TokenBucket",
    "WorkRequest", "main", "overlay_demo", "tenant_latency_summary",
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
        for tenant in [t for t in self._rr if not self._flows[t].queue]:
            del self._flows[tenant]
            self._rr.remove(tenant)
        return self.round_policy.form_round(self._flows, self._rr,
                                            self.round_kernels)

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
        paths, so a work item's observable order is identical on both.
        Walls land in ``engine.work_s`` (not the device stage walls)."""
        t0 = self.clock()
        work_outs = {r.ticket: r.fn() for r in work_reqs}
        self.telemetry.inc("engine.work_s", self.clock() - t0)
        self.telemetry.inc("engine.work_items", len(work_reqs))
        return work_outs

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
        while True:
            t0 = self.clock()
            try:
                plan = self.overlay.plan(self.bank, pairs, tile=self.tile,
                                         pin=True)
                plan_s += self.clock() - t0
                break
            except BankError:
                # belt-and-braces: plan unwinds its own pins on failure, so
                # retiring one more round and retrying is always safe
                plan_s += self.clock() - t0
                if not self._inflight:
                    raise
                self._retire_oldest()
        t1 = self.clock()
        batch = self.overlay.assemble(plan)
        t2 = self.clock()
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

    def _retire_oldest(self) -> list:
        """Deliver the oldest in-flight round; returns its tickets."""
        inf = self._inflight.popleft()
        t0 = self.clock()
        if inf.done is not None:
            inf.done.synchronize()        # device wait, apart from readback
        t1 = self.clock()
        # host=True: live tiles/rows sliced device-side, one readback;
        # per-request slicing is numpy views, never device-op dispatch
        # (pure-work rounds have no plan and skip the device stages)
        outs = (self.overlay.collect(inf.plan, inf.ys, host=True)
                if inf.plan is not None else [])
        now = self.clock()
        self.telemetry.inc("engine.execute_s", t1 - t0)   # device wait
        self.telemetry.inc("engine.collect_s", now - t1)
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
            self.telemetry.event("deliver", tenant=r.tenant, cost=r.cost,
                                 round=inf.round_no,
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
        for the streaming path and the baseline it must beat.
        """
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
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
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


def main(argv=None):
    from repro_torch.sched.rounds import ROUND_POLICIES
    ap = argparse.ArgumentParser()
    ap.add_argument("--overlay-demo", action="store_true",
                    help="serve mixed overlay kernels from a ContextBank")
    ap.add_argument("--bank", type=int, default=4,
                    help="context-bank capacity for --overlay-demo")
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device for --overlay-demo (default: cuda; "
                         "the CPU only when asked for by name)")
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
    args = ap.parse_args(argv)

    if not args.overlay_demo:
        ap.error("--overlay-demo is the one mode of this launcher")
    return overlay_demo(args)


if __name__ == "__main__":
    sys.exit(main())
