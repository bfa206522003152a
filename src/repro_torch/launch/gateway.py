"""Asyncio serving gateway: the fleet's network-shaped front door.

Everything behind this module is a THREADED serving stack — the engines
(``launch.serve.OverlayServer`` / ``ShardedOverlayServer``) are driven by
``sched.pump.AutoPump``'s background drain thread, and every entry point
blocks under one reentrant lock.  That is the right shape for in-process
Python callers and exactly the wrong shape for "millions of users": a
front-end must hold thousands of cheap concurrent conversations, each
submitting a trickle and awaiting its own results.  ``OverlayGateway``
bridges the two worlds the way JIT-assembly overlays keep a heavy
resident datapath behind a thin stateful control plane: the pump thread
keeps the device busy, and an asyncio event loop multiplexes the
connections.

The bridge, concretely:

* ``GatewayConnection.submit`` is a coroutine returning the fleet's own
  global ticket; ``await conn.result(ticket)`` and the streaming
  ``async for ticket, outs in conn.results()`` resolve from per-ticket
  ``asyncio.Future``\\ s.
* The pump's TICK is the only signal: the gateway registers an
  ``AutoPump.add_tick_listener`` observer, and every pump iteration
  (productive or idle) schedules one ``_tick`` on the event loop via
  ``loop.call_soon_threadsafe`` — the pump thread never touches asyncio
  state directly, and the loop never blocks on the engine beyond one
  batched ``try_results`` claim under the pump lock.
* ADMISSION is per connection: each connection carries its own
  ``sched.admission.AdmissionControl`` (token buckets in dispatch
  tiles), layered above whatever fleet-level admission the engine was
  built with.

Backpressure is COUPLED to the autoscaler (the interesting part):

* The edge enforces ``max_fleet_tiles`` — a submit that would push the
  fleet's undelivered depth (``pending_tiles``) past the bound either
  parks at the edge (``overflow="wait"``: the coroutine suspends, FIFO)
  or is shed (``overflow="shed"``: ``GatewayOverloadedError``).  Fleet
  queue depth therefore stays bounded no matter how many connections
  pile in: shedding engages BEFORE the bound is exceeded.
* While the fleet's :class:`~repro_torch.sched.autoscale.PressureAutoscaler`
  reports ``scale_up_pending`` (pressure observed, capacity below
  ``max_replicas``), the edge WIDENS: the depth bound and every
  connection's admission window stretch by ``widen_factor`` — capacity
  is coming, so queueing a little deeper beats rejecting traffic the
  grown fleet could have served.  The widening REVERTS automatically
  when the scale-up lands (the autoscaler's hot streak resets on the
  ``up`` decision).
* When the autoscaler is ``saturated`` (wants to grow, fleet at
  ``max_replicas``) — or scaling down — no widening applies: overload
  sheds/queues at the gateway edge instead of accumulating inside the
  fleet, which is where it would bloat every tenant's latency tail.

Disconnect is GRACEFUL and loss-free: closing (or dropping) a connection
cancels its pending awaits, but its fleet-side tickets are never
orphaned — the gateway parks them in a per-``session`` registry while
their results land in the engine's delivered store (or the fleet orphan
store, if their replica is drained meanwhile), and a reconnect with the
same session id reclaims every one of them exactly once
(``conn.reclaim()``).  ``flush_sync`` through the gateway delegates to
the engine's barrier drain under the pump lock — the bit-for-bit oracle
is unchanged by the asyncio layer.

::

    async with OverlayGateway.local(n_replicas=2, autoscale=True) as gw:
        async with gw.connect(tenant="alice", session="a-1") as conn:
            t = await conn.submit(kernel, xs)
            outs = await conn.result(t)

The engines run on the GPU unless told otherwise: ``local`` passes
``server_kw`` through (``devices=[torch.device("cpu")] * n`` or
``device="cpu"`` for a CPU engine).
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import time

import numpy as np

from repro_torch.sched import AdmissionControl, AutoPump

__all__ = [
    "DEFAULT_RETRY_AFTER", "GatewayClosedError", "GatewayConnection",
    "GatewayError", "GatewayOverloadedError", "OverlayGateway",
]

#: fallback resubmission hint (seconds) when the pump's poll interval is
#: unavailable — the pump stopped, or its interval is unset/invalid
DEFAULT_RETRY_AFTER = 0.05


class GatewayError(RuntimeError):
    """Base class for gateway-edge failures."""


class GatewayClosedError(GatewayError):
    """The gateway or connection was closed; no further submits."""


class GatewayOverloadedError(GatewayError):
    """Shed at the edge: admitting this request would push fleet depth
    past the configured bound (and the edge is not parking work).

    ``retry_after`` is a resubmission hint in seconds — one pump poll
    interval, i.e. the soonest the pressure reading can change.
    """

    def __init__(self, msg: str, retry_after: float = 0.0):
        super().__init__(msg)
        self.retry_after = retry_after


@dataclasses.dataclass
class _EdgeWaiter:
    """One submit parked at the edge, awaiting fleet capacity."""

    future: asyncio.Future        # resolved with the fleet ticket
    conn: "GatewayConnection"
    kernel: object
    xs: list
    cost: int


class OverlayGateway:
    """Asyncio front-end over a pump-driven serving engine.

    ``server`` is an ``OverlayServer`` / ``ShardedOverlayServer`` — the
    gateway wraps it in its own :class:`~repro_torch.sched.pump.AutoPump` — or
    an already-constructed ``AutoPump`` (the gateway then shares it and
    leaves its lifecycle to the owner).

    Knobs:

    * ``max_fleet_tiles`` — edge backpressure bound on the fleet's
      undelivered depth (dispatch tiles).  ``None`` disables edge
      backpressure (admission controls still apply).
    * ``widen_factor`` — how far the bound and the per-connection
      admission windows stretch while the autoscaler reports a scale-up
      pending (>= 1; 1 disables the coupling).
    * ``overflow`` — ``"wait"`` parks over-bound submits at the edge
      (FIFO, bounded by ``max_edge_waiters``, beyond which they shed);
      ``"shed"`` rejects them immediately with
      :class:`GatewayOverloadedError`.
    * ``admission`` / ``default_admission`` — per-connection token-bucket
      specs (``{tenant: (rate, burst)}`` and a lazy default), applied at
      THIS edge per connection, independent of any fleet-level admission.
    """

    def __init__(self, server, *, max_fleet_tiles: int | None = 256,
                 widen_factor: float = 2.0, overflow: str = "wait",
                 max_edge_waiters: int = 4096,
                 max_orphan_sessions: int | None = 1024,
                 admission: dict | None = None,
                 default_admission: tuple | None = None,
                 poll_interval: float = 0.002, clock=time.monotonic,
                 telemetry=None):
        if overflow not in ("wait", "shed"):
            raise ValueError(
                f"overflow must be 'wait' or 'shed', got {overflow!r}")
        if widen_factor < 1.0:
            raise ValueError(
                f"widen_factor must be >= 1, got {widen_factor}")
        if max_fleet_tiles is not None and max_fleet_tiles < 1:
            raise ValueError(
                f"max_fleet_tiles must be >= 1 or None, got "
                f"{max_fleet_tiles}")
        if max_orphan_sessions is not None and max_orphan_sessions < 1:
            raise ValueError(
                f"max_orphan_sessions must be >= 1 or None, got "
                f"{max_orphan_sessions}")
        if isinstance(server, AutoPump):
            self._pump = server
            self._owns_pump = False
        else:
            self._pump = AutoPump(server, poll_interval=poll_interval)
            self._owns_pump = True
        self.max_fleet_tiles = max_fleet_tiles
        self.widen_factor = widen_factor
        self.overflow = overflow
        self.max_edge_waiters = max_edge_waiters
        self.max_orphan_sessions = max_orphan_sessions
        self.clock = clock
        #: per-connection admission spec (each connect() builds its own
        #: AdmissionControl from this, so buckets are per connection)
        self._admission_spec = (admission, default_admission)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._closed = False
        self._connections: set[GatewayConnection] = set()
        #: fleet ticket -> owning connection (live awaits only)
        self._outstanding: dict[int, GatewayConnection] = {}
        #: session id -> {fleet tickets} of disconnected-but-undelivered
        #: (or unclaimed) work, reclaimable exactly once on reconnect.
        #: Ordered least- to most-recently-parked so a session that never
        #: reconnects can be LRU-expired at ``max_orphan_sessions``.
        self._orphan_sessions: collections.OrderedDict[str, set[int]] = \
            collections.OrderedDict()
        #: results the gateway had ALREADY claimed from the engine into a
        #: future when the connection dropped before awaiting them; held
        #: here (engine-side claim-once already spent) until reclaimed
        self._orphan_results: dict[int, object] = {}
        self._edge_waiters: collections.deque[_EdgeWaiter] = \
            collections.deque()
        self._tick_scheduled = False
        #: a gateway-level bulk drain (flush/flush_sync) is claiming
        #: results in an executor thread: ticks must neither claim
        #: concurrently (they would see "already claimed" and poison the
        #: futures _absorb_results is about to resolve) nor submit edge
        #: waiters (pump.submit would block the event loop on the pump
        #: lock the drain holds)
        self._draining = False
        # edge telemetry: every counter lives in the structured sink —
        # by default the pump's (= the wrapped engine's), so the edge,
        # the pump, and the fleet tell one story through one store
        from repro_torch.telemetry import InMemorySink
        self.telemetry = (telemetry if telemetry is not None
                          else getattr(self._pump, "telemetry", None)
                          or InMemorySink(clock=clock))

    # ------------------------------------------------- counters (read-through)
    @property
    def n_attempts(self) -> int:
        """Submits that passed per-connection admission (parked or not)."""
        return int(self.telemetry.counter("edge.attempts"))

    @property
    def n_submitted(self) -> int:
        return int(self.telemetry.counter("edge.submitted"))

    @property
    def n_shed(self) -> int:
        return int(self.telemetry.counter("edge.shed"))

    @property
    def n_edge_queued(self) -> int:
        return int(self.telemetry.counter("edge.queued"))

    @property
    def n_park_cancelled(self) -> int:
        """Parked submits that never reached the fleet (connection or
        gateway closed, or the awaiting task cancelled, while queued)."""
        return int(self.telemetry.counter("edge.park_cancelled"))

    @property
    def n_reclaimed(self) -> int:
        return int(self.telemetry.counter("edge.reclaimed"))

    @property
    def n_connects(self) -> int:
        return int(self.telemetry.counter("edge.connects"))

    @property
    def n_disconnects(self) -> int:
        return int(self.telemetry.counter("edge.disconnects"))

    @property
    def peak_fleet_tiles(self) -> int:
        return int(self.telemetry.counter("edge.peak_fleet_tiles"))

    @property
    def peak_edge_waiters(self) -> int:
        return int(self.telemetry.counter("edge.peak_edge_waiters"))

    @property
    def n_widened_ticks(self) -> int:
        return int(self.telemetry.counter("edge.widened_ticks"))

    @property
    def n_orphans_expired(self) -> int:
        """Sessions LRU-expired from the orphan store (never reclaimed)."""
        return int(self.telemetry.counter("edge.orphans_expired"))

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def local(cls, *, n_replicas: int = 1, bank_capacity: int = 8,
              autoscale: bool = False, max_replicas: int = 4,
              server_kw: dict | None = None, autoscaler_kw: dict | None = None,
              **gateway_kw) -> "OverlayGateway":
        """Build a self-contained local gateway: engine + pump + edge.

        ``n_replicas > 1`` (or ``autoscale=True``) builds a
        ``ShardedOverlayServer``; ``autoscale=True`` attaches a
        ``PressureAutoscaler`` capped at ``max_replicas``, which is what
        the backpressure coupling feeds on.
        """
        from repro_torch.launch.serve import OverlayServer, ShardedOverlayServer
        from repro_torch.sched import PressureAutoscaler
        server_kw = dict(server_kw or {})
        if n_replicas > 1 or autoscale:
            if autoscale:
                server_kw.setdefault("autoscaler", PressureAutoscaler(
                    max_replicas=max_replicas, **(autoscaler_kw or {})))
            srv = ShardedOverlayServer(n_replicas=n_replicas,
                                       bank_capacity=bank_capacity,
                                       **server_kw)
        else:
            srv = OverlayServer(bank_capacity=bank_capacity, **server_kw)
        return cls(srv, **gateway_kw)

    @property
    def server(self):
        """The wrapped engine (through the pump)."""
        return self._pump.server

    @property
    def pump(self) -> AutoPump:
        return self._pump

    def _require_loop(self) -> asyncio.AbstractEventLoop:
        """Bind to the running event loop on first async use and start
        observing pump ticks.  All gateway state is owned by this loop's
        thread from then on."""
        if self._closed:
            raise GatewayClosedError("gateway is closed")
        loop = asyncio.get_running_loop()
        if self._loop is None:
            self._loop = loop
            self._pump.add_tick_listener(self._on_pump_tick)
        elif loop is not self._loop:
            raise GatewayError(
                "gateway is bound to another event loop; build one "
                "gateway per loop")
        return loop

    def connect(self, tenant: str = "default",
                session: str | None = None) -> "GatewayConnection":
        """Open a connection (``async with gw.connect(...) as conn``).

        ``session`` names the reconnectable identity: a connection that
        drops with results still in flight parks its tickets under this
        id, and the next connection opened with the SAME id can
        ``reclaim()`` them.  ``None`` makes the connection anonymous
        (undelivered work is still never lost fleet-side, but nothing
        can claim it back).
        """
        if self._closed:
            raise GatewayClosedError("gateway is closed")
        admission, default = self._admission_spec
        conn = GatewayConnection(
            self, tenant=tenant, session=session,
            admission=AdmissionControl(admission, default,
                                       clock=self.clock))
        self._connections.add(conn)
        self.telemetry.inc("edge.connects")
        self.telemetry.event("connect", tenant=tenant, session=session)
        return conn

    async def aclose(self) -> None:
        """Close the gateway: close every connection (their undelivered
        tickets park under their sessions), stop observing the pump, and
        — if the gateway built the pump — stop the pump thread too.
        Idempotent; queued fleet-side work survives and can be drained
        from the engine directly."""
        if self._closed:
            return
        self._closed = True
        for conn in list(self._connections):
            await conn.close()
        self._pump.remove_tick_listener(self._on_pump_tick)
        while self._edge_waiters:
            w = self._edge_waiters.popleft()
            if not w.future.done():
                self.telemetry.inc("edge.park_cancelled")
                w.future.set_exception(
                    GatewayClosedError("gateway closed while queued at "
                                       "the edge"))
        if self._owns_pump:
            self._pump.close()

    async def __aenter__(self) -> "OverlayGateway":
        self._require_loop()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    # ------------------------------------------------------- edge pressure
    @property
    def _autoscaler(self):
        return getattr(self.server, "autoscaler", None)

    @property
    def scale_up_pending(self) -> bool:
        """The autoscaler has pressure evidence and room to grow."""
        return bool(getattr(self._autoscaler, "scale_up_pending", False))

    @property
    def saturated(self) -> bool:
        """The autoscaler wants to grow but the fleet is at its ceiling."""
        return bool(getattr(self._autoscaler, "saturated", False))

    @property
    def window(self) -> float:
        """Current edge admission window: ``widen_factor`` while a
        scale-up is pending (and the fleet is not saturated), else 1."""
        if self.scale_up_pending and not self.saturated:
            return self.widen_factor
        return 1.0

    @property
    def fleet_pending_tiles(self) -> int:
        return self.server.pending_tiles

    def _edge_bound(self) -> float:
        if self.max_fleet_tiles is None:
            return float("inf")
        return self.max_fleet_tiles * self.window

    def _has_capacity(self, cost: int) -> bool:
        depth = self.fleet_pending_tiles
        self.telemetry.peak("edge.peak_fleet_tiles", depth)
        return depth + cost <= self._edge_bound()

    def _retry_after(self) -> float:
        """Resubmission hint for a shed: one pump poll interval — the
        soonest the pressure reading can change — snapshotted
        defensively.  A stopped/replaced pump, or an unset/invalid
        interval, must not leak ``None``/``inf``/stale garbage into a
        client-facing hint; those fall back to
        :data:`DEFAULT_RETRY_AFTER`."""
        pump = self._pump
        try:
            if getattr(pump, "closed", False):
                return DEFAULT_RETRY_AFTER
            interval = float(pump.poll_interval)
        except (AttributeError, TypeError, ValueError):
            return DEFAULT_RETRY_AFTER
        if not (0.0 < interval < float("inf")):
            return DEFAULT_RETRY_AFTER
        return interval

    # ---------------------------------------------------------- pump bridge
    def _on_pump_tick(self, worked: bool) -> None:
        """Pump-thread side of the bridge: schedule (at most) one _tick
        on the event loop.  Coalesced — a fast pump cannot flood the
        loop's callback queue."""
        loop = self._loop
        if loop is None or self._closed or self._tick_scheduled:
            return
        self._tick_scheduled = True
        try:
            loop.call_soon_threadsafe(self._tick)
        except RuntimeError:        # loop already closed under us
            self._tick_scheduled = False

    def _tick(self) -> None:
        """Event-loop side: apply the autoscaler-coupled admission
        window, resolve every delivered ticket's future, and drain edge
        waiters into freed fleet capacity."""
        self._tick_scheduled = False
        if self._closed or self._draining:
            return
        window = self.window
        if window != 1.0:
            self.telemetry.inc("edge.widened_ticks")
        for conn in self._connections:
            conn.admission.set_window(window)
        self._resolve_delivered()
        self._drain_edge()

    def _resolve_delivered(self) -> None:
        if not self._outstanding:
            return
        ready = self._pump.try_results(list(self._outstanding))
        for ticket, outs in ready.items():
            conn = self._outstanding.pop(ticket)
            conn._deliver(ticket, outs)

    def _drain_edge(self) -> None:
        while self._edge_waiters:
            w = self._edge_waiters[0]
            if w.future.done():         # cancelled while parked
                self._edge_waiters.popleft()
                self.telemetry.inc("edge.park_cancelled")
                continue
            if w.conn.closed:           # dropped while parked: never
                self._edge_waiters.popleft()    # reached the fleet
                self.telemetry.inc("edge.park_cancelled")
                w.future.set_exception(GatewayClosedError(
                    "connection closed while queued at the edge"))
                continue
            if not self._has_capacity(w.cost):
                return
            self._edge_waiters.popleft()
            try:
                ticket = self._fleet_submit(w.conn, w.kernel, w.xs)
            except Exception as e:      # fleet-side admission, bank, ...
                self.telemetry.inc("edge.submit_errors")
                w.future.set_exception(e)
                continue
            w.future.set_result(ticket)

    # --------------------------------------------------------------- submit
    def _fleet_submit(self, conn: "GatewayConnection", kernel, xs) -> int:
        """Hand one admitted request to the pump; registers the ticket.
        Synchronous (no await) so the capacity check that preceded it is
        atomic within the event loop."""
        ticket = self._pump.submit(kernel, xs, tenant=conn.tenant)
        self._outstanding[ticket] = conn
        conn._register(ticket)
        self.telemetry.inc("edge.submitted")
        self.telemetry.peak("edge.peak_fleet_tiles",
                            self.fleet_pending_tiles)
        return ticket

    async def _submit(self, conn: "GatewayConnection", kernel, xs) -> int:
        self._require_loop()
        xs = list(xs)
        tile = getattr(self.server, "tile", 128)
        cost = max(1, -(-int(np.shape(xs[0])[0]) // tile))
        # per-connection admission first: a rate-limited tenant is
        # rejected before it can occupy edge-queue slots
        conn.admission.admit(conn.tenant, cost)
        self.telemetry.inc("edge.attempts")
        if self._edge_waiters or not self._has_capacity(cost):
            if (self.overflow == "shed"
                    or len(self._edge_waiters) >= self.max_edge_waiters):
                self.telemetry.inc("edge.shed")
                self.telemetry.event("shed", tenant=conn.tenant, cost=cost,
                                     depth=self.fleet_pending_tiles)
                raise GatewayOverloadedError(
                    f"fleet depth {self.fleet_pending_tiles} + {cost} "
                    f"tiles exceeds edge bound {self._edge_bound():.0f} "
                    f"(window {self.window:g})",
                    retry_after=self._retry_after())
            waiter = _EdgeWaiter(
                future=asyncio.get_running_loop().create_future(),
                conn=conn, kernel=kernel, xs=xs, cost=cost)
            self._edge_waiters.append(waiter)
            self.telemetry.inc("edge.queued")
            self.telemetry.peak("edge.peak_edge_waiters",
                                len(self._edge_waiters))
            try:
                return await waiter.future
            except asyncio.CancelledError:
                try:
                    self._edge_waiters.remove(waiter)
                except ValueError:
                    pass        # a tick already popped (and counted) it
                else:
                    self.telemetry.inc("edge.park_cancelled")
                raise
        return self._fleet_submit(conn, kernel, xs)

    # ---------------------------------------------------------------- drain
    async def flush(self) -> dict:
        """Pipelined drain of everything fleet-queued, off-loop; pending
        awaits resolve from the same results.  Returns the full
        ``{ticket: outputs}`` dict like the engine's ``flush``."""
        self._require_loop()
        self._draining = True
        try:
            results = await asyncio.get_running_loop().run_in_executor(
                None, self._pump.flush)
        finally:
            self._draining = False
        self._absorb_results(results)
        return results

    async def flush_sync(self) -> dict:
        """The engine's BARRIER drain through the gateway.

        Delegates to ``AutoPump.flush_sync`` (pump excluded for the whole
        span) in an executor thread, so the one-round-at-a-time oracle
        math is untouched by the asyncio layer — what makes the gateway
        testable bit-for-bit against the single-bank oracle.  Results for
        tickets with live awaits resolve those futures too.
        """
        self._require_loop()
        self._draining = True
        try:
            results = await asyncio.get_running_loop().run_in_executor(
                None, self._pump.flush_sync)
        finally:
            self._draining = False
        self._absorb_results(results)
        return results

    def _absorb_results(self, results: dict) -> None:
        """A bulk drain claimed tickets out from under the per-ticket
        futures; complete any live awaits from the drained dict, and
        carry parked-session tickets (their engine-side claim is now
        spent) so a later ``reclaim`` still finds them."""
        parked: set[int] = set()
        for tickets in self._orphan_sessions.values():
            parked.update(tickets)
        for ticket, outs in results.items():
            conn = self._outstanding.pop(ticket, None)
            if conn is not None:
                conn._deliver(ticket, outs)
            elif ticket in parked:
                self._orphan_results[ticket] = outs

    # ------------------------------------------------------------- sessions
    def _park_session(self, conn: "GatewayConnection",
                      tickets: set[int]) -> None:
        """A connection dropped with these tickets undelivered/unclaimed:
        park them under its session (reclaimable) or leave them to the
        fleet's stores (anonymous connection — results are retained
        engine-side either way, never lost)."""
        for t in tickets:
            self._outstanding.pop(t, None)
        if conn.session is not None and tickets:
            self._park_tickets(conn.session, tickets)

    def _park_tickets(self, session: str, tickets) -> None:
        """Add tickets to a session's orphan bucket, LRU-bump it, and
        expire the coldest sessions past ``max_orphan_sessions``."""
        bucket = self._orphan_sessions.get(session)
        if bucket is None:
            bucket = self._orphan_sessions[session] = set()
        bucket.update(tickets)
        self._orphan_sessions.move_to_end(session)
        self._expire_orphans()

    def park_result(self, session: str | None, ticket: int,
                    value) -> None:
        """Park an ALREADY-CLAIMED result under a session so a later
        ``reclaim`` returns it — the engine-side claim-once is spent, so
        the gateway carries the value itself.  The socket transport uses
        this to re-park results a dying connection never acknowledged.
        No-op for anonymous (``session=None``) connections."""
        if session is None:
            return
        self._orphan_results[ticket] = value
        self._park_tickets(session, (ticket,))

    def _expire_orphans(self) -> None:
        """LRU-expire orphan sessions past the cap: a session that never
        reconnects must not grow ``_orphan_sessions``/``_orphan_results``
        without bound.  Expired tickets drop their held results too."""
        cap = self.max_orphan_sessions
        if cap is None:
            return
        while len(self._orphan_sessions) > cap:
            session, tickets = self._orphan_sessions.popitem(last=False)
            held = 0
            for t in tickets:
                if self._orphan_results.pop(t, None) is not None:
                    held += 1
            self.telemetry.inc("edge.orphans_expired")
            self.telemetry.inc("edge.orphan_tickets_expired", len(tickets))
            self.telemetry.event("orphans_expired", session=session,
                                 tickets=len(tickets), held_results=held)

    def orphaned_tickets(self, session: str) -> frozenset[int]:
        """Tickets parked under ``session`` (peek; reclaim claims them)."""
        return frozenset(self._orphan_sessions.get(session, ()))

    # --------------------------------------------------------------- metrics
    def stats(self) -> dict:
        """Edge telemetry + the wrapped engine's stats (one dict)."""
        s = {"edge_attempts": self.n_attempts,
             "edge_submitted": self.n_submitted,
             "edge_shed": self.n_shed,
             "edge_queued": self.n_edge_queued,
             "edge_park_cancelled": self.n_park_cancelled,
             "edge_waiters": len(self._edge_waiters),
             "peak_edge_waiters": self.peak_edge_waiters,
             "peak_fleet_tiles": self.peak_fleet_tiles,
             "max_fleet_tiles": self.max_fleet_tiles,
             "window": self.window,
             "widened_ticks": self.n_widened_ticks,
             "connections": len(self._connections),
             "connects": self.n_connects,
             "disconnects": self.n_disconnects,
             "orphan_sessions": len(self._orphan_sessions),
             "orphaned_tickets": sum(
                 len(v) for v in self._orphan_sessions.values()),
             "orphaned_results_held": len(self._orphan_results),
             "orphans_expired": self.n_orphans_expired,
             "max_orphan_sessions": self.max_orphan_sessions,
             "reclaimed": self.n_reclaimed,
             "outstanding": len(self._outstanding)}
        s["fleet"] = self._pump.stats()
        return s


class GatewayConnection:
    """One client conversation with the gateway.

    Obtained from :meth:`OverlayGateway.connect`; use as an async context
    manager for graceful close.  All methods must run on the gateway's
    event loop.  A connection is cheap (a dict and an admission control)
    — the load generator opens thousands.
    """

    def __init__(self, gateway: OverlayGateway, tenant: str,
                 session: str | None, admission: AdmissionControl):
        self.gateway = gateway
        self.tenant = tenant
        self.session = session
        self.admission = admission
        self.closed = False
        #: live awaits: fleet ticket -> asyncio.Future
        self._futures: dict[int, asyncio.Future] = {}

    # ------------------------------------------------------------- plumbing
    def _check_open(self) -> None:
        if self.closed:
            raise GatewayClosedError(
                f"connection (tenant={self.tenant!r}, "
                f"session={self.session!r}) is closed")

    def _register(self, ticket: int) -> None:
        self._futures[ticket] = \
            asyncio.get_running_loop().create_future()

    def _deliver(self, ticket: int, outs) -> None:
        fut = self._futures.get(ticket)
        if fut is None or fut.done():
            return
        if isinstance(outs, KeyError):
            fut.set_exception(outs)
        else:
            fut.set_result(outs)

    # ---------------------------------------------------------------- client
    async def submit(self, kernel, xs) -> int:
        """Admit + enqueue one request; returns the fleet's global ticket.

        Raises :class:`~repro_torch.sched.admission.AdmissionError` when this
        connection's token bucket cannot cover it,
        :class:`GatewayOverloadedError` when the edge sheds it, and
        suspends (``overflow="wait"``) while the fleet is over its depth
        bound.
        """
        self._check_open()
        return await self.gateway._submit(self, kernel, xs)

    async def result(self, ticket: int):
        """Await one ticket's outputs (claim-once, like the engine)."""
        self._check_open()
        fut = self._futures.get(ticket)
        if fut is None:
            raise KeyError(f"ticket {ticket} is not outstanding on this "
                           f"connection")
        try:
            outs = await fut
        finally:
            # claimed or cancelled: either way this await is spent
            if fut.done() and not fut.cancelled():
                self._futures.pop(ticket, None)
        return outs

    async def results(self):
        """``async for ticket, outs`` in COMPLETION order, streaming.

        Yields every outstanding ticket as the pump delivers it; submits
        made while iterating are picked up; ends when the connection has
        nothing outstanding.
        """
        while self._futures:
            self._check_open()
            done = [t for t, f in self._futures.items() if f.done()]
            if not done:
                await asyncio.wait(list(self._futures.values()),
                                   return_when=asyncio.FIRST_COMPLETED)
                continue
            for t in done:
                fut = self._futures.pop(t)
                yield t, fut.result()

    async def drain(self) -> dict:
        """Await everything outstanding on THIS connection; returns
        ``{ticket: outputs}`` (other connections' work is untouched —
        compare ``gateway.flush``)."""
        out = {}
        async for t, outs in self.results():
            out[t] = outs
        return out

    async def reclaim(self) -> dict:
        """Claim results parked under this connection's session by a
        previous (dropped) connection — exactly once: the first reclaim
        takes the whole set, a second returns ``{}``.  Undelivered
        tickets are awaited; tickets whose replica was drained meanwhile
        are served from the fleet orphan store like any others."""
        self._check_open()
        if self.session is None:
            return {}
        gw = self.gateway
        gw._require_loop()
        tickets = gw._orphan_sessions.pop(self.session, set())
        out = {}
        waiting = []
        for t in sorted(tickets):
            if t in gw._orphan_results:
                # the dropped connection had already claimed this from
                # the engine; the gateway carried it
                out[t] = gw._orphan_results.pop(t)
            else:
                self._register(t)
                gw._outstanding[t] = self
                waiting.append(t)
        if waiting:
            # the pump may already have delivered some (or all) of them
            # while no one was listening; claim those without waiting
            # for the next tick
            gw._resolve_delivered()
        for t in waiting:
            out[t] = await self.result(t)
        gw.telemetry.inc("edge.reclaimed", len(out))
        gw.telemetry.event("reclaim", session=self.session,
                           tickets=len(out))
        return out

    @property
    def outstanding(self) -> frozenset[int]:
        """Tickets submitted on this connection and not yet claimed."""
        return frozenset(self._futures)

    async def close(self) -> None:
        """Graceful disconnect (idempotent): cancel pending awaits; park
        undelivered tickets under the session for reclaim.  Fleet-side
        work keeps flowing — a launched round is never cancelled, its
        results land in the engine's stores."""
        if self.closed:
            return
        self.closed = True
        gw = self.gateway
        gw._connections.discard(self)
        gw.telemetry.inc("edge.disconnects")
        undelivered = set(self._futures)
        for t, fut in self._futures.items():
            if not fut.done():
                fut.cancel()
            elif not fut.cancelled() and fut.exception() is None \
                    and self.session is not None:
                # delivered AND claimed from the engine, but never
                # awaited: the engine's claim-once is spent, so the
                # gateway must carry the value itself until reclaim
                gw._orphan_results[t] = fut.result()
        self._futures.clear()
        for w in list(gw._edge_waiters):
            # parked submits never reached the fleet: cancel, don't park
            if w.conn is self and not w.future.done():
                w.future.cancel()
        gw._park_session(self, undelivered)

    async def __aenter__(self) -> "GatewayConnection":
        self.gateway._require_loop()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()
