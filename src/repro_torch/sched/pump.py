"""AutoPump: a background drain thread for the serving engines.

Without the pump, a queued request only makes progress when some caller
drives the engine (``flush``/``result``/``as_completed``).  ``AutoPump``
wraps a server — ``OverlayServer`` or ``ShardedOverlayServer`` — and
runs its drain loop (``server.pump_once``) on a daemon thread, so
``submit`` from concurrent clients is served without an explicit drain
call: the front-end the ROADMAP's "background flush thread" item asked
for.

Concurrency model — one lock, coarse granularity:

* The engines are NOT thread-safe; every pump entry point (``submit``,
  ``result``, ``flush``, ``flush_sync``, ...) and every pump iteration
  holds ONE reentrant lock, so engine state is only ever mutated by one
  thread at a time.  Granularity is a single ``pump_once`` step (launch
  or retire one round), so a concurrent ``submit`` waits at most one
  round's device time — rounds, not drains, are the unit of contention.
* In-flight rounds stay bounded by the server's own ``max_inflight``
  (``pump_once`` fills the pipeline through the same path ``flush``
  uses); the pump adds no new queue depth anywhere.
* ``flush_sync()`` through the pump takes the lock for the whole
  barrier drain — with the pump excluded, it is the engine's
  one-round-at-a-time loop, bit for bit: the oracle stays exact.
* ``close()`` (or leaving the ``with`` block) stops the thread cleanly;
  queued work is NOT dropped — it is simply no longer pumped and can be
  drained explicitly afterwards.
* ELASTIC fleets autoscale on the pump tick: the sharded engine's
  ``pump_once`` observes its ``AutoscalePolicy`` every call — including
  IDLE calls, which the pump keeps issuing at ``poll_interval`` while
  parked.  Those idle ticks are where background scale-DOWNS come from
  (an idle replica's streak can only accrue if someone keeps observing),
  and ``pump_once`` returns True for a tick that only resized the fleet,
  so the pump stays hot through a scaling burst instead of sleeping
  mid-resize.

Waiters (``result``/``wait_idle``) sleep on a condition variable that
the pump notifies after every delivered round; if the pump is closed
under them or its thread dies (engine bug), waiters raise instead of
hanging forever (already-delivered results are still claimable first).
"""

from __future__ import annotations

import threading
import time


class AutoPump:
    """Background drain thread over one serving engine.

    ``server`` must expose the engine surface this package gives both
    engines: ``submit`` / ``pump_once`` / ``try_result`` / ``flush`` /
    ``flush_sync`` / ``pending`` / ``stats``.

    ::

        with AutoPump(OverlayServer(bank_capacity=8)) as pump:
            t = pump.submit(kernel, xs, tenant="alice")
            outs = pump.result(t)          # pump delivers in background
    """

    def __init__(self, server, poll_interval: float = 0.005,
                 telemetry=None):
        from repro_torch.telemetry import InMemorySink
        if poll_interval <= 0:
            raise ValueError(
                f"poll_interval must be > 0, got {poll_interval}")
        self.server = server
        self.poll_interval = poll_interval
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._wake = threading.Event()
        self._stop = threading.Event()
        #: the structured sink the pump counters live in — by default
        #: the WRAPPED SERVER's sink, so one store carries engine and
        #: pump telemetry together (see repro_torch.telemetry)
        self.telemetry = (telemetry if telemetry is not None
                          else getattr(server, "telemetry", None)
                          or InMemorySink())
        #: tick observers, called AFTER every pump iteration (worked or
        #: idle) from the pump thread with the lock RELEASED — see
        #: ``add_tick_listener``
        self._listeners: list = []
        self._thread = threading.Thread(target=self._run,
                                        name="overlay-autopump", daemon=True)
        self._thread.start()

    @property
    def n_pump_rounds(self) -> int:
        """Productive pump iterations (a round delivered / fleet resized)."""
        return int(self.telemetry.counter("pump.rounds"))

    @property
    def n_listener_errors(self) -> int:
        """Tick listeners that raised (counted, skipped, never fatal)."""
        return int(self.telemetry.counter("pump.listener_errors"))

    # ------------------------------------------------------------ observers
    def add_tick_listener(self, fn) -> None:
        """Register ``fn(worked: bool)`` to run after every pump iteration.

        Called from the PUMP THREAD with the engine lock released, on
        both productive ticks (a round delivered / the fleet resized) and
        idle ticks — idle ticks are how an observer sees pressure DROP,
        so edge backpressure (the asyncio gateway) can relax without
        waiting for new traffic.  Listeners must be cheap and must not
        re-enter the pump's blocking API; hand off to another thread or
        event loop (``loop.call_soon_threadsafe``) instead.  A listener
        that raises is counted (``n_listener_errors``) and skipped, never
        allowed to kill the pump thread.
        """
        self._listeners.append(fn)

    def remove_tick_listener(self, fn) -> None:
        """Unregister a tick listener (no-op when not registered)."""
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def _notify_listeners(self, worked: bool) -> None:
        for fn in list(self._listeners):
            try:
                fn(worked)
            except Exception:
                self.telemetry.inc("pump.listener_errors")

    # ------------------------------------------------------------ pump loop
    def _run(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                worked = self.server.pump_once()
                self.telemetry.inc("pump.ticks")
                if worked:
                    self.telemetry.inc("pump.rounds")
                    self._cond.notify_all()
                else:
                    self.telemetry.inc("pump.idle_ticks")
            self._notify_listeners(worked)
            if not worked:
                # idle: sleep until a submit wakes us (or the poll tick —
                # belt and braces for externally-enqueued work)
                self._wake.wait(self.poll_interval)
                self._wake.clear()

    def _check_alive(self) -> None:
        """A waiter whose pump can no longer deliver must raise, not spin:
        closed pump (the owner shut it down under the waiter) and dead
        thread (engine bug) both end the wait."""
        if self._stop.is_set():
            raise RuntimeError(
                "autopump is closed; drain the server explicitly "
                "(flush/flush_sync) to claim remaining work")
        if not self._thread.is_alive():
            raise RuntimeError(
                "autopump thread died; server state may be inconsistent")

    # ------------------------------------------------------------- clients
    def submit(self, kernel, xs, tenant=None) -> int:
        """Thread-safe ``server.submit``; the pump serves it in background."""
        kw = {} if tenant is None else {"tenant": tenant}
        with self._lock:
            ticket = self.server.submit(kernel, xs, **kw)
        self._wake.set()
        return ticket

    def submit_work(self, fn, tenant=None, **kw) -> int:
        """Thread-safe ``server.submit_work``; the pump runs ``fn`` on
        its own thread when the round policy grants the flow a slot.
        NOTE the pump holds the engine lock for a whole pump tick, so a
        work callable observes concurrent latency submits only at
        round boundaries — bulk submitters should keep work items small."""
        if tenant is not None:
            kw["tenant"] = tenant
        with self._lock:
            ticket = self.server.submit_work(fn, **kw)
        self._wake.set()
        return ticket

    def try_result(self, ticket: int):
        """Non-blocking thread-safe claim (see ``server.try_result``)."""
        with self._lock:
            return self.server.try_result(ticket)

    def try_results(self, tickets) -> dict:
        """Batch non-blocking claim under ONE lock acquisition.

        Returns ``{ticket: outputs}`` for every ticket already delivered;
        still-pending tickets are simply absent.  A ticket ``try_result``
        would raise for (unknown, or already claimed) maps to the
        ``KeyError`` instance instead of raising, so one bad ticket
        cannot mask the rest of the batch — the asyncio gateway fans
        these back out to per-ticket awaiters.
        """
        out: dict = {}
        with self._lock:
            for t in tickets:
                try:
                    r = self.server.try_result(t)
                except KeyError as e:
                    out[t] = e
                    continue
                if r is not None:
                    out[t] = r
        return out

    def result(self, ticket: int, timeout: float | None = None):
        """Block until the pump delivers ``ticket``; claim-once semantics.

        Unlike ``server.result``, this never drives the pipeline from the
        calling thread — it waits for the background pump, so any number
        of client threads can block here concurrently.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                out = self.server.try_result(ticket)
                if out is not None:
                    return out
                self._check_alive()
                wait = (self.poll_interval if deadline is None
                        else min(self.poll_interval,
                                 deadline - time.monotonic()))
                if deadline is not None and wait <= 0:
                    raise TimeoutError(
                        f"ticket {ticket} not delivered within {timeout}s")
                self._wake.set()
                self._cond.wait(wait)

    def wait_idle(self, timeout: float | None = None) -> None:
        """Block until the server has no undelivered work."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self.server.pending:
                self._check_alive()
                wait = (self.poll_interval if deadline is None
                        else min(self.poll_interval,
                                 deadline - time.monotonic()))
                if deadline is not None and wait <= 0:
                    raise TimeoutError(
                        f"server not idle within {timeout}s "
                        f"({self.server.pending} pending)")
                self._wake.set()
                self._cond.wait(wait)

    def flush(self) -> dict:
        """Pipelined drain of everything queued (pump excluded meanwhile)."""
        with self._lock:
            return self.server.flush()

    def flush_sync(self) -> dict:
        """The engine's barrier drain, pump excluded for its whole span —
        the bit-for-bit oracle is unchanged by pumping."""
        with self._lock:
            return self.server.flush_sync()

    @property
    def pending(self) -> int:
        with self._lock:
            return self.server.pending

    def stats(self) -> dict:
        with self._lock:
            s = dict(self.server.stats())
        s["pump_rounds"] = self.n_pump_rounds
        s["pump_alive"] = self._thread.is_alive()
        s["pump_listeners"] = len(self._listeners)
        s["pump_listener_errors"] = self.n_listener_errors
        return s

    # ------------------------------------------------------------ shutdown
    @property
    def closed(self) -> bool:
        """True once `close()` was requested; the drain thread is
        stopping (or stopped) and ``poll_interval`` no longer predicts
        anything — edge layers fall back to their own retry hints."""
        return self._stop.is_set()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the pump thread (idempotent).  Queued work is kept — drain
        it explicitly (``flush``/``flush_sync``) if needed."""
        self._stop.set()
        self._wake.set()
        with self._cond:
            self._cond.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():        # pragma: no cover - hung device
            raise RuntimeError("autopump thread did not stop")

    def __enter__(self) -> "AutoPump":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
