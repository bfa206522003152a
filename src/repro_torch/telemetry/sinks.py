"""Telemetry sinks: the protocol, in-memory, JSONL, and fan-out.

Counter names are dotted, namespaced by the emitting layer:

    engine.*      OverlayServer       (submits, rounds, delivered, ...)
    fleet.*       ShardedOverlayServer (submits, scale_ups, claims, ...)
    router.*      ResidencyRouter / WorkStealingRouter
    pump.*        AutoPump
    autoscaler.*  PressureAutoscaler
    edge.*        OverlayGateway

A counter that was never incremented reads as 0.0 — layers never have
to pre-register names.  `peak()` is a monotone-max gauge under the
same namespace (e.g. ``edge.peak_fleet_tiles``).

Events and step logs are for export, not for control flow: they ride a
bounded deque in memory and become JSON lines on a `JsonlSink`.
"""

from __future__ import annotations

import collections
import io
import json
import os
import threading
import time
from typing import Iterable, Protocol, runtime_checkable


@runtime_checkable
class Telemetry(Protocol):
    """What the serving layers require of a telemetry sink.

    Implementations must be thread-safe: the pump thread, the asyncio
    event loop, and caller threads all write concurrently.
    """

    def inc(self, name: str, value: float = 1.0) -> float:
        """Add ``value`` to counter ``name``; return the new total."""
        ...

    def peak(self, name: str, value: float) -> float:
        """Raise gauge ``name`` to at least ``value``; return the max."""
        ...

    def event(self, name: str, **fields) -> None:
        """Record a structured event (timestamped by the sink clock)."""
        ...

    def log_step(self, step: int, **metrics) -> None:
        """Record one step-log row (wandb-style: step + metric dict)."""
        ...

    def counter(self, name: str) -> float:
        """Read one counter/gauge; 0.0 if never written."""
        ...

    def counters(self, prefix: str = "") -> dict:
        """Snapshot all counters whose name starts with ``prefix``."""
        ...

    def reset(self, names: Iterable[str] = (), prefix: str | None = None) -> None:
        """Zero the named counters (and/or every ``prefix``-ed one)."""
        ...

    def flush(self) -> None:
        """Make buffered records durable (no-op for memory sinks)."""
        ...

    def close(self) -> None:
        """Flush and release resources; the sink stays readable."""
        ...


class InMemorySink:
    """Thread-safe in-memory sink; the default for every layer.

    Counters are exact under concurrency (one lock); events and step
    logs ride bounded deques so a hot loop can emit per-request events
    without growing memory without bound.
    """

    def __init__(self, clock=time.monotonic, max_events: int = 65536):
        self.clock = clock
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._events: collections.deque = collections.deque(maxlen=max_events)
        self._steps: collections.deque = collections.deque(maxlen=max_events)

    # ------------------------------------------------------------- write
    def inc(self, name: str, value: float = 1.0) -> float:
        with self._lock:
            new = self._counters.get(name, 0.0) + value
            self._counters[name] = new
            return new

    def peak(self, name: str, value: float) -> float:
        with self._lock:
            new = max(self._counters.get(name, value), value)
            self._counters[name] = new
            return new

    def event(self, name: str, **fields) -> None:
        rec = {"t": self.clock(), "name": name}
        rec.update(fields)
        with self._lock:
            self._events.append(rec)

    def log_step(self, step: int, **metrics) -> None:
        rec = {"t": self.clock(), "step": step}
        rec.update(metrics)
        with self._lock:
            self._steps.append(rec)

    # -------------------------------------------------------------- read
    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def counters(self, prefix: str = "") -> dict:
        with self._lock:
            return {k: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    def events(self, name: str | None = None) -> list:
        with self._lock:
            evs = list(self._events)
        return evs if name is None else [e for e in evs if e["name"] == name]

    def steps(self) -> list:
        with self._lock:
            return list(self._steps)

    # ----------------------------------------------------------- control
    def reset(self, names: Iterable[str] = (), prefix: str | None = None) -> None:
        with self._lock:
            for n in names:
                self._counters[n] = 0.0
            if prefix is not None:
                for n in list(self._counters):
                    if n.startswith(prefix):
                        self._counters[n] = 0.0

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink:
    """Append-only JSON-lines sink with a crash-safe flush.

    Every event and step log becomes one JSON line the moment it is
    emitted; counters live in an internal `InMemorySink` (a line per
    `inc` would swamp the file on hot paths) and are snapshotted as a
    ``{"kind": "counters", ...}`` line on `flush()` / `close()`.
    `flush()` drains Python's buffer *and* fsyncs, so a crash after a
    flush loses nothing.

    Line schema (see docs/TELEMETRY.md):

        {"kind": "event", "t": ..., "name": ..., **fields}
        {"kind": "step",  "t": ..., "step": ..., **metrics}
        {"kind": "counters", "t": ..., "counters": {...}}
    """

    def __init__(self, path, clock=time.monotonic, max_events: int = 65536):
        self.path = os.fspath(path)
        self.mem = InMemorySink(clock=clock, max_events=max_events)
        self.clock = clock
        self._wlock = threading.Lock()
        self._closed = False
        self._f: io.TextIOWrapper | None = open(self.path, "a", encoding="utf-8")

    @property
    def closed(self) -> bool:
        """True once `close()` ran; the sink stays readable but writes,
        `flush()`, and further `close()` calls are no-ops."""
        return self._closed

    def _write(self, rec: dict) -> None:
        line = json.dumps(rec, sort_keys=True, default=str)
        with self._wlock:
            if self._closed or self._f is None:
                return
            if self._f.closed:          # handle closed out-of-band
                self._f = None
                return
            self._f.write(line + "\n")

    # ------------------------------------------------------------- write
    def inc(self, name: str, value: float = 1.0) -> float:
        return self.mem.inc(name, value)

    def peak(self, name: str, value: float) -> float:
        return self.mem.peak(name, value)

    def event(self, name: str, **fields) -> None:
        self.mem.event(name, **fields)
        rec = {"kind": "event", "t": self.clock(), "name": name}
        rec.update(fields)
        self._write(rec)

    def log_step(self, step: int, **metrics) -> None:
        self.mem.log_step(step, **metrics)
        rec = {"kind": "step", "t": self.clock(), "step": step}
        rec.update(metrics)
        self._write(rec)

    # -------------------------------------------------------------- read
    def counter(self, name: str) -> float:
        return self.mem.counter(name)

    def counters(self, prefix: str = "") -> dict:
        return self.mem.counters(prefix)

    def events(self, name: str | None = None) -> list:
        return self.mem.events(name)

    def steps(self) -> list:
        return self.mem.steps()

    # ----------------------------------------------------------- control
    def reset(self, names: Iterable[str] = (), prefix: str | None = None) -> None:
        self.mem.reset(names, prefix)

    def _snapshot_counters(self) -> None:
        counters = self.mem.counters()
        if counters:
            self._write({"kind": "counters", "t": self.clock(),
                         "counters": counters})

    def flush(self) -> None:
        """Drain Python's buffer and fsync.  A no-op after `close()` —
        flushing a closed sink must never raise on the dead handle."""
        if self._closed:
            return
        self._snapshot_counters()
        with self._wlock:
            self._fsync()

    def close(self) -> None:
        """Snapshot counters, flush, fsync, and close the file.
        Idempotent: a second `close()` (or a `flush()` after) is a
        no-op instead of a ``ValueError`` on the closed handle."""
        if self._closed:
            return
        self._snapshot_counters()
        with self._wlock:
            if self._closed:        # lost a close/close race
                return
            self._closed = True
            self._fsync()
            if self._f is not None:
                try:
                    self._f.close()
                finally:
                    self._f = None

    def _fsync(self) -> None:
        """Flush + fsync the live handle (holding ``_wlock``); tolerates
        a handle something else closed out from under the sink."""
        if self._f is None or self._f.closed:
            self._f = None
            return
        self._f.flush()
        os.fsync(self._f.fileno())


class MultiSink:
    """Fan writes out to several sinks; read through the first.

    The sharded fleet hands each replica ``MultiSink(own, fleet)``:
    the replica's `stats()` reads its own sink (first child) while the
    shared fleet sink accumulates the same increments across every
    replica that ever lived — which is exactly how retired replicas'
    rounds and deliveries survive `drain_replica` without hand-folded
    ``_retired_*`` attributes.
    """

    def __init__(self, *sinks):
        if not sinks:
            raise ValueError("MultiSink needs at least one child sink")
        self.sinks = tuple(sinks)

    # ------------------------------------------------------------- write
    def inc(self, name: str, value: float = 1.0) -> float:
        out = 0.0
        for i, s in enumerate(self.sinks):
            v = s.inc(name, value)
            if i == 0:
                out = v
        return out

    def peak(self, name: str, value: float) -> float:
        out = 0.0
        for i, s in enumerate(self.sinks):
            v = s.peak(name, value)
            if i == 0:
                out = v
        return out

    def event(self, name: str, **fields) -> None:
        for s in self.sinks:
            s.event(name, **fields)

    def log_step(self, step: int, **metrics) -> None:
        for s in self.sinks:
            s.log_step(step, **metrics)

    # -------------------------------------------------- read (first child)
    def counter(self, name: str) -> float:
        return self.sinks[0].counter(name)

    def counters(self, prefix: str = "") -> dict:
        return self.sinks[0].counters(prefix)

    def events(self, name: str | None = None) -> list:
        return self.sinks[0].events(name)

    def steps(self) -> list:
        return self.sinks[0].steps()

    # ----------------------------------------------------------- control
    def reset(self, names: Iterable[str] = (), prefix: str | None = None) -> None:
        # resets stay local to the primary: a replica zeroing its own
        # window must not erase the fleet's aggregate history
        self.sinks[0].reset(names, prefix)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def adopt_counters(dst: Telemetry, src: Telemetry, prefix: str = "") -> None:
    """Fold ``src``'s counters (under ``prefix``) into ``dst``.

    Used when a component built with its own private sink is later
    bound to a shared one (e.g. a router or autoscaler handed to a
    fleet): whatever it counted pre-binding carries over.
    """
    for name, value in src.counters(prefix).items():
        if value:
            dst.inc(name, value)


def read_jsonl(path) -> list:
    """Parse a `JsonlSink` file back into a list of record dicts."""
    out = []
    with open(os.fspath(path), "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
