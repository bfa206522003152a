"""Structured telemetry for the serving stack.

One small protocol (`Telemetry`) carries every counter, peak gauge,
event, and step-log the serving layers emit.  The engines, the fleet,
the pump, the autoscaler, the routers, and the asyncio gateway all
write through a sink instead of growing private ``n_foo`` integers, so
`stats()` on each layer is a read-through over one store and the
conservation invariants (submitted == delivered + pending, scale_ups -
scale_downs == replicas - initial, ...) can be asserted from the
outside at any barrier.

Sinks:

- `InMemorySink` — thread-safe dict of counters plus bounded deques of
  events and step logs; the default everywhere.
- `JsonlSink` — append-only JSON-lines file with a crash-safe
  `flush()` (fsync); wraps an in-memory sink so counter reads stay
  cheap and exact.
- `MultiSink` — fan-out writes to several sinks, reads from the first.
  The sharded fleet gives each replica ``MultiSink(own, fleet_sink)``
  so per-replica stats and fleet aggregates come from one write.

See docs/TELEMETRY.md for the naming scheme and the JSONL schema.
"""

from repro_torch.telemetry.sinks import (
    InMemorySink,
    JsonlSink,
    MultiSink,
    Telemetry,
    adopt_counters,
    read_jsonl,
)
from repro_torch.telemetry.schema import (
    AUTOSCALER_STATS_KEYS,
    BANK_STATS_KEYS,
    ENGINE_STATS_KEYS,
    FLEET_STATS_KEYS,
    GATEWAY_STATS_KEYS,
    PUMP_STATS_KEYS,
    ROUTER_STATS_KEYS,
    SOCKET_STATS_KEYS,
    STEAL_STATS_KEYS,
    TRAIN_STATS_KEYS,
    check_stats,
)

__all__ = [
    "Telemetry",
    "InMemorySink",
    "JsonlSink",
    "MultiSink",
    "adopt_counters",
    "read_jsonl",
    "check_stats",
    "BANK_STATS_KEYS",
    "ENGINE_STATS_KEYS",
    "FLEET_STATS_KEYS",
    "GATEWAY_STATS_KEYS",
    "PUMP_STATS_KEYS",
    "ROUTER_STATS_KEYS",
    "SOCKET_STATS_KEYS",
    "STEAL_STATS_KEYS",
    "TRAIN_STATS_KEYS",
    "AUTOSCALER_STATS_KEYS",
]
