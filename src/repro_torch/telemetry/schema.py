"""Source-of-truth schema for the serving layers' ``stats()`` dicts.

PRs 2-6 each grew their layer's ``stats()`` by hand; the key sets had
no owner, so a rename or accidental drop surfaced only when a
benchmark's pretty-printer threw a KeyError.  These frozensets are the
contract: `tests/test_stats_schema.py` asserts every layer's stats()
matches them exactly, and CI pydoc-smokes this module so the docs
can't reference keys that don't exist.

Composition mirrors the layering:

- engine stats   = BANK ∪ ENGINE            (OverlayServer.stats)
- fleet stats    = FLEET ∪ ROUTER [∪ STEAL] [∪ AUTOSCALER]
- pump stats     = wrapped server stats ∪ PUMP   (AutoPump.stats)
- gateway stats  = GATEWAY (with ``fleet`` holding the pump's dict)
"""

from __future__ import annotations

# ContextBank.stats(), folded into every engine stats() dict.  ``arena``
# nests the attached RoundArena's occupancy/recycle counters (None when
# the bank serves no pooled rounds) — a leaking arena bucket shows up as
# ``outstanding`` never returning to zero.
BANK_STATS_KEYS = frozenset({
    "capacity", "resident", "free", "loads", "evictions", "hits",
    "pinned", "generation", "ctx_cache", "occupancy", "pinned_fraction",
    "arena",
})

# OverlayServer.stats() minus the bank keys.  ``stage_walls`` nests the
# cumulative plan_s/assemble_s/execute_s/collect_s pipeline walls.
ENGINE_STATS_KEYS = frozenset({
    "submits", "rounds", "requests", "pending", "inflight", "queued",
    "queued_tiles", "tenants", "round_policy", "stage_walls",
    "tenant_latency",
})

# ResidencyRouter.stats(); WorkStealingRouter adds STEAL_STATS_KEYS.
ROUTER_STATS_KEYS = frozenset({
    "router", "route_hits", "route_misses", "residency_hit_rate",
    "migrations", "steals", "directory",
})
STEAL_STATS_KEYS = frozenset({"stolen_requests"})

# PressureAutoscaler.stats(), merged into fleet stats when attached.
AUTOSCALER_STATS_KEYS = frozenset({
    "autoscaler", "up_tiles", "up_rounds", "down_rounds", "cooldown_s",
    "min_replicas", "max_replicas", "observations", "up_decisions",
    "down_decisions", "hot_streak", "scale_up_pending", "saturated",
    "saturated_observations",
})

# ShardedOverlayServer.stats() minus router/autoscaler keys.
# ``stage_walls`` aggregates the whole fleet (replicas write through
# MultiSink to the fleet sink, so drained replicas' walls survive).
FLEET_STATS_KEYS = frozenset({
    "replicas", "submits", "pending", "queue_depth", "queued_tiles",
    "per_replica", "rounds", "requests", "evictions", "scale_ups",
    "scale_downs", "evacuated_requests", "evacuated_tiles",
    "replicas_retired", "retired_lifetime_s", "peak_replicas",
    "orphaned_results", "orphan_claims", "claims", "stage_walls",
    "tenant_latency",
})

# AutoPump.stats() adds these on top of the wrapped server's dict.
PUMP_STATS_KEYS = frozenset({
    "pump_rounds", "pump_alive", "pump_listeners", "pump_listener_errors",
})

# OverlayGateway.stats(); ``fleet`` nests the pump's stats dict.
GATEWAY_STATS_KEYS = frozenset({
    "edge_attempts", "edge_submitted", "edge_shed", "edge_queued",
    "edge_park_cancelled", "edge_waiters", "peak_edge_waiters",
    "peak_fleet_tiles", "max_fleet_tiles", "window", "widened_ticks",
    "connections", "connects", "disconnects", "orphan_sessions",
    "orphaned_tickets", "orphaned_results_held", "orphans_expired",
    "max_orphan_sessions", "reclaimed", "outstanding", "fleet",
})

# OverlaySocketServer.stats(); ``gateway`` nests the gateway's dict.
SOCKET_STATS_KEYS = frozenset({
    "listening", "open_connections", "registered_kernels",
    "wire_frames_in", "wire_frames_out", "wire_bytes_in",
    "wire_bytes_out", "wire_handshakes", "wire_registers",
    "wire_rejects", "wire_connections", "wire_disconnects",
    "wire_reparked", "gateway",
})

# TrainingTenant.stats() (launch.trainer_tenant): the co-scheduled
# training run's own counters.  ``steps``/``micro_rounds`` advance per
# committed yield point; ``preemptions``/``resumes`` count the
# between-micro-step yields to latency traffic and the submits that
# pick the run back up (paired 1:1 once the run finishes);
# ``yield_wall_s`` is host wall spent inside micro-rounds.
TRAIN_STATS_KEYS = frozenset({
    "tenant", "steps", "total_steps", "micro_rounds", "preemptions",
    "resumes", "yield_wall_s", "last_loss", "done", "outstanding",
})

_KINDS = {
    "engine": (BANK_STATS_KEYS | ENGINE_STATS_KEYS, PUMP_STATS_KEYS),
    "fleet": (FLEET_STATS_KEYS | ROUTER_STATS_KEYS,
              STEAL_STATS_KEYS | AUTOSCALER_STATS_KEYS | PUMP_STATS_KEYS),
    "gateway": (GATEWAY_STATS_KEYS, frozenset()),
    "socket": (SOCKET_STATS_KEYS, frozenset()),
    "train": (TRAIN_STATS_KEYS, frozenset()),
}


def check_stats(kind: str, stats: dict) -> None:
    """Assert ``stats`` matches the schema for ``kind``.

    ``kind`` is ``"engine"``, ``"fleet"``, ``"gateway"``,
    ``"socket"``, or ``"train"``.  Every
    required key must be present and no key outside required ∪ optional
    may appear; raises ``AssertionError`` naming the drift either way.
    """
    if kind not in _KINDS:
        raise ValueError(f"unknown stats kind {kind!r}")
    required, optional = _KINDS[kind]
    keys = set(stats)
    missing = required - keys
    extra = keys - required - optional
    assert not missing, f"{kind} stats() missing keys: {sorted(missing)}"
    assert not extra, f"{kind} stats() has undeclared keys: {sorted(extra)}"
