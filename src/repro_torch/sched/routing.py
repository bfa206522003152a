"""Replica-selection policies for the sharded serving fleet.

``launch.serve.ShardedOverlayServer`` owns the replicas (one
``OverlayServer`` + ``ContextBank`` per device) and the global
ticket/delivery bookkeeping; a :class:`RouterPolicy` owns the placement
DECISIONS: which replica serves a submit (``route``) and whether queued
work should move between replicas while draining (``rebalance``).

* :class:`ResidencyRouter` — the original residency-affinity router,
  extracted from the engine: directory-validated residency hits,
  least-loaded fallback on miss/stale, hot-context migration with
  hysteresis + cooldown.  ``rebalance`` is a no-op: residency-only
  routing never moves queued work.
* :class:`WorkStealingRouter` — same routing, plus cross-replica work
  stealing at drain time: an idle replica (no queued tiles) pulls whole
  queued kernel-groups from the most-backlogged replica.  The context is
  prefetched on the thief BEFORE the group moves (a thief whose bank is
  momentarily all pinned skips the steal — pin-safety is preserved, only
  QUEUED requests ever move, never in-flight rounds), and the directory
  entry is republished to the thief so follow-up traffic lands there.

The unit of stealing is the kernel-group (every queued request sharing
one context key) because the context is the unit of residency: moving a
whole group costs ONE context load on the thief and keeps the per-launch
batching intact.  A backlog that is a single giant group cannot be split
by this router — that is the paper's trade restated: work moves at
context granularity, not instruction granularity.

On one GPU the replicas share the card, each on its own CUDA stream: the
router's prefetch writes the target replica's bank, so it runs on that
replica's stream (``OverlayServer.on_stream``), in order with the rounds
that will read the context.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class RouterPolicy(Protocol):
    """What the sharded engine needs from a routing policy.

    ``fleet`` is the ``ShardedOverlayServer`` (replicas, banks, adoption
    hooks).  ``route`` returns the replica index that should enqueue the
    submit; ``rebalance`` may move queued requests between replicas (via
    ``fleet.move_group``, the shared steal/evacuation sequence) and
    returns how many groups moved.
    """

    def route(self, kernel, fleet) -> int: ...

    def rebalance(self, fleet) -> int: ...

    def stats(self) -> dict: ...

    def reset_metrics(self) -> None: ...


class ResidencyRouter:
    """Residency-affinity routing over a shared ``BankDirectory``.

    Routing policy (extracted verbatim from the pre-sched engine):

    1. a directory entry validated against the owning bank's residency
       generation routes the request to the replica already holding its
       context — a residency HIT;
    2. a miss/stale entry falls back to the least-loaded replica (by
       pending tiles), prefetches the context there, and publishes the
       new residency;
    3. when the owner is hot (pending tiles >= ``migrate_factor`` x the
       coolest replica's, by at least ``migrate_min_tiles``) the context
       is re-homed to the coolest replica; ``migrate_cooldown`` (routed
       submits per key) stops a globally-hot key from thrashing.
    """

    def __init__(self, directory=None, migrate_factor: float = 4.0,
                 migrate_min_tiles: int = 16, migrate_cooldown: int = 32,
                 telemetry=None):
        from repro_torch.core.bank import BankDirectory
        from repro_torch.telemetry import InMemorySink
        if migrate_factor < 1:
            raise ValueError(
                f"migrate_factor must be >= 1, got {migrate_factor}")
        self.directory = directory if directory is not None else BankDirectory()
        self.migrate_factor = migrate_factor
        self.migrate_min_tiles = migrate_min_tiles
        self.migrate_cooldown = migrate_cooldown
        self._migrated_at: dict[tuple, int] = {}
        self.n_routed = 0           # cooldown clock: routed submits —
        #                             control state, NOT a metric (resets
        #                             would warp migration cooldowns)
        #: structured sink the routing counters live in; the fleet
        #: re-binds this to its shared sink (see repro_torch.telemetry)
        self.telemetry = telemetry if telemetry is not None else InMemorySink()

    @property
    def n_hits(self) -> int:
        return int(self.telemetry.counter("router.hits"))

    @property
    def n_misses(self) -> int:
        return int(self.telemetry.counter("router.misses"))

    @property
    def n_migrations(self) -> int:
        return int(self.telemetry.counter("router.migrations"))

    # ------------------------------------------------------------- route
    def route(self, kernel, fleet) -> int:
        """Pick the serving replica for one request (see class docstring)."""
        from repro_torch.core.bank import BankError, context_key
        replicas = fleet.replicas
        banks = fleet.banks
        loads = [rep.pending_tiles for rep in replicas]
        coolest = min(range(len(replicas)), key=loads.__getitem__)
        owner = self.directory.locate(kernel, banks)
        if owner is not None:
            hot = (owner != coolest
                   and loads[owner] - loads[coolest] >= self.migrate_min_tiles
                   and loads[owner] >= self.migrate_factor
                   * max(loads[coolest], 1))
            key = context_key(kernel.program)
            last = self._migrated_at.get(key)
            cooled = (last is None
                      or self.n_routed - last >= self.migrate_cooldown)
            if not (hot and cooled):
                self.telemetry.inc("router.hits")
                self.n_routed += 1
                return owner
            target = coolest
            self._migrated_at[key] = self.n_routed
            self.telemetry.inc("router.migrations")
            self.telemetry.event("migrate", key=repr(key), frm=owner,
                                 to=coolest)
        else:
            self.telemetry.inc("router.misses")
            target = coolest
        # warm the context on its new home and publish the residency; a
        # momentarily all-pinned bank defers the load to the replica's own
        # round plan (which retires rounds until it fits)
        try:
            # the prefetch writes the target's bank: on its stream
            with replicas[target].on_stream():
                replicas[target].bank.prefetch([kernel])
            self.directory.publish_current(kernel, target,
                                           replicas[target].bank)
        except BankError:
            self.directory.drop(kernel)
        self.n_routed += 1
        return target

    # --------------------------------------------------------- rebalance
    def rebalance(self, fleet) -> int:
        """Residency-only routing never moves queued work."""
        return 0

    # ----------------------------------------------------------- metrics
    @property
    def hit_rate(self) -> float:
        """Routed-to-resident-replica fraction (stale hits count as
        misses); NaN before any routing decision."""
        n = self.n_hits + self.n_misses
        return self.n_hits / n if n else float("nan")

    def stats(self) -> dict:
        return {"router": type(self).__name__,
                "route_hits": self.n_hits,
                "route_misses": self.n_misses,
                "residency_hit_rate": self.hit_rate,
                "migrations": self.n_migrations,
                "steals": 0,
                "directory": self.directory.stats()}

    def reset_metrics(self) -> None:
        self.telemetry.reset(names=("router.hits", "router.misses",
                                    "router.migrations"))
        d = self.directory
        d.n_fresh = d.n_stale = d.n_unknown = 0
        d.n_republished = d.n_unpublished = 0


class WorkStealingRouter(ResidencyRouter):
    """Residency routing + idle-replica work stealing at drain time.

    ``rebalance`` (called by the fleet's drain loops and the autopump)
    repeatedly moves the most-backlogged replica's largest queued
    kernel-group to an idle replica while:

    * some replica has zero queued tiles (the thief),
    * the victim's queued backlog is at least ``steal_min_tiles``, and
    * the victim holds >= 2 distinct queued groups OR the group is small
      enough (<= half the backlog) that moving it actually balances —
      relocating a lone monolithic group would only churn residency.

    The steal sequence preserves every engine invariant: the thief's bank
    prefetches the context FIRST (failure = skip, never a broken round),
    only queued requests move (in-flight rounds and their pins are
    untouched), per-tenant arrival order is preserved on the thief, and
    the directory is republished so follow-up submits chase the work.
    """

    def __init__(self, directory=None, migrate_factor: float = 4.0,
                 migrate_min_tiles: int = 16, migrate_cooldown: int = 32,
                 steal_min_tiles: int = 4, telemetry=None):
        super().__init__(directory, migrate_factor, migrate_min_tiles,
                         migrate_cooldown, telemetry=telemetry)
        if steal_min_tiles < 1:
            raise ValueError(
                f"steal_min_tiles must be >= 1, got {steal_min_tiles}")
        self.steal_min_tiles = steal_min_tiles

    @property
    def n_steals(self) -> int:
        return int(self.telemetry.counter("router.steals"))

    @property
    def n_stolen_requests(self) -> int:
        return int(self.telemetry.counter("router.stolen_requests"))

    def _pick_group(self, victim) -> tuple | None:
        """The victim's best queued kernel-group to move: largest by
        tiles, subject to the balance guard.  Returns (key, kernel,
        tiles) or None."""
        groups: dict[tuple, list] = {}
        total = 0
        for flow in victim._flows.values():
            for r in flow.queue:
                groups.setdefault(r.key, []).append(r)
                total += r.cost
        if not groups:
            return None
        sized = sorted(((sum(r.cost for r in rs), key, rs[0].kernel)
                        for key, rs in groups.items()), reverse=True,
                       key=lambda g: g[0])
        for tiles, key, kern in sized:
            if len(groups) >= 2 or tiles * 2 <= total:
                return key, kern, tiles
        return None

    def rebalance(self, fleet) -> int:
        from repro_torch.core.bank import BankError
        moved = 0
        # bounded sweep: each pass moves one group; a pass that cannot
        # find (idle thief, rich victim, movable group) ends the sweep
        for _ in range(4 * len(fleet.replicas)):
            queued = [rep.queued_tiles for rep in fleet.replicas]
            idle = [i for i, q in enumerate(queued) if q == 0]
            if not idle:
                break
            victim = max(range(len(queued)), key=queued.__getitem__)
            if queued[victim] < self.steal_min_tiles:
                break
            picked = self._pick_group(fleet.replicas[victim])
            if picked is None:
                break
            key, kernel, _tiles = picked
            # the work goes to the idle replica whose PHYSICAL device is
            # least loaded (replicas may wrap onto shared devices — two
            # idle replicas on one device are one execution resource, so
            # piling stolen groups onto both buys nothing), ties broken
            # by the replica's own pending tiles
            dev_load: dict = {}
            devices = getattr(fleet, "devices", None)
            if devices is not None:
                for rep, dev in zip(fleet.replicas, devices):
                    dev_load[dev] = dev_load.get(dev, 0) + rep.pending_tiles
            thief = min(idle, key=lambda i: (
                dev_load.get(devices[i], 0) if devices is not None else 0,
                fleet.replicas[i].pending_tiles))
            try:
                # fleet.move_group is the one implementation of the move
                # sequence (prefetch on the thief BEFORE anything moves —
                # a momentarily all-pinned thief bank raises and the
                # sweep ends, never stranding requests on a replica that
                # cannot host their context — then directory republish,
                # then steal + adopt); drain_replica evacuates through
                # the same path
                stolen = fleet.move_group(victim, thief, key, kernel)
            except BankError:
                break
            if not stolen:
                break
            self.telemetry.inc("router.steals")
            self.telemetry.inc("router.stolen_requests", len(stolen))
            self.telemetry.event("steal", victim=victim, thief=thief,
                                 requests=len(stolen))
            moved += 1
        return moved

    def stats(self) -> dict:
        s = super().stats()
        s["steals"] = self.n_steals
        s["stolen_requests"] = self.n_stolen_requests
        return s

    def reset_metrics(self) -> None:
        super().reset_metrics()
        self.telemetry.reset(names=("router.steals",
                                    "router.stolen_requests"))


def make_router(steal: bool = False, **kw):
    """Build the fleet's default router: residency-only, or + stealing."""
    return WorkStealingRouter(**kw) if steal else ResidencyRouter(
        **{k: v for k, v in kw.items() if k != "steal_min_tiles"})
