"""Elastic fleet autoscaling: grow/drain serving replicas under load.

The paper's area result comes from refusing to provision one FU per
operation: a small pool of time-multiplexed FUs absorbs the whole kernel
because switching is cheap.  A serving fleet provisioned for peak makes
the same mistake one level up — N device-pinned replicas stay alive
through every lull.  An :class:`AutoscalePolicy` closes the loop: it
watches the fleet's queue pressure and tells the shell
(``launch.serve.ShardedOverlayServer``) when to ``add_replica()`` and
when to ``drain_replica(i)``, so the replica count tracks offered load
the way the overlay's FU count tracks the DFG, not the op count.

The policy only DECIDES; the shell owns the mechanics (construct a
replica on the least-shared device, evacuate a draining replica's queued
work over the steal/adopt path, retire its in-flight rounds, unpublish
its directory entries).  Decisions are observed from every drain loop —
``flush`` passes, ``as_completed`` passes, and the ``sched.pump.AutoPump``
tick — so scaling happens both under an explicit drain and in background
serving.  ``flush_sync`` never scales: it stays the bit-for-bit oracle.

:class:`PressureAutoscaler` is the shipped policy — hysteresis on queue
pressure with a cooldown, the classic control shape:

* **up** when the fleet's mean queued tiles per replica has exceeded
  ``up_tiles`` for ``up_rounds`` CONSECUTIVE observations (a one-round
  blip never pays a replica construction);
* **down** when some replica has had zero pending tiles (nothing queued,
  nothing in flight) for ``down_rounds`` consecutive observations — the
  longest-idle replica drains first;
* at most one action per observation, at least ``cooldown_s`` seconds
  (on an injectable ``clock``) between actions, and the replica count
  clamped to ``[min_replicas, max_replicas]``.
"""

from __future__ import annotations

import time
from typing import Protocol, runtime_checkable

#: an autoscale decision: ("up", None) or ("down", replica_index)
Action = tuple


@runtime_checkable
class AutoscalePolicy(Protocol):
    """What the sharded shell needs from an autoscaling policy.

    ``observe`` is called once per drain pass / pump tick with the fleet
    (``ShardedOverlayServer``) and returns the actions to apply NOW —
    ``("up", None)`` to add a replica, ``("down", i)`` to drain replica
    ``i`` — or an empty list.  The shell applies them immediately via
    ``add_replica``/``drain_replica`` and re-checks its own invariants
    (it never drains the last replica), so a policy bug degrades to a
    no-op, not a lost ticket.
    """

    def observe(self, fleet) -> list[Action]: ...

    def stats(self) -> dict: ...

    def reset_metrics(self) -> None: ...


class PressureAutoscaler:
    """Hysteresis-with-cooldown autoscaling on fleet queue pressure.

    Scale-up pressure is the fleet-wide MEAN queued tiles per replica
    (``OverlayServer.queued_tiles``): queued-only work is what another
    replica could actually absorb (in-flight rounds are committed to
    their device), and the mean keeps the threshold meaningful as the
    fleet grows — the same backlog over twice the replicas is half the
    pressure.  Scale-down watches ``pending_tiles`` (queued AND in
    flight): a replica is only idle when nothing it owns is undelivered.

    Both directions require the condition to hold for a consecutive run
    of observations (``up_rounds`` / ``down_rounds``) — the hysteresis —
    and every applied action arms a shared ``cooldown_s`` timer, so the
    fleet cannot thrash grow/drain around a threshold.  An observation
    that breaks the run resets its streak to zero.

    The clock is injectable (tests drive cooldown deterministically);
    per-replica idle streaks are keyed on the replica OBJECT, so index
    compaction after a drain cannot misattribute another replica's
    history.
    """

    def __init__(self, up_tiles: float = 32.0, up_rounds: int = 3,
                 down_rounds: int = 8, cooldown_s: float = 0.0,
                 min_replicas: int = 1, max_replicas: int = 8,
                 clock=time.monotonic, telemetry=None):
        if up_tiles <= 0:
            raise ValueError(f"up_tiles must be > 0, got {up_tiles}")
        if up_rounds < 1 or down_rounds < 1:
            raise ValueError(
                f"up_rounds/down_rounds must be >= 1, got "
                f"{up_rounds}/{down_rounds}")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}")
        self.up_tiles = up_tiles
        self.up_rounds = up_rounds
        self.down_rounds = down_rounds
        self.cooldown_s = cooldown_s
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.clock = clock
        self._hot_streak = 0
        self._idle: dict = {}           # replica object -> idle-obs streak
        self._last_action: float | None = None
        self._last_n = 0                # fleet size at last observation
        from repro_torch.telemetry import InMemorySink
        #: structured sink the decision counters live in; an attaching
        #: fleet re-binds this to its shared sink (see repro_torch.telemetry)
        self.telemetry = (telemetry if telemetry is not None
                          else InMemorySink(clock=clock))

    @property
    def n_observations(self) -> int:
        return int(self.telemetry.counter("autoscaler.observations"))

    @property
    def n_up_decisions(self) -> int:
        return int(self.telemetry.counter("autoscaler.up_decisions"))

    @property
    def n_down_decisions(self) -> int:
        return int(self.telemetry.counter("autoscaler.down_decisions"))

    @property
    def n_saturated_observations(self) -> int:
        return int(self.telemetry.counter(
            "autoscaler.saturated_observations"))

    # ------------------------------------------------------- edge coupling
    @property
    def scale_up_pending(self) -> bool:
        """Pressure has been observed and the fleet can still grow.

        The serving gateway's backpressure coupling reads this: capacity
        is (probably) coming, so the edge should WIDEN its admission
        window — queue a little more instead of shedding — and revert
        the widening once the scale-up lands (the hot streak resets to
        zero on the ``up`` decision, so this flips back automatically).
        """
        return self._hot_streak >= 1 and self._last_n < self.max_replicas

    @property
    def saturated(self) -> bool:
        """The policy wants to grow but the fleet is at ``max_replicas``.

        No more capacity is coming: the edge must shed (or park work in
        its own queue) instead of pushing depth into the fleet.  True
        when the hot streak has fully ripened (>= ``up_rounds``) while
        the fleet sits at its ceiling — exactly the state in which
        ``observe`` would have returned ``("up", None)`` but could not.
        """
        return (self._hot_streak >= self.up_rounds
                and self._last_n >= self.max_replicas)

    # ------------------------------------------------------------- observe
    def observe(self, fleet) -> list[Action]:
        replicas = list(fleet.replicas)
        n = len(replicas)
        self._last_n = n
        self.telemetry.inc("autoscaler.observations")
        # streaks update on EVERY observation — the cooldown gates actions,
        # not evidence, so pressure seen during cooldown still counts
        pressure = sum(rep.queued_tiles for rep in replicas) / max(1, n)
        self._hot_streak = self._hot_streak + 1 if pressure >= self.up_tiles \
            else 0
        live = set(id(rep) for rep in replicas)
        self._idle = {r: c for r, c in self._idle.items()
                      if id(r) in live}
        for rep in replicas:
            self._idle[rep] = (self._idle.get(rep, 0) + 1
                               if rep.pending_tiles == 0 else 0)
        if self.saturated:
            self.telemetry.inc("autoscaler.saturated_observations")
        if (self._last_action is not None
                and self.clock() - self._last_action < self.cooldown_s):
            return []
        if self._hot_streak >= self.up_rounds and n < self.max_replicas:
            self._hot_streak = 0
            self._last_action = self.clock()
            self.telemetry.inc("autoscaler.up_decisions")
            self.telemetry.event("autoscale_up", pressure=pressure, fleet=n)
            return [("up", None)]
        if n > self.min_replicas:
            ripe = [(self._idle.get(rep, 0), i)
                    for i, rep in enumerate(replicas)
                    if self._idle.get(rep, 0) >= self.down_rounds]
            if ripe:
                _, i = max(ripe)
                self._idle.pop(replicas[i], None)
                self._last_action = self.clock()
                self.telemetry.inc("autoscaler.down_decisions")
                self.telemetry.event("autoscale_down", replica=i, fleet=n)
                return [("down", i)]
        return []

    # ------------------------------------------------------------- metrics
    def stats(self) -> dict:
        return {"autoscaler": type(self).__name__,
                "up_tiles": self.up_tiles,
                "up_rounds": self.up_rounds,
                "down_rounds": self.down_rounds,
                "cooldown_s": self.cooldown_s,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "observations": self.n_observations,
                "up_decisions": self.n_up_decisions,
                "down_decisions": self.n_down_decisions,
                "hot_streak": self._hot_streak,
                "scale_up_pending": self.scale_up_pending,
                "saturated": self.saturated,
                "saturated_observations": self.n_saturated_observations}

    def reset_metrics(self) -> None:
        """Drop decision counters; streaks and the cooldown timer are
        control state, not metrics, and are kept."""
        self.telemetry.reset(prefix="autoscaler.")
