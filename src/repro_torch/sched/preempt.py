"""Preemptible bulk tier: latency traffic provably starves bulk work.

The paper's overlay keeps ONE FU pipeline busy by time-multiplexing it
across kernels; PR 7's ``tenant_quanta`` made the software analogue's
shares tunable, but a quantum only PACES a backlogged tenant — a bulk
flow with credit still lands its tiles in the same round as latency
traffic.  Co-scheduling training under serving needs a harder promise:
bulk work may only occupy round slots the latency tier left idle.

:class:`PreemptibleTier` wraps ANY :class:`~repro_torch.sched.rounds.RoundPolicy`
(so the same guarantee holds under ``drr``/``coalesce``/``dynamic``) and
adds exactly one decision on top:

* if any LATENCY flow has queued work, the round is formed from the
  latency flows alone (the inner policy sees only them — its pacing,
  coalescing, and tile budgeting apply unchanged within the tier);
* only when every latency flow is idle does the bulk tier get a round,
  again formed by the inner policy over the bulk flows alone.

Tiers never mix in one round, which is what makes the starvation bound
STRUCTURAL rather than statistical: a saturated latency tier drives the
bulk tier's throughput to exactly zero (``n_bulk_rounds`` stays flat),
while a saturated bulk tier cannot delay a latency arrival by more than
the one bulk round already in flight.  Preemption GRANULARITY on the
work inside a bulk round is the submitter's job: it slices its work
into micro-rounds and checks for latency arrivals between them
(``OverlayServer.queued_by_tenant`` is the probe).

A tenant is bulk when its name is in ``bulk_tenants`` or starts with
``bulk_prefix`` (default ``"bulk:"``, the convention bulk submitters follow).
"""

from __future__ import annotations

from collections import deque

from repro_torch.sched.rounds import Flow, make_round_policy

#: tenant-name prefix that marks a flow as bulk-tier by convention
BULK_PREFIX = "bulk:"


class PreemptibleTier:
    """Two-tier round formation: bulk flows only run when latency is idle.

    ``inner`` is the policy that forms rounds WITHIN a tier — an
    instance, a registered name (``"drr"``/``"coalesce"``/``"dynamic"``),
    or None for the ``REPRO_ROUND_POLICY``/default resolution.  All
    inner-policy state (deficits, AIMD budgets, coalescing) behaves as
    if each tier were its own engine.

    ``tenant_quanta`` on the inner policy still applies within the bulk
    tier, bounding training's share against OTHER bulk tenants; across
    tiers no quantum is needed — the tier split is absolute.
    """

    def __init__(self, inner=None, *, bulk_tenants=(),
                 bulk_prefix: str = BULK_PREFIX,
                 quantum_tiles: float | None = None):
        if inner is None or isinstance(inner, str):
            inner = make_round_policy(inner, quantum_tiles=quantum_tiles)
        elif quantum_tiles is not None:
            raise ValueError(
                "quantum_tiles was given alongside an inner policy "
                "instance; set the quantum on the policy itself")
        if isinstance(inner, PreemptibleTier):
            raise ValueError("PreemptibleTier cannot wrap itself")
        self.inner = inner
        self.bulk_tenants = set(bulk_tenants)
        self.bulk_prefix = bulk_prefix
        #: rounds formed per tier (the starvation test's structural probe)
        self.n_latency_rounds = 0
        self.n_bulk_rounds = 0

    def add_bulk(self, tenants) -> None:
        """Mark more tenants as bulk-tier (idempotent)."""
        self.bulk_tenants.update(tenants)

    def is_bulk(self, tenant: str) -> bool:
        return (tenant in self.bulk_tenants
                or str(tenant).startswith(self.bulk_prefix))

    # ------------------------------------------------------------ policy API
    def _tier_round(self, rr: deque, round_kernels: int,
                    tier: dict[str, Flow]) -> list | None:
        """Form one round from ``tier``'s flows via the inner policy.

        The inner policy sees a tier-local service order and rotates it;
        the OUTER ``rr`` is rotated here so cross-round fairness within
        a tier advances exactly as it would without the wrapper.
        """
        sub_rr = deque(t for t in rr if t in tier)
        reqs = self.inner.form_round(tier, sub_rr, round_kernels)
        rr.rotate(-1)
        return reqs

    def form_round(self, flows: dict[str, Flow], rr: deque,
                   round_kernels: int) -> list | None:
        if not flows:
            return None
        latency = {t: f for t, f in flows.items()
                   if not self.is_bulk(t) and f.queue}
        if latency:
            self.n_latency_rounds += 1
            return self._tier_round(rr, round_kernels, latency)
        bulk = {t: f for t, f in flows.items()
                if self.is_bulk(t) and f.queue}
        if not bulk:
            return None
        self.n_bulk_rounds += 1
        return self._tier_round(rr, round_kernels, bulk)

    def observe(self, n_tiles: int, wall_s: float) -> None:
        self.inner.observe(n_tiles, wall_s)

    # -------------------------------------------------------------- metrics
    def quantum_for(self, tenant: str):
        """Delegate SLO-class lookups to the inner policy (present on the
        DRR family; absent inner policies report None)."""
        fn = getattr(self.inner, "quantum_for", None)
        return fn(tenant) if fn is not None else None

    def stats(self) -> dict:
        return {"tier_policy": type(self.inner).__name__,
                "bulk_tenants": sorted(self.bulk_tenants),
                "bulk_prefix": self.bulk_prefix,
                "latency_rounds": self.n_latency_rounds,
                "bulk_rounds": self.n_bulk_rounds}
