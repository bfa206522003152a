"""Per-tenant token-bucket admission control.

Extracted from ``launch.serve`` so admission is a scheduling policy like
round formation and routing, not engine plumbing.  ``OverlayServer``
applies one :class:`AdmissionControl` per engine; the sharded fleet
applies one GLOBALLY (in the router layer), so a tenant cannot dodge its
rate by having its kernels land on different replicas.  Token costs are
dispatch tiles (``ceil(batch / tile)``) — see docs/SERVING.md.
"""

from __future__ import annotations

import math
import time


class AdmissionError(RuntimeError):
    """A tenant exceeded its token-bucket rate.

    ``retry_after`` is the seconds until the request would be admitted —
    ``math.inf`` when the request's cost exceeds the bucket's burst, i.e.
    it can NEVER be admitted under the current policy (don't retry it;
    split the request or raise the tenant's burst).
    """

    def __init__(self, tenant: str, retry_after: float):
        if math.isinf(retry_after):
            msg = (f"tenant {tenant!r}: request cost exceeds the bucket "
                   f"burst; it can never be admitted under this policy")
        else:
            msg = (f"tenant {tenant!r} over admission rate; "
                   f"retry in {retry_after:.3f}s")
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after = retry_after


class TokenBucket:
    """Token-bucket rate limiter (tokens = dispatch tiles, see SERVING.md).

    ``rate`` tokens accrue per second up to ``burst``; ``try_acquire``
    spends tokens if available.  The clock is injectable so tests can
    advance time deterministically.
    """

    def __init__(self, rate: float, burst: float | None = None,
                 clock=time.monotonic):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else rate)
        self.tokens = self.burst
        self.clock = clock
        self._t = clock()

    def _refill(self) -> None:
        now = self.clock()
        self.tokens = min(self.burst, self.tokens + (now - self._t) * self.rate)
        self._t = now

    def try_acquire(self, cost: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False

    def retry_after(self, cost: float = 1.0) -> float:
        """Seconds until ``cost`` tokens will be available."""
        self._refill()
        return max(0.0, (cost - self.tokens) / self.rate)


class AdmissionControl:
    """Per-tenant token-bucket admission for one serving front-end.

    ``admission`` maps tenant -> TokenBucket (or a ``(rate, burst)`` spec);
    ``default_admission`` is applied lazily to tenants without an explicit
    bucket.  Shared by ``OverlayServer`` (single bank) and
    ``ShardedOverlayServer`` (where admission must span all replicas — a
    tenant cannot dodge its rate by having its kernels land on different
    replicas, so the buckets live in the router, not per replica).
    """

    #: bucket-count high-water mark before lazily-created default buckets
    #: are pruned — an unbounded tenant-label space must not leak buckets
    MAX_BUCKETS = 4096

    def __init__(self, admission: dict | None = None,
                 default_admission: tuple | None = None,
                 clock=time.monotonic):
        self.clock = clock
        self._buckets: dict[str, TokenBucket] = {}
        for tenant, spec in (admission or {}).items():
            self._buckets[tenant] = (spec if isinstance(spec, TokenBucket)
                                     else TokenBucket(*spec, clock=clock))
        self.default_admission = default_admission
        self._default_buckets: set[str] = set()
        #: admission WINDOW: a multiplicative widening of every bucket,
        #: applied at admit time (effective cost = cost / window).  The
        #: serving gateway raises it above 1.0 while the autoscaler has a
        #: scale-up pending — capacity is coming, so the edge may admit
        #: more than steady-state rate — and reverts it to 1.0 when the
        #: scale-up lands (see launch/gateway.py).  Bucket state is
        #: untouched, so reverting is instant and carries no debt.
        self.window = 1.0

    def set_window(self, window: float) -> None:
        """Set the admission window (1.0 = nominal; > 1 admits more)."""
        if window <= 0:
            raise ValueError(f"window must be > 0, got {window}")
        self.window = float(window)

    def admit(self, tenant: str, cost: float) -> None:
        """Spend ``cost`` tokens from the tenant's bucket or raise
        :class:`AdmissionError`; tenants with no bucket (and no default
        policy) are always admitted.  ``cost`` is scaled by the current
        admission ``window`` before it meets the bucket."""
        cost = cost / self.window
        bucket = self._buckets.get(tenant)
        if bucket is None and self.default_admission is not None:
            bucket = TokenBucket(*self.default_admission, clock=self.clock)
            self._buckets[tenant] = bucket
            self._default_buckets.add(tenant)
            if len(self._buckets) > self.MAX_BUCKETS:
                # a refilled-to-burst default bucket carries no state
                for t in list(self._default_buckets):
                    b = self._buckets[t]
                    b._refill()
                    if t != tenant and b.tokens >= b.burst:
                        del self._buckets[t]
                        self._default_buckets.discard(t)
        if bucket is not None and not bucket.try_acquire(cost):
            retry = (math.inf if cost > bucket.burst
                     else bucket.retry_after(cost))
            raise AdmissionError(tenant, retry)
