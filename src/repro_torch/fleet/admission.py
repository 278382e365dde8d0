"""Admission control: per-tenant quotas + bounded queues + load shedding.

The fleet's front door applies three gates, in order, before an update
may enter a tenant's log:

  1. **load shedding** — under the ``"shedding"`` overload tier,
     sheddable tenants' updates are refused outright (:data:`SHED`);
     reserved-capacity tenants (``sheddable=False``) pass;
  2. **token-bucket quota** — each tenant refills at ``quota_rate``
     updates/s up to ``quota_burst``; a noisy producer is throttled
     (:data:`THROTTLED`) before it can monopolize worker time;
  3. **bounded log** — a tenant whose pending (unapplied) log is full
     gets :data:`QUEUE_FULL` back-pressure instead of unbounded memory
     growth.  Rejection is the contract: the producer retries, the
     fleet never OOMs on behalf of its slowest tenant.

All decisions are returned as strings so callers (and tests) can
histogram them; nothing here raises on a refused update.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

ADMITTED = "admitted"
THROTTLED = "throttled"      # token bucket empty — retry later
QUEUE_FULL = "queue_full"    # pending log at capacity — back-pressure
SHED = "shed"                # overload tier sheds this tenant's traffic

DECISIONS = (ADMITTED, THROTTLED, QUEUE_FULL, SHED)


class TokenBucket:
    """Classic token bucket with an injectable clock (thread-safe).

    ``rate`` is tokens/second (``float("inf")`` = unmetered), ``burst``
    the bucket depth.  The bucket starts full so a fresh tenant can
    burst immediately.
    """

    def __init__(self, rate: float, burst: int,
                 clock: Callable[[], float] = time.monotonic):
        if burst < 1:
            raise ValueError(f"burst must be ≥ 1, got {burst}")
        self.rate = float(rate)
        self.burst = int(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()
        self._lock = threading.Lock()

    def allow(self, n: int = 1) -> bool:
        """Consume ``n`` tokens if available."""
        if self.rate == float("inf"):
            return True
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def available(self) -> float:
        with self._lock:
            now = self._clock()
            return min(self.burst,
                       self._tokens + (now - self._last) * self.rate)


class AdmissionController:
    """Per-tenant buckets + the tier-aware admission decision."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}

    def register(self, spec) -> None:
        self._buckets[spec.tenant_id] = TokenBucket(
            spec.quota_rate, spec.quota_burst, self._clock)

    def unregister(self, tenant_id: str) -> None:
        self._buckets.pop(tenant_id, None)

    def admit(self, tenant, tier: str, n: int = 1) -> str:
        """Decide one submission of ``n`` logical updates for ``tenant``
        (a :class:`repro_torch.fleet.tenant.Tenant`) under overload ``tier``.
        Order matters: shedding is checked first (no quota tokens are
        burned on traffic the tier refuses anyway), then quota, then
        queue capacity."""
        spec = tenant.spec
        if tier == "shedding" and spec.sheddable:
            return SHED
        bucket = self._buckets.get(spec.tenant_id)
        if bucket is not None and not bucket.allow(n):
            return THROTTLED
        if tenant.log.pending_count(tenant.applied_lsn) + n \
                > spec.queue_capacity:
            return QUEUE_FULL
        return ADMITTED

    def available(self, tenant_id: str) -> float:
        bucket = self._buckets.get(tenant_id)
        return float("inf") if bucket is None else bucket.available()
