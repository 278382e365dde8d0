"""Lease-based work claims — crash-safe coordination with no leader.

A refresh worker that wants to fire a tenant's dirty views **claims**
the tenant under a TTL lease; commit requires the lease to still be
current.  There is no leader election and no failure detector: a
crashed worker simply stops renewing, its lease expires, and any other
worker reclaims the tenant and replays from the tenant's update log.
Safety comes from two mechanisms:

  * **fencing tokens** — every claim gets a per-tenant monotonically
    increasing token; a commit (or renew, or release) presented with a
    superseded token is rejected, so a slow worker that lost its lease
    mid-claim can never clobber the reclaimer's work;
  * **expiry-checked commits** — a lease past its TTL fails
    :meth:`LeaseStore.is_current` even when nobody reclaimed yet, so
    the slow worker rolls back *itself* instead of racing the clock.

The store is process-local (one lock) by design: the fleet runs its
workers as threads over in-memory engines, and the protocol — claim /
fence / expire / reclaim — is exactly what a shared lease table (DB
row, object-store conditional put) would enforce for a multi-process
fleet.  Everything takes an injectable ``clock`` so chaos runs and
tests drive virtual time deterministically.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass
class Lease:
    """One worker's live claim on one tenant."""

    tenant_id: str
    worker_id: str
    token: int            # fencing token: monotone per tenant
    expires_at: float
    released: bool = False

    def __repr__(self) -> str:
        state = "released" if self.released else f"until={self.expires_at:.3f}"
        return (f"Lease({self.tenant_id!r} -> {self.worker_id!r} "
                f"#{self.token} {state})")


class LeaseStore:
    """Per-tenant TTL leases with fencing tokens (thread-safe)."""

    def __init__(self, ttl: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if ttl <= 0:
            raise ValueError(f"lease ttl must be positive, got {ttl}")
        self.ttl = ttl
        self._clock = clock
        self._lock = threading.Lock()
        self._leases: Dict[str, Lease] = {}
        self._tokens: Dict[str, int] = {}
        self.claims = 0
        self.reclaims = 0       # claims that displaced an expired holder
        self.fence_rejections = 0
        self.broken = 0         # chaos-forced expiries

    # -- claim lifecycle -----------------------------------------------------
    def claim(self, tenant_id: str, worker_id: str) -> Optional[Lease]:
        """Claim ``tenant_id`` for ``worker_id``; None while a live
        (unexpired, unreleased) lease is held by anyone — including this
        worker: claims are not reentrant, one claim = one firing cycle."""
        with self._lock:
            now = self._clock()
            cur = self._leases.get(tenant_id)
            if cur is not None and not cur.released:
                if now < cur.expires_at:
                    return None
                # expired uncommitted claim: the holder crashed or
                # stalled — reclaim (the new token fences the old holder)
                self.reclaims += 1
            token = self._tokens.get(tenant_id, 0) + 1
            self._tokens[tenant_id] = token
            lease = Lease(tenant_id, worker_id, token, now + self.ttl)
            self._leases[tenant_id] = lease
            self.claims += 1
            return lease

    def renew(self, lease: Lease) -> bool:
        """Extend a still-current lease by one TTL; False (no extension)
        once fenced or expired — a worker that failed to renew must
        abandon its claim, not keep working."""
        with self._lock:
            if not self._current(lease):
                self.fence_rejections += 1
                return False
            lease.expires_at = self._clock() + self.ttl
            return True

    def release(self, lease: Lease) -> bool:
        """Give the tenant back (after commit or a clean failure).
        False when the lease was already fenced/expired — the caller's
        work must have been rolled back by then."""
        with self._lock:
            if not self._current(lease):
                self.fence_rejections += 1
                return False
            lease.released = True
            del self._leases[lease.tenant_id]
            return True

    # -- fencing checks ------------------------------------------------------
    def _current(self, lease: Lease) -> bool:
        cur = self._leases.get(lease.tenant_id)
        return (cur is lease and not lease.released
                and self._clock() < lease.expires_at)

    def is_current(self, lease: Lease) -> bool:
        """The commit-time fencing check: this exact token, unreleased,
        unexpired.  A False here means the claim's work MUST be rolled
        back — another worker may already be replaying it."""
        with self._lock:
            return self._current(lease)

    def holder(self, tenant_id: str) -> Optional[Lease]:
        """The live lease on a tenant (None when free or expired)."""
        with self._lock:
            cur = self._leases.get(tenant_id)
            if (cur is None or cur.released
                    or self._clock() >= cur.expires_at):
                return None
            return cur

    def break_lease(self, tenant_id: str) -> bool:
        """Force-expire the current lease (chaos: ``lease_expiry_p``).
        The holder's next fencing check fails exactly as if the TTL had
        run out under it."""
        with self._lock:
            cur = self._leases.get(tenant_id)
            if cur is None or cur.released:
                return False
            cur.expires_at = self._clock()
            self.broken += 1
            return True

    def expired(self) -> List[Lease]:
        """Unreleased leases past their TTL — claims whose holder died
        or stalled, waiting to be reclaimed."""
        with self._lock:
            now = self._clock()
            return [l for l in self._leases.values()
                    if not l.released and now >= l.expires_at]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"claims": self.claims, "reclaims": self.reclaims,
                    "fence_rejections": self.fence_rejections,
                    "broken": self.broken,
                    "live": sum(1 for l in self._leases.values()
                                if not l.released
                                and self._clock() < l.expires_at)}
