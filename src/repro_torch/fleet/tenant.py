"""Tenants: one program + engine + SLO per customer, plus the update
log that makes worker crashes survivable.

The port of ``repro.fleet.tenant``.  A tenant owns everything the fleet
must never mix across customers: an
:class:`~repro_torch.core.runtime.IncrementalEngine` (guarded, wired to
the fleet's shared :class:`~repro_torch.plan.TriggerCache`), a
durable-ordered :class:`UpdateLog` of admitted updates, the **committed
view store** reads are served from, and a per-tenant
:class:`~repro_torch.guard.CircuitBreaker` for noisy-neighbor quarantine.

The split between ``engine.views`` (working state, written mid-claim)
and ``committed_views`` (a pointer snapshot advanced only at commit) is
what gives readers isolation.  The reference gets it from immutable jax
arrays; the port's engine writes views in place unless it is turned out
of place, so the port decides three things:

* **Every tenant engine writes out of place, guarded or not**
  (``engine._write_out_of_place()`` when the tenant builds it): no
  firing writes a tensor that existed before it.  A reader holding the
  committed dict then sees a consistent pre-claim store whatever a
  worker does to the engine, the in-flight snapshot (a dict copy) is
  the very pre-claim tensors a rollback restores, and the scheduler's
  commit test by identity means what it means in the reference.  The
  price: a row-local view is copied whole before each row apply (where
  the guard alone saves only the touched rows), and a written view
  exists twice while a firing runs.
* **Log entries keep no reference the caller can mutate.**  Raw factors
  are stored as float32 copies on the engine's device (a numpy factor
  is uploaded once, at append; a card tensor is copied on the card,
  never through the host), and carriers as carriers with copied arrays,
  so a crash replay re-fires the same representation through the same
  trigger.
* **The cold tier's fold** (:meth:`LogEntry.dense_delta`) is a plain
  ``torch`` product on the engine's device, as the reference's is a
  plain product outside any kernel: never a host product of the view's
  size.

Exactly-once accounting lives in three fields: ``applied_lsn`` (the
log prefix reflected in ``committed_views``), ``inflight`` (the claim
currently trying to advance it, with its pre-firing snapshot), and
``commit_log`` (the sequence of committed firing groups — the replay
script the bit-identical property test checks against).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.factored import (DeltaCarrier, LowRankCarrier, RowLocalCarrier,
                             to_f32)
from ..core.runtime import IncrementalEngine, resolve_device
from ..guard import CircuitBreaker, GuardConfig
from ..guard.txn import FiringSnapshot
from ..plan import TriggerCache


@dataclass
class TenantSpec:
    """Static per-tenant contract: program, SLO, quotas, containment."""

    tenant_id: str
    program: object                 # repro_torch.core.Program
    update_ranks: Optional[Dict[str, int]] = None
    slo_s: float = 1.0              # staleness SLO (dirty → refreshed)
    priority: float = 1.0           # scheduler weight (higher = sooner)
    sheddable: bool = True          # may the shedding tier drop it?
    quota_rate: float = float("inf")  # admitted updates/second
    quota_burst: int = 64
    queue_capacity: int = 256       # max pending (unapplied) log entries
    max_claim_rank: int = 64        # stacked rank one claim fires at most
    guarded: bool = True            # wrap the engine in repro_torch.guard
    chaos: Optional[object] = None  # ChaosConfig/ChaosMonkey for the engine
    breaker_threshold: int = 3      # aborted claims → quarantined
    breaker_reset_s: float = 5.0
    #: keywords for the tenant's engine; ``"device"`` places it (``None``,
    #: the default, means the card)
    engine_opts: Dict[str, object] = field(default_factory=dict)


@dataclass
class LogEntry:
    """One admitted update, totally ordered by per-tenant LSN.

    Either a raw ``(u, v)`` factor pair (float32 tensors on the tenant
    engine's device), or a :class:`~repro_torch.core.factored.
    DeltaCarrier` (``carrier`` set, ``u`` / ``v`` ``None``) — the log
    stores whichever form was submitted, so a crash replay re-fires the
    *same representation* the first attempt saw (a row-local carrier
    replays through the row-local trigger, not a widened dense sweep —
    bit-identity demands the same code path)."""

    lsn: int
    input_name: str
    u: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    submitted_at: float
    carrier: Optional[DeltaCarrier] = None

    @property
    def rank(self) -> int:
        """Stacked-rank contribution of this entry (claim capping)."""
        if self.carrier is not None:
            return max(1, int(self.carrier.rank))
        return self.u.shape[1] if self.u.dim() == 2 else 1

    def affected_fraction(self) -> float:
        return (self.carrier.affected_fraction()
                if self.carrier is not None else 1.0)

    def payload(self):
        """What the engine applies: the carrier, or the raw pair."""
        return self.carrier if self.carrier is not None else (self.u, self.v)

    def dense_delta(self, device=None) -> torch.Tensor:
        """``ΔA`` as a dense tensor (cold-tier reeval-on-read fold): a
        raw pair's product on its factors' device, a carrier's widened
        factors uploaded to ``device`` and multiplied there."""
        if self.carrier is not None:
            P, Q = (to_f32(x, device) for x in self.carrier.factors())
            return P @ Q.T
        return (self.u @ self.v.T if self.u.dim() == 2
                else torch.outer(self.u, self.v))


def _owned_carrier(carrier: DeltaCarrier) -> DeltaCarrier:
    """A carrier whose arrays the submitter no longer holds."""
    if carrier.kind == "row_local":
        return RowLocalCarrier(np.array(carrier.rows, copy=True),
                               np.array(carrier.block, np.float32),
                               np.array(carrier.V, np.float32), carrier.n)
    if carrier.kind == "low_rank":
        return LowRankCarrier(np.array(carrier.P, np.float32),
                              np.array(carrier.Q, np.float32))
    return carrier


class UpdateLog:
    """Append-only per-tenant update log (thread-safe).

    The log *is* the recovery story: a worker's uncommitted firing dies
    with its lease, and the reclaimer replays the same entries —
    ``pending(applied_lsn)`` — against the rolled-back store.  Entries
    are pruned only once a commit advances ``applied_lsn`` past them.
    Raw factors are kept as float32 copies on ``device`` (``None``: the
    card).
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._entries: List[LogEntry] = []
        self._next_lsn = 1
        self.appended = 0
        self.pruned = 0

    def append(self, input_name: str, u, v, now: float,
               carrier=None) -> LogEntry:
        # copy before taking the lock: an upload must not hold up readers
        if carrier is not None:
            carrier, u, v = _owned_carrier(carrier), None, None
        else:
            u = to_f32(u, self.device, copy=True)
            v = to_f32(v, self.device, copy=True)
        with self._lock:
            entry = LogEntry(self._next_lsn, input_name, u, v, now,
                             carrier=carrier)
            self._next_lsn += 1
            self._entries.append(entry)
            self.appended += 1
            return entry

    def _first_pending(self, applied_lsn: int) -> int:
        """Index of the first entry with ``lsn > applied_lsn`` (lock
        held).  LSNs are consecutive and prune only drops a prefix, so
        this is index arithmetic, not a scan — ``pending_count`` sits on
        every admission decision and fleet load() probe."""
        if not self._entries:
            return 0
        return min(len(self._entries),
                   max(0, applied_lsn - self._entries[0].lsn + 1))

    def pending(self, applied_lsn: int) -> List[LogEntry]:
        """Entries not yet reflected in the committed store, in LSN
        order."""
        with self._lock:
            return self._entries[self._first_pending(applied_lsn):]

    def pending_count(self, applied_lsn: int) -> int:
        with self._lock:
            return len(self._entries) - self._first_pending(applied_lsn)

    def last_lsn(self) -> int:
        with self._lock:
            return self._next_lsn - 1

    def oldest_pending_at(self, applied_lsn: int) -> Optional[float]:
        with self._lock:
            i = self._first_pending(applied_lsn)
            return self._entries[i].submitted_at \
                if i < len(self._entries) else None

    def prune(self, upto_lsn: int) -> int:
        """Drop entries with ``lsn <= upto_lsn`` (they are committed)."""
        with self._lock:
            keep = [e for e in self._entries if e.lsn > upto_lsn]
            n = len(self._entries) - len(keep)
            self._entries = keep
            self.pruned += n
            return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


@dataclass
class Inflight:
    """The claim currently mutating a tenant's engine: its fencing
    token, the log prefix it is trying to commit, and the pre-firing
    snapshot a reclaimer restores if the holder dies."""

    token: int
    target_lsn: int
    snapshot: FiringSnapshot


@dataclass
class TenantStats:
    submitted: int = 0
    decisions: Dict[str, int] = field(default_factory=dict)
    commits: int = 0
    committed_updates: int = 0
    replays: int = 0            # claims that rolled back a dead worker
    fenced_aborts: int = 0      # own commit rejected by fencing check
    aborted_claims: int = 0     # guard aborted every firing in a claim
    reads: int = 0
    dirty_reads: int = 0        # reads served while pending work existed
    reeval_on_read: int = 0     # cold-tier degraded refreshes
    noop_skips: int = 0         # no-op carriers acked without logging

    def count(self, decision: str) -> None:
        self.decisions[decision] = self.decisions.get(decision, 0) + 1


class Tenant:
    """Runtime state for one tenant (see module docstring)."""

    def __init__(self, spec: TenantSpec, trigger_cache: TriggerCache,
                 clock=time.monotonic):
        self.spec = spec
        self._clock = clock
        opts = dict(spec.engine_opts)
        opts.setdefault("guard", GuardConfig() if spec.guarded else None)
        opts.setdefault("chaos", spec.chaos)
        self.engine = IncrementalEngine(
            spec.program, spec.update_ranks,
            trigger_cache=trigger_cache, **opts)
        # readers, the in-flight snapshot and the commit test hold views
        # by reference: no firing may write a tensor that existed before it
        self.engine._write_out_of_place()
        self.log = UpdateLog(self.engine.device)
        self.applied_lsn = 0
        self.committed_views: Dict[str, object] = {}
        self.inflight: Optional[Inflight] = None
        self.breaker = CircuitBreaker(spec.breaker_threshold,
                                      spec.breaker_reset_s, clock=clock)
        self.mutex = threading.RLock()   # serializes engine access
        self.stats = TenantStats()
        self.mode = "incremental"        # or "reeval_on_read" (cold tier)
        self.last_read_at = clock()      # cold-tenant detection (overload)
        #: committed firing groups, in commit order:
        #: (input_name, (lsn, …)) per group — the replay script for the
        #: bit-identical N-isolated-engines property test
        self.commit_log: List[Tuple[str, Tuple[int, ...]]] = []

    def initialize(self, inputs: Dict[str, object]) -> None:
        with self.mutex:
            self.engine.initialize(inputs)
            self.committed_views = dict(self.engine.views)

    # -- dirtiness / staleness ----------------------------------------------
    def dirty(self) -> bool:
        return self.log.last_lsn() > self.applied_lsn

    def staleness(self) -> float:
        """Seconds the oldest unapplied update has been waiting (0.0
        when clean) — the quantity the SLO bounds."""
        oldest = self.log.oldest_pending_at(self.applied_lsn)
        return 0.0 if oldest is None else max(0.0, self._clock() - oldest)

    def slo_pressure(self) -> float:
        """staleness / SLO — ≥ 1.0 means the SLO is already violated."""
        return self.staleness() / max(self.spec.slo_s, 1e-9)

    # -- health --------------------------------------------------------------
    def health(self) -> Dict[str, object]:
        guard = self.engine.guard
        return {
            "tenant": self.spec.tenant_id,
            "mode": self.mode,
            "breaker": self.breaker.state,
            "dirty": self.dirty(),
            "pending": self.log.pending_count(self.applied_lsn),
            "applied_lsn": self.applied_lsn,
            "staleness_s": self.staleness(),
            "slo_s": self.spec.slo_s,
            "commits": self.stats.commits,
            "replays": self.stats.replays,
            "quarantined": (len(guard.quarantine) if guard is not None
                            else 0),
        }


class TenantRegistry:
    """All tenants of one fleet + the shared compiled-trigger cache.

    The cache is THE cross-tenant fast path: same-program tenants on
    one device key to identical (fingerprint, device, tail) entries, so
    the second tenant's trigger fns come back built.
    """

    def __init__(self, trigger_cache: Optional[TriggerCache] = None,
                 clock=time.monotonic):
        self.trigger_cache = (trigger_cache if trigger_cache is not None
                              else TriggerCache())
        self._clock = clock
        self._tenants: Dict[str, Tenant] = {}
        self._lock = threading.Lock()

    def register(self, spec: TenantSpec,
                 inputs: Dict[str, object]) -> Tenant:
        with self._lock:
            if spec.tenant_id in self._tenants:
                raise ValueError(f"tenant {spec.tenant_id!r} already "
                                 f"registered")
        tenant = Tenant(spec, self.trigger_cache, clock=self._clock)
        tenant.initialize(inputs)
        with self._lock:
            self._tenants[spec.tenant_id] = tenant
        return tenant

    def unregister(self, tenant_id: str) -> Optional[Tenant]:
        with self._lock:
            return self._tenants.pop(tenant_id, None)

    def get(self, tenant_id: str) -> Tenant:
        with self._lock:
            try:
                return self._tenants[tenant_id]
            except KeyError:
                raise KeyError(f"unknown tenant {tenant_id!r}; have "
                               f"{sorted(self._tenants)}") from None

    def __iter__(self):
        with self._lock:
            return iter(list(self._tenants.values()))

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    def ids(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)
