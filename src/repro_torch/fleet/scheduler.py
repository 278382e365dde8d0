"""The fleet scheduler: lease-claimed, SLO-prioritized, overload-aware.

The port of ``repro.fleet.scheduler``.  One :class:`FleetScheduler`
coordinates N tenants and M workers with no leader and no failure
detector — coordination is entirely the
:class:`~repro_torch.fleet.lease.LeaseStore` protocol:

    claim → (replay a dead claim's rollback) → snapshot → fire pending
    log entries → fencing check → commit | self-rollback

A worker that crashes mid-claim (chaos ``worker_crash_p``, or a real
exception) simply leaves its lease to expire; the reclaimer finds the
tenant's ``inflight`` record, restores the pre-firing snapshot
(bit-identical — every tenant engine writes out of place, so the
snapshot holds the very pre-claim tensors) and replays the same log
entries.  A worker that *loses* its lease mid-claim (TTL ran out,
chaos ``lease_expiry_p`` broke it) fails the commit-time fencing check
and rolls **itself** back.  Either way every log entry is reflected in
the committed store exactly once.

Scheduling order is SLO-aware: tenants are scored by
``priority × staleness-pressure / planner-estimated firing cost``
(:func:`repro_torch.plan.firing_cost_flops`), with SLO-overdue tenants
boosted above everything else — a cheap overdue tenant beats an
expensive fresh one.

Overload is handled in explicit tiers (:class:`OverloadPolicy`): past
``degraded_at`` utilization, cold sheddable tenants degrade to
re-eval-on-read (pending deltas fold straight into their inputs, one
re-evaluation on the next read — no trigger sweeps); past
``shedding_at``, admission refuses sheddable tenants' updates outright.
Reads always serve the last committed snapshot, so overload degrades
freshness, never correctness.  Every firing a worker makes goes through
the tenant engine's kernels; the fleet itself is host-side Python.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.factored import (DeltaCarrier, LowRankCarrier, RowLocalCarrier,
                             as_carrier)
from ..guard import as_monkey
from ..guard.txn import restore_snapshot, take_snapshot
from ..plan import firing_cost_flops

from .admission import ADMITTED, AdmissionController
from .lease import LeaseStore
from .tenant import Inflight, LogEntry, Tenant, TenantRegistry, TenantSpec


class WorkerCrashed(RuntimeError):
    """Chaos ``worker_crash_p`` fired: the worker dies mid-claim,
    leaving its lease and the tenant's inflight record for a reclaimer."""


@dataclass(frozen=True)
class OverloadPolicy:
    """When the fleet stops pretending it can keep everyone fresh.

    ``load`` is total pending log entries over total queue capacity.
    Crossing ``degraded_at`` degrades *cold* sheddable tenants (no read
    for ``cold_after_s``) to re-eval-on-read; crossing ``shedding_at``
    additionally sheds new sheddable traffic at admission.
    """

    degraded_at: float = 0.6
    shedding_at: float = 0.85
    cold_after_s: float = 5.0


@dataclass
class FleetConfig:
    lease_ttl: float = 1.0
    overload: OverloadPolicy = field(default_factory=OverloadPolicy)
    chaos: Optional[object] = None   # ChaosConfig/ChaosMonkey: worker faults
    workers: int = 4                 # threads for start()
    idle_sleep_s: float = 0.002      # thread-worker poll interval


class FleetScheduler:
    """Workers + leases + admission over a :class:`TenantRegistry`.

    Deterministic drive: :meth:`run_claim` / :meth:`run_until_idle`
    with an injectable ``clock``/``sleep`` (tests, chaos acceptance).
    Live drive: :meth:`start` / :meth:`stop` thread pool.
    """

    def __init__(self, config: Optional[FleetConfig] = None,
                 registry: Optional[TenantRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.config = config or FleetConfig()
        self._clock = clock
        self._sleep = sleep
        self.registry = registry or TenantRegistry(clock=clock)
        self.leases = LeaseStore(self.config.lease_ttl, clock=clock)
        self.admission = AdmissionController(clock=clock)
        self.chaos = as_monkey(self.config.chaos)
        # firing_cost_flops walks the trigger IR; priority calls it for
        # every claimable tenant on every claim, so memoize per
        # (tenant, input, rank, order-signature) — pure in the program
        # structure and the engine's resolved view depths
        self._cost_memo: Dict[Tuple[str, str, int, tuple, float],
                              float] = {}
        self._any_degraded = False  # lets _apply_tier skip the scan
        # aggregate pending/capacity, maintained at append/prune time —
        # load() sits on every submit, so it must not scan the registry
        self._load_lock = threading.Lock()
        self._pending_total = 0
        self._cap_total = 0
        self.worker_crashes = 0
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    # -- tenant lifecycle ----------------------------------------------------
    def add_tenant(self, spec: TenantSpec, inputs: Dict[str, object]
                   ) -> Tenant:
        tenant = self.registry.register(spec, inputs)
        self.admission.register(spec)
        with self._load_lock:
            self._cap_total += spec.queue_capacity
        return tenant

    def remove_tenant(self, tenant_id: str) -> None:
        tenant = self.registry.get(tenant_id)
        with self._load_lock:
            self._cap_total -= tenant.spec.queue_capacity
            self._pending_total -= tenant.log.pending_count(
                tenant.applied_lsn)
        self.admission.unregister(tenant_id)
        self.registry.unregister(tenant_id)

    # -- ingress -------------------------------------------------------------
    def submit(self, tenant_id: str, input_name: str, u, v=None) -> str:
        """Admit one update ``input ± u vᵀ`` into a tenant's log.

        ``u`` may be a :class:`~repro_torch.core.factored.DeltaCarrier`
        (``v`` omitted): the log stores the carrier as-is, so a
        row-local update replays through the row-local trigger, a crash
        replay included, and a **no-op carrier is acknowledged without
        ever entering the log** — nothing to fire, prune, or replay,
        and it can never trip the overload tiers.

        Chaos poisoning happens HERE, before the log append, so the log
        stores the poisoned values and a crash-replay re-fires exactly
        what the first attempt saw.  Returns the admission decision
        (``"admitted"``/``"throttled"``/``"queue_full"``/``"shed"``).
        """
        carrier = None
        if isinstance(u, DeltaCarrier) or v is None:
            carrier = as_carrier(u, v)
        tenant = self.registry.get(tenant_id)
        if input_name not in tenant.engine.compiled.triggers:
            raise KeyError(
                f"no trigger for input {input_name!r} in tenant "
                f"{tenant_id!r}; have "
                f"{sorted(tenant.engine.compiled.triggers)}")
        tenant.stats.submitted += 1
        if carrier is not None and carrier.kind == "noop":
            # nothing will ever move: ack before admission — a no-op
            # consumes no queue slot, so throttling/shedding it is
            # meaningless (and a storm of them must not degrade anyone)
            tenant.stats.noop_skips += 1
            tenant.stats.count(ADMITTED)
            return ADMITTED
        if self.chaos is not None:
            if carrier is None:
                u, v = self.chaos.poison_update(u, v)
            elif carrier.kind == "row_local":
                Bp, Vp = self.chaos.poison_update(carrier.block, carrier.V)
                carrier = RowLocalCarrier(carrier.rows,
                                          np.asarray(Bp, np.float32),
                                          np.asarray(Vp, np.float32),
                                          carrier.n)
            else:
                Pp, Qp = self.chaos.poison_update(*carrier.factors())
                carrier = LowRankCarrier(np.asarray(Pp, np.float32),
                                         np.asarray(Qp, np.float32))
        tier = self.tier()
        decision = self.admission.admit(tenant, tier)
        tenant.stats.count(decision)
        if decision == ADMITTED:
            tenant.log.append(input_name, u, v, self._clock(),
                              carrier=carrier)
            with self._load_lock:
                self._pending_total += 1
            tier = self.tier()  # the append may have tipped it
        self._apply_tier(tier)
        return decision

    # -- egress --------------------------------------------------------------
    def read(self, tenant_id: str, name: Optional[str] = None):
        """Serve one view from the tenant's committed snapshot.

        Never touches mid-claim engine state (reads are isolated from
        workers); a degraded (re-eval-on-read) tenant gets its pending
        deltas folded in first, under the same lease protocol workers
        use."""
        tenant = self.registry.get(tenant_id)
        tenant.last_read_at = self._clock()
        tenant.stats.reads += 1
        if tenant.mode == "reeval_on_read" and tenant.dirty():
            self._claim_and_fire(tenant, "reader", reeval=True)
        if tenant.dirty():
            tenant.stats.dirty_reads += 1
        name = name or tenant.engine.program.output_names()[0]
        return tenant.committed_views[name]

    def read_views(self, tenant_id: str) -> Dict[str, object]:
        tenant = self.registry.get(tenant_id)
        tenant.last_read_at = self._clock()
        return dict(tenant.committed_views)

    # -- overload tiers ------------------------------------------------------
    def load(self) -> float:
        with self._load_lock:
            return (self._pending_total / self._cap_total
                    if self._cap_total else 0.0)

    def tier(self) -> str:
        load = self.load()
        pol = self.config.overload
        if load >= pol.shedding_at:
            return "shedding"
        if load >= pol.degraded_at:
            return "degraded"
        return "normal"

    def _apply_tier(self, tier: Optional[str] = None) -> None:
        """Move cold sheddable tenants to re-eval-on-read under
        pressure; restore everyone once the fleet cools down."""
        if tier is None:
            tier = self.tier()
        if tier == "normal" and not self._any_degraded:
            return  # hot path: nothing to demote, nothing to restore
        now = self._clock()
        any_degraded = False
        for t in self.registry:
            if tier == "normal":
                t.mode = "incremental"
            elif (t.spec.sheddable
                    and now - t.last_read_at
                    >= self.config.overload.cold_after_s):
                t.mode = "reeval_on_read"
            any_degraded = any_degraded or t.mode != "incremental"
        self._any_degraded = any_degraded

    # -- SLO-aware priority ---------------------------------------------------
    def _pending_ranks(self, tenant: Tenant
                       ) -> Dict[str, Tuple[int, float]]:
        """Per pending input: (stacked rank, affected fraction).  The
        fraction is the summed row containment of the pending carriers
        clamped at 1.0 — a queue of row-local updates prices at the
        row-slab sweep, and one dense entry drops the whole input back
        to full price (dense entries report fraction 1.0)."""
        acc: Dict[str, Tuple[int, float]] = {}
        for e in tenant.log.pending(tenant.applied_lsn):
            k, f = acc.get(e.input_name, (0, 0.0))
            acc[e.input_name] = (k + e.rank,
                                 min(1.0, f + e.affected_fraction()))
        return acc

    def priority(self, tenant: Tenant) -> float:
        """``spec.priority × SLO-pressure / firing cost`` — cheap overdue
        work first.  Overdue tenants (pressure ≥ 1) are boosted above
        every on-time tenant regardless of cost.  Higher-order tenants
        (deferred-cascade views) are priced at their amortized fold
        share, not a full per-firing sweep — otherwise depth-k tenants
        would look exactly ``fold_window**(k-1)``× more expensive than
        they are and starve behind first-order neighbors."""
        pressure = tenant.slo_pressure()
        cost = 1.0
        eng = tenant.engine
        orders = {n: o
                  for n, o in (getattr(eng, "_view_orders", None) or
                               {}).items() if o > 1} or None
        order_sig = (tuple(sorted(orders.items())) if orders else ())
        for input_name, (rank, frac) in self._pending_ranks(tenant).items():
            rank = min(rank, tenant.spec.max_claim_rank)
            # quantize the fraction so the memo stays finite; dense
            # pending work (frac == 1.0) prices with fraction=None —
            # identical to the pre-carrier key, so the memo carries over
            fq = round(min(1.0, max(frac, 1e-4)), 4)
            frac_arg = None if fq >= 1.0 else fq
            key = (tenant.spec.tenant_id, input_name, rank, order_sig,
                   fq)
            c = self._cost_memo.get(key)
            if c is None:
                c = firing_cost_flops(eng.compiled, eng.binding,
                                      input_name, rank,
                                      view_orders=orders,
                                      affected_fraction=frac_arg)
                self._cost_memo[key] = c
            cost += c
        score = tenant.spec.priority * max(pressure, 1e-6) / cost
        if pressure >= 1.0:
            score += tenant.spec.priority * 1e9
        return score

    def _claimable(self) -> List[Tenant]:
        out = [t for t in self.registry
               if t.dirty() and t.mode == "incremental"
               and t.breaker.state != "open"]
        out.sort(key=self.priority, reverse=True)
        return out

    # -- the claim protocol ---------------------------------------------------
    def run_claim(self, worker_id: str) -> str:
        """One worker, one claim cycle.  Returns what happened:
        ``"idle"`` (nothing claimable), ``"committed"``,
        ``"quarantined"`` (all firings guard-aborted; log still
        advanced, breaker fed), or ``"fenced"`` (lost the lease,
        rolled own work back).  Raises :class:`WorkerCrashed` when
        chaos kills the worker mid-claim — the lease and the tenant's
        inflight record are deliberately left behind."""
        for tenant in self._claimable():
            if (tenant.breaker.state == "half_open"
                    and not tenant.breaker.allow()):
                continue  # someone else holds the probe
            lease = self.leases.claim(tenant.spec.tenant_id, worker_id)
            if lease is None:
                continue  # raced another worker; try the next tenant
            return self._fire_claim(tenant, lease)
        return "idle"

    def _claim_and_fire(self, tenant: Tenant, worker_id: str,
                        reeval: bool = False) -> str:
        lease = self.leases.claim(tenant.spec.tenant_id, worker_id)
        if lease is None:
            return "idle"
        return self._fire_claim(tenant, lease, reeval=reeval)

    def _claim_entries(self, tenant: Tenant
                       ) -> Tuple[List[Tuple[str, List[LogEntry]]], int]:
        """Pending entries for one claim, grouped into consecutive
        same-input runs (log order is preserved — firings on different
        inputs do not commute through nonlinear views), capped at
        ``max_claim_rank`` total stacked rank."""
        groups: List[Tuple[str, List[LogEntry]]] = []
        total = 0
        target = tenant.applied_lsn
        for e in tenant.log.pending(tenant.applied_lsn):
            k = e.rank
            if total and total + k > tenant.spec.max_claim_rank:
                break
            if groups and groups[-1][0] == e.input_name:
                groups[-1][1].append(e)
            else:
                groups.append((e.input_name, [e]))
            total += k
            target = e.lsn
        return groups, target

    def _fire_claim(self, tenant: Tenant, lease, reeval: bool = False
                    ) -> str:
        with tenant.mutex:
            if self.chaos is not None:
                delay = self.chaos.slow_worker_delay()
                if delay > 0.0:
                    self._sleep(delay)  # real TTLs expire under this
            engine = tenant.engine
            # a dead worker's uncommitted claim? roll it back first —
            # the restore is bit-identical (the very pre-claim tensors:
            # the engine writes out of place), then we replay the same
            # log entries it saw
            if (tenant.inflight is not None
                    and tenant.inflight.token != lease.token):
                restore_snapshot(engine, tenant.inflight.snapshot)
                tenant.inflight = None
                tenant.stats.replays += 1
            if reeval:
                groups, target = [], tenant.log.last_lsn()
                entries = tenant.log.pending(tenant.applied_lsn)
            else:
                groups, target = self._claim_entries(tenant)
                entries = []
            if target <= tenant.applied_lsn:
                self.leases.release(lease)
                return "idle"
            snap = take_snapshot(engine)
            tenant.inflight = Inflight(lease.token, target, snap)
            guard = engine.guard
            aborted_before = (guard.stats.aborted_firings
                              if guard is not None else 0)
            committed_groups: List[Tuple[str, Tuple[int, ...]]] = []
            if reeval:
                # cold-tier path: fold the raw deltas into the inputs,
                # re-evaluate once — no trigger sweeps
                for e in entries:
                    engine.views[e.input_name] = (
                        engine.views[e.input_name]
                        + e.dense_delta(engine.device))
                engine.reevaluate()
                tenant.stats.reeval_on_read += 1
                committed_groups.append(
                    ("<reeval>", tuple(e.lsn for e in entries)))
            else:
                for input_name, group in groups:
                    before = dict(engine.views)
                    engine.apply_updates(
                        input_name, [e.payload() for e in group])
                    if self.chaos is not None \
                            and self.chaos.should_crash_worker():
                        self.worker_crashes += 1
                        raise WorkerCrashed(
                            f"chaos killed worker mid-claim on "
                            f"{tenant.spec.tenant_id!r}")
                    if any(before.get(k) is not val
                           for k, val in engine.views.items()):
                        committed_groups.append(
                            (input_name, tuple(e.lsn for e in group)))
            if guard is not None:
                guard.sync()   # settle deferred fast-path accounting
            if self.chaos is not None and self.chaos.should_expire_lease():
                self.leases.break_lease(tenant.spec.tenant_id)
            # -- commit point --------------------------------------------------
            if not self.leases.is_current(lease):
                # fenced: someone may already be replaying — undo our
                # work (bit-identical) and walk away
                restore_snapshot(engine, snap)
                tenant.inflight = None
                tenant.stats.fenced_aborts += 1
                return "fenced"
            n_updates = (len(entries) if reeval
                         else sum(len(g) for _, g in groups))
            tenant.applied_lsn = target
            pruned = tenant.log.prune(target)
            with self._load_lock:
                self._pending_total -= pruned
            tenant.committed_views = dict(engine.views)
            tenant.commit_log.extend(committed_groups)
            tenant.inflight = None
            tenant.stats.commits += 1
            tenant.stats.committed_updates += n_updates
            self.leases.release(lease)
            aborted = ((guard.stats.aborted_firings - aborted_before)
                       if guard is not None else 0)
            if aborted and not committed_groups:
                # every firing in the claim was aborted+quarantined —
                # this tenant is hurting workers for zero progress
                tenant.breaker.record_failure()
                tenant.stats.aborted_claims += 1
                return "quarantined"
            tenant.breaker.record_success()
            return "committed"

    # -- deterministic drive ---------------------------------------------------
    def run_until_idle(self, workers: int = 2, max_passes: int = 10_000,
                       on_stall: Optional[Callable[[], None]] = None
                       ) -> Dict[str, int]:
        """Round-robin ``workers`` virtual workers until no tenant is
        claimably dirty.  Worker crashes are absorbed (the "worker" is
        reincarnated next pass).  ``on_stall`` runs when a full pass
        makes no progress — with a virtual clock, advance it past the
        lease TTL there; with the real clock the default waits it out.
        """
        outcomes: Dict[str, int] = {}
        for _ in range(max_passes):
            self._apply_tier()
            if not self._claimable():
                # clean, degraded-to-read, or breaker-quarantined
                # tenants only — nothing a worker may touch right now
                return outcomes
            progress = False
            for w in range(workers):
                try:
                    res = self.run_claim(f"w{w}")
                except WorkerCrashed:
                    res = "crashed"
                outcomes[res] = outcomes.get(res, 0) + 1
                if res not in ("idle",):
                    progress = True
            if not progress:
                if on_stall is not None:
                    on_stall()
                else:
                    self._sleep(self.config.lease_ttl / 4)
        raise RuntimeError(
            f"run_until_idle made no headway in {max_passes} passes; "
            f"outcomes so far: {outcomes}")

    def drain(self, tenant_ids=None, timeout_s: float = 60.0) -> None:
        """Block until the given tenants (default: all) are clean.

        With live worker threads running, waits on them; otherwise
        drives claims inline.  Degraded (re-eval-on-read) tenants are
        folded directly.  Raises ``TimeoutError`` if live workers make
        no headway in ``timeout_s``."""
        ids = (list(tenant_ids) if tenant_ids is not None
               else self.registry.ids())
        tenants = [self.registry.get(t) for t in ids]
        for t in tenants:
            if t.mode == "reeval_on_read" and t.dirty():
                self._claim_and_fire(t, "drain", reeval=True)
        if not self._threads:
            self.run_until_idle()
            return
        t0 = self._clock()
        while any(t.dirty() and t.mode == "incremental" for t in tenants):
            if self._clock() - t0 > timeout_s:
                raise TimeoutError(
                    f"fleet drain of {ids} stalled after {timeout_s}s; "
                    f"health: {[t.health() for t in tenants]}")
            self._sleep(self.config.idle_sleep_s)

    # -- live drive ------------------------------------------------------------
    def start(self, workers: Optional[int] = None) -> None:
        """Spawn the worker threads (idempotent while running)."""
        if self._threads:
            return
        self._stop.clear()
        for i in range(workers or self.config.workers):
            t = threading.Thread(target=self._worker_loop,
                                 args=(f"worker-{i}",),
                                 name=f"fleet-worker-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30.0)
        self._threads = []

    def _worker_loop(self, worker_id: str) -> None:
        incarnation = 0
        while not self._stop.is_set():
            try:
                res = self.run_claim(f"{worker_id}.{incarnation}")
            except WorkerCrashed:
                incarnation += 1   # the old worker is gone; a new one
                continue           # (fresh id) picks up the pieces
            except Exception:
                incarnation += 1   # never let one tenant kill the pool
                continue
            if res == "idle":
                self._sleep(self.config.idle_sleep_s)
            self._apply_tier()

    # -- introspection ---------------------------------------------------------
    def tenant_health(self) -> List[Dict[str, object]]:
        return [t.health() for t in self.registry]

    def fleet_stats(self) -> Dict[str, object]:
        tenants = list(self.registry)
        stats: Dict[str, object] = {
            "tenants": len(tenants),
            "tier": self.tier(),
            "load": self.load(),
            "leases": self.leases.stats(),
            "trigger_cache": self.registry.trigger_cache.stats(),
            "worker_crashes": self.worker_crashes,
            "commits": sum(t.stats.commits for t in tenants),
            "committed_updates": sum(t.stats.committed_updates
                                     for t in tenants),
            "replays": sum(t.stats.replays for t in tenants),
            "fenced_aborts": sum(t.stats.fenced_aborts for t in tenants),
            "decisions": {},
        }
        decisions: Dict[str, int] = stats["decisions"]
        for t in tenants:
            for k, n in t.stats.decisions.items():
                decisions[k] = decisions.get(k, 0) + n
        if self.chaos is not None:
            stats["chaos"] = {
                "poisoned": self.chaos.poisoned,
                "lease_expiries": self.chaos.lease_expiries,
                "slowdowns": self.chaos.slowdowns,
            }
        return stats
