"""The port's fleet (``repro_torch.fleet``) against the JAX package's.

Mirrors ``tests/test_fleet.py`` case for case on the port's engine (on the
CPU): leases and fencing, admission, exactly-once commit under worker
crashes and lease expiry, the N-tenants-bit-identical-to-N-isolated-
engines property, the 500-firing chaos acceptance run, overload tiers,
noisy-neighbour quarantine, the live thread mode, ``attach_fleet``, and
the trigger cache under threads.  Then the two packages side by side:
the same numpy inputs, virtual clock and chaos seed give the same
decisions, commit logs, outcomes and tenant stats, and committed views
within f32 parity.  On top, the port's own decisions are held: an
unguarded tenant's reader keeps its pre-claim values while a claim is
mid-flight (every tenant engine writes out of place), log entries own
their factors, and kernels load once and count launches exactly under
threads.

The chaos tests run under REPRO_CHAOS_SEEDS (comma-separated; default
"0"), as the reference's do.
"""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.factored as jfactored
import repro.fleet as jfleet
import repro.guard as jguard
from repro.apps.ols import build_ols_program as jax_ols
from repro.serve.incremental_views import \
    build_logit_view_program as jax_logit
import repro_torch.core as tcore
import repro_torch.core.factored as tfactored
import repro_torch.fleet as tfleet
import repro_torch.guard as tguard
from repro_torch.apps.ols import build_ols_program
from repro_torch.core import IncrementalEngine, compile_program, max_abs_diff
from repro_torch.fleet import (ADMITTED, QUEUE_FULL, SHED, THROTTLED,
                               FleetConfig, FleetScheduler, LeaseStore,
                               OverloadPolicy, TenantSpec, TokenBucket,
                               WorkerCrashed)
from repro_torch.guard import (ChaosConfig, CircuitBreaker, DegradePolicy,
                               GuardConfig, retry_with_backoff)
from repro_torch.kernels import cuda_build
from repro_torch.kernels import rank_update as cuda_ru
from repro_torch.plan import (TriggerCache, WorkloadDescriptor,
                              firing_cost_flops, plan_program,
                              trigger_chain_costs)
from repro_torch.serve import build_logit_view_program

CHAOS_SEEDS = [int(s) for s in
               os.environ.get("REPRO_CHAOS_SEEDS", "0").split(",")]

CPU = {"device": "cpu"}
# committed views of the two packages, as max |a - b| over the view's
# largest entry (the port's engine tests' tolerance)
TOL = 1e-5


class VClock:
    """Deterministic virtual time for lease/breaker/backoff tests."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt

    def sleep(self, dt: float) -> None:
        self.t += dt


def _spec(*args, **kw):
    """A port TenantSpec whose engine runs on the CPU."""
    kw["engine_opts"] = {**CPU, **kw.get("engine_opts", {})}
    return TenantSpec(*args, **kw)


def _ols_tenant(m=24, n=6, p=1, seed=0):
    rng = np.random.default_rng(seed)
    prog = build_ols_program(m, n, p)
    inputs = {"X": rng.standard_normal((m, n)).astype(np.float32),
              "Y": rng.standard_normal((m, p)).astype(np.float32)}
    return prog, inputs


def _logit_tenant(m=8, d=4, p=5, seed=0):
    rng = np.random.default_rng(seed)
    prog = build_logit_view_program(m, d, p)
    inputs = {"H": rng.standard_normal((m, d)).astype(np.float32),
              "W": (rng.standard_normal((p, d)) * 0.1).astype(np.float32)}
    return prog, inputs


def _rank1(rng, n, m, scale=0.1):
    return ((rng.standard_normal((n, 1)) * scale).astype(np.float32),
            (rng.standard_normal((m, 1)) * scale).astype(np.float32))


def _replay_reference(tenant, inputs, updates_by_lsn):
    """An isolated out-of-place engine fed the tenant's committed firing
    groups in commit order — the fleet's committed store must match it
    bit-identically (same guard config, same grouping, same values)."""
    ref = IncrementalEngine(tenant.spec.program, tenant.spec.update_ranks,
                            guard=GuardConfig() if tenant.spec.guarded
                            else None, **tenant.spec.engine_opts)
    ref._write_out_of_place()
    ref.initialize(inputs)
    for input_name, lsns in tenant.commit_log:
        assert input_name != "<reeval>", "property test must not degrade"
        ref.apply_updates(input_name,
                          [updates_by_lsn[l] for l in lsns])
    return ref


# ---------------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------------

def test_lease_claim_renew_release():
    vc = VClock()
    store = LeaseStore(ttl=1.0, clock=vc)
    lease = store.claim("t1", "w1")
    assert lease is not None and lease.token == 1
    # live lease blocks everyone, including the holder (not reentrant)
    assert store.claim("t1", "w2") is None
    assert store.claim("t1", "w1") is None
    vc.advance(0.6)
    assert store.renew(lease)          # extended to t=1.6
    vc.advance(0.8)
    assert store.is_current(lease)     # t=1.4 < 1.6
    assert store.release(lease)
    assert not store.is_current(lease)
    lease2 = store.claim("t1", "w2")   # freed: next claim wins token 2
    assert lease2 is not None and lease2.token == 2
    assert store.stats()["reclaims"] == 0


def test_lease_expiry_reclaim_and_fencing():
    vc = VClock()
    store = LeaseStore(ttl=1.0, clock=vc)
    stale = store.claim("t1", "w1")
    vc.advance(1.5)                    # w1 dies; TTL runs out
    assert store.expired() and store.expired()[0] is stale
    fresh = store.claim("t1", "w2")    # reclaim
    assert fresh is not None and fresh.token == 2
    assert store.stats()["reclaims"] == 1
    # the zombie is fenced out of every path
    assert not store.is_current(stale)
    assert not store.renew(stale)
    assert not store.release(stale)
    assert store.stats()["fence_rejections"] == 2
    assert store.is_current(fresh)     # the reclaimer is unaffected


def test_lease_break_is_indistinguishable_from_expiry():
    vc = VClock()
    store = LeaseStore(ttl=10.0, clock=vc)
    lease = store.claim("t1", "w1")
    assert store.break_lease("t1")     # chaos lease_expiry_p path
    assert not store.is_current(lease)
    assert store.holder("t1") is None
    assert store.claim("t1", "w2") is not None
    assert store.stats()["broken"] == 1


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def test_token_bucket_refill():
    vc = VClock()
    b = TokenBucket(rate=2.0, burst=4, clock=vc)
    assert all(b.allow() for _ in range(4))   # full burst
    assert not b.allow()                      # empty
    vc.advance(1.0)                           # +2 tokens
    assert b.allow() and b.allow() and not b.allow()
    vc.advance(100.0)
    assert b.available() == 4                 # capped at burst


def test_admission_throttle_queue_full_and_shed():
    vc = VClock()
    fleet = FleetScheduler(FleetConfig(lease_ttl=1.0), clock=vc,
                           sleep=vc.sleep)
    prog, inputs = _logit_tenant()
    # sheddable=False so the full queue exposes QUEUE_FULL back-pressure
    # instead of tripping the shedding tier first (covered elsewhere)
    fleet.add_tenant(_spec("t1", prog, {"W": 1}, quota_rate=1.0,
                           quota_burst=2, queue_capacity=3,
                           sheddable=False), inputs)
    rng = np.random.default_rng(0)
    ups = [_rank1(rng, 5, 4) for _ in range(4)]
    assert fleet.submit("t1", "W", *ups[0]) == ADMITTED
    assert fleet.submit("t1", "W", *ups[1]) == ADMITTED
    assert fleet.submit("t1", "W", *ups[2]) == THROTTLED   # bucket empty
    vc.advance(2.0)                                        # refill 2
    assert fleet.submit("t1", "W", *ups[2]) == ADMITTED
    assert fleet.submit("t1", "W", *ups[3]) == QUEUE_FULL  # log at cap 3
    t = fleet.registry.get("t1")
    assert t.stats.decisions == {ADMITTED: 3, THROTTLED: 1, QUEUE_FULL: 1}
    with pytest.raises(KeyError):
        fleet.submit("t1", "nope", *ups[0])


# ---------------------------------------------------------------------------
# the claim/commit protocol
# ---------------------------------------------------------------------------

def test_commit_is_bit_identical_to_isolated_engine():
    vc = VClock()
    fleet = FleetScheduler(FleetConfig(lease_ttl=1.0), clock=vc,
                           sleep=vc.sleep)
    prog, inputs = _ols_tenant()
    tenant = fleet.add_tenant(_spec("acme", prog, {"X": 1}), inputs)
    rng = np.random.default_rng(1)
    by_lsn = {}
    for i in range(7):
        u, v = _rank1(rng, 24, 6)
        assert fleet.submit("acme", "X", u, v) == ADMITTED
        by_lsn[i + 1] = (u, v)
    fleet.run_until_idle(workers=2, on_stall=lambda: vc.advance(1.1))
    assert not tenant.dirty()
    assert tenant.stats.committed_updates == 7
    ref = _replay_reference(tenant, inputs, by_lsn)
    assert max_abs_diff(tenant.committed_views, ref.views) == 0.0


def test_worker_crash_replay_exactly_once():
    vc = VClock()
    # crash every claim until we disarm the monkey
    fleet = FleetScheduler(
        FleetConfig(lease_ttl=1.0,
                    chaos=ChaosConfig(seed=0, worker_crash_p=1.0)),
        clock=vc, sleep=vc.sleep)
    prog, inputs = _logit_tenant()
    tenant = fleet.add_tenant(_spec("t1", prog, {"W": 1}), inputs)
    rng = np.random.default_rng(2)
    by_lsn = {}
    for i in range(5):
        u, v = _rank1(rng, 5, 4)
        fleet.submit("t1", "W", u, v)
        by_lsn[i + 1] = (u, v)
    committed_before = dict(tenant.committed_views)
    with pytest.raises(WorkerCrashed):
        fleet.run_claim("w1")
    # the dead claim left its lease and uncommitted engine state behind
    assert tenant.inflight is not None
    assert fleet.leases.holder("t1") is not None
    assert tenant.applied_lsn == 0
    # committed reads never saw any of it
    assert max_abs_diff(tenant.committed_views, committed_before) == 0.0
    # TTL not yet expired: nobody can reclaim
    assert fleet.run_claim("w2") == "idle"
    vc.advance(1.5)
    fleet.chaos = None                 # second incarnation is healthy
    pre_claim = tenant.inflight.snapshot.views
    assert fleet.run_claim("w2") == "committed"
    assert tenant.stats.replays == 1   # rolled the dead claim back
    assert fleet.leases.stats()["reclaims"] == 1
    assert tenant.stats.committed_updates == 5   # exactly once
    assert not tenant.dirty()
    ref = _replay_reference(tenant, inputs, by_lsn)
    assert max_abs_diff(tenant.committed_views, ref.views) == 0.0
    # the replay started from the very pre-claim tensors: the inputs the
    # replayed firing did not write are still those objects
    assert tenant.committed_views["H"] is pre_claim["H"]


def test_lease_expiry_fences_commit_and_rolls_back():
    vc = VClock()
    fleet = FleetScheduler(
        FleetConfig(lease_ttl=1.0,
                    chaos=ChaosConfig(seed=0, lease_expiry_p=1.0)),
        clock=vc, sleep=vc.sleep)
    prog, inputs = _logit_tenant()
    tenant = fleet.add_tenant(_spec("t1", prog, {"W": 1}), inputs)
    rng = np.random.default_rng(3)
    u, v = _rank1(rng, 5, 4)
    fleet.submit("t1", "W", u, v)
    before = dict(tenant.engine.views)
    assert fleet.run_claim("w1") == "fenced"
    # fenced claims roll their own work back: nothing applied,
    # nothing committed, log intact for the next worker
    assert tenant.stats.fenced_aborts == 1
    assert tenant.applied_lsn == 0 and tenant.dirty()
    assert tenant.inflight is None
    # the rollback is the very pre-claim tensors, not a copy of them
    assert all(tenant.engine.views[k] is t for k, t in before.items())
    fleet.chaos = None
    assert fleet.run_claim("w2") == "committed"
    assert tenant.stats.committed_updates == 1   # exactly once
    ref = _replay_reference(tenant, inputs, {1: (u, v)})
    assert max_abs_diff(tenant.committed_views, ref.views) == 0.0


def test_max_claim_rank_bounds_one_claim():
    vc = VClock()
    fleet = FleetScheduler(FleetConfig(lease_ttl=1.0), clock=vc,
                           sleep=vc.sleep)
    prog, inputs = _logit_tenant()
    tenant = fleet.add_tenant(
        _spec("t1", prog, {"W": 1}, max_claim_rank=3), inputs)
    rng = np.random.default_rng(4)
    for _ in range(8):
        fleet.submit("t1", "W", *_rank1(rng, 5, 4))
    assert fleet.run_claim("w1") == "committed"
    assert tenant.applied_lsn == 3          # capped claim
    assert tenant.stats.committed_updates == 3
    fleet.run_until_idle(on_stall=lambda: vc.advance(1.1))
    assert tenant.applied_lsn == 8 and not tenant.dirty()


# ---------------------------------------------------------------------------
# the bit-identical N-tenant property + chaos acceptance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_fleet_property_bit_identical_to_isolated_engines(seed):
    """N tenants under interleaved updates, worker crashes, and lease
    expiries produce committed stores bit-identical to N isolated
    single-tenant engines replaying each tenant's committed groups —
    which is simultaneously the exactly-once proof and the
    no-cross-tenant-contamination proof."""
    vc = VClock()
    fleet = FleetScheduler(
        FleetConfig(lease_ttl=1.0,
                    chaos=ChaosConfig(seed=seed, worker_crash_p=0.2,
                                      lease_expiry_p=0.2)),
        clock=vc, sleep=vc.sleep)
    specs = {}
    tenant_inputs = {}
    # two same-program tenants (they share built triggers) + one
    # distinct-shape tenant
    for i, (m, d, p) in enumerate([(8, 4, 5), (8, 4, 5), (6, 3, 4)]):
        tid = f"t{i}"
        prog, inputs = _logit_tenant(m, d, p, seed=i)
        specs[tid] = (prog, (p, d))
        tenant_inputs[tid] = inputs
        # small claims → many claims → many chaos draws per run
        fleet.add_tenant(_spec(tid, prog, {"W": 1}, max_claim_rank=4),
                         inputs)
    rng = np.random.default_rng(seed + 100)
    by_lsn = {tid: {} for tid in specs}
    lsn = {tid: 0 for tid in specs}
    outcomes = {}
    for step in range(60):
        tid = f"t{rng.integers(3)}"
        p, d = specs[tid][1]
        u, v = _rank1(rng, p, d)
        assert fleet.submit(tid, "W", u, v) == ADMITTED
        lsn[tid] += 1
        by_lsn[tid][lsn[tid]] = (u, v)
        if step % 10 == 9:             # interleave refresh with ingest
            for k, n in fleet.run_until_idle(
                    workers=3,
                    on_stall=lambda: vc.advance(1.1)).items():
                outcomes[k] = outcomes.get(k, 0) + n
    for k, n in fleet.run_until_idle(workers=3,
                                     on_stall=lambda: vc.advance(1.1)
                                     ).items():
        outcomes[k] = outcomes.get(k, 0) + n
    total_committed = 0
    for tid, (prog, _) in specs.items():
        tenant = fleet.registry.get(tid)
        assert not tenant.dirty()
        assert tenant.stats.committed_updates == lsn[tid]  # exactly once
        ref = _replay_reference(tenant, tenant_inputs[tid], by_lsn[tid])
        assert max_abs_diff(tenant.committed_views, ref.views) == 0.0
        total_committed += tenant.stats.committed_updates
    assert total_committed == 60
    # chaos actually happened on every seed at these probabilities
    assert fleet.chaos.worker_crashes + fleet.chaos.lease_expiries > 0
    assert outcomes.get("committed", 0) > 0
    # same-program tenants shared built triggers
    assert fleet.registry.trigger_cache.stats()["hits"] > 0


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_fleet_chaos_acceptance_500_firings(seed):
    """The acceptance run: ~500 submissions across a mixed fleet under
    worker crashes, lease expiry, slow workers, poisoned updates, and
    queue-pressure overload.  Invariants: exactly-once commit accounting
    per tenant, no cross-tenant contamination (bit-identical per-tenant
    replay), and final committed views consistent with full
    re-evaluation from the tenant's own inputs."""
    vc = VClock()
    fleet = FleetScheduler(
        FleetConfig(lease_ttl=1.0,
                    overload=OverloadPolicy(degraded_at=0.7,
                                            shedding_at=0.9,
                                            cold_after_s=1e9),
                    chaos=ChaosConfig(seed=seed, worker_crash_p=0.1,
                                      lease_expiry_p=0.1,
                                      slow_worker_p=0.05,
                                      slow_worker_s=1.5,   # > lease TTL
                                      poison_p=0.02)),
        clock=vc, sleep=vc.sleep)
    shapes = {}
    tenant_inputs = {}
    # 3 linear logit-view tenants (two share a program) + 2 OLS tenants
    for i, (m, d, p) in enumerate([(8, 4, 5), (8, 4, 5), (6, 3, 4)]):
        tid = f"logit{i}"
        prog, inputs = _logit_tenant(m, d, p, seed=i)
        fleet.add_tenant(_spec(tid, prog, {"W": 1}, slo_s=0.5,
                               queue_capacity=64), inputs)
        shapes[tid] = ("W", (p, d))
        tenant_inputs[tid] = inputs
    for i, (m, n) in enumerate([(24, 6), (16, 4)]):
        tid = f"ols{i}"
        prog, inputs = _ols_tenant(m, n, 1, seed=10 + i)
        fleet.add_tenant(_spec(tid, prog, {"X": 1}, slo_s=0.5,
                               queue_capacity=64), inputs)
        shapes[tid] = ("X", (m, n))
        tenant_inputs[tid] = inputs
    tids = sorted(shapes)
    rng = np.random.default_rng(seed + 7)
    by_lsn = {tid: {} for tid in tids}
    admitted = {tid: 0 for tid in tids}
    for step in range(500):
        tid = tids[int(rng.integers(len(tids)))]
        input_name, (n, m) = shapes[tid]
        u, v = _rank1(rng, n, m, scale=0.05)
        decision = fleet.submit(tid, input_name, u, v)
        if decision == ADMITTED:
            admitted[tid] += 1
            # the LOG's values are what count (post-poisoning), so
            # read the entry back for the replay reference
            entry = fleet.registry.get(tid).log.pending(0)[-1]
            by_lsn[tid][entry.lsn] = (entry.u, entry.v)
        vc.advance(0.01)
        if step % 25 == 24:            # interleave refresh with ingest
            fleet.run_until_idle(workers=3,
                                 on_stall=lambda: vc.advance(1.1))
    fleet.run_until_idle(workers=3, on_stall=lambda: vc.advance(1.1))
    assert sum(admitted.values()) > 400   # queue pressure, not collapse
    for tid in tids:
        tenant = fleet.registry.get(tid)
        assert not tenant.dirty()
        # exactly-once: every admitted update is committed exactly once
        assert tenant.stats.committed_updates == admitted[tid], tid
        assert tenant.applied_lsn == admitted[tid]
        # no contamination: bit-identical to this tenant's own replay
        ref = _replay_reference(tenant, tenant_inputs[tid], by_lsn[tid])
        assert max_abs_diff(tenant.committed_views, ref.views) == 0.0, tid
        # consistency: committed views match re-evaluation from the
        # tenant's own (updated) inputs.  Linear views are tight;
        # OLS goes through an f32 inverse (repo-standard tolerance).
        fresh = IncrementalEngine(tenant.spec.program, device="cpu")
        fresh.initialize({k: tenant.committed_views[k]
                          for k in tenant.spec.program.inputs})
        for name in fresh.program.outputs:
            got = tenant.committed_views[name].numpy()
            want = fresh.views[name].numpy()
            tol = 1e-6 if tid.startswith("logit") else 2e-3
            np.testing.assert_allclose(got, want, rtol=tol,
                                       atol=tol * np.abs(want).max())
    # the fault mix actually fired
    assert fleet.chaos.worker_crashes > 0
    assert fleet.chaos.poisoned > 0
    stats = fleet.fleet_stats()
    assert stats["replays"] + stats["fenced_aborts"] > 0
    assert stats["trigger_cache"]["hits"] > 0


# ---------------------------------------------------------------------------
# overload tiers + degradation
# ---------------------------------------------------------------------------

def test_overload_tiers_shed_and_reeval_on_read():
    vc = VClock()
    fleet = FleetScheduler(
        FleetConfig(lease_ttl=1.0,
                    overload=OverloadPolicy(degraded_at=0.5,
                                            shedding_at=0.75,
                                            cold_after_s=2.0)),
        clock=vc, sleep=vc.sleep)
    prog0, inputs0 = _logit_tenant(seed=0)
    prog1, inputs1 = _logit_tenant(seed=1)
    fleet.add_tenant(_spec("cold", prog0, {"W": 1}, queue_capacity=4),
                     inputs0)
    fleet.add_tenant(_spec("vip", prog1, {"W": 1}, queue_capacity=4,
                           sheddable=False), inputs1)
    rng = np.random.default_rng(5)
    ups = [_rank1(rng, 5, 4) for _ in range(8)]
    assert fleet.tier() == "normal"
    vc.advance(3.0)                     # both tenants go cold
    for i in range(3):                  # load 3/8 → normal; 4/8 → degraded
        fleet.submit("cold", "W", *ups[i])
    assert fleet.tier() == "normal"
    fleet.submit("cold", "W", *ups[3])
    assert fleet.tier() == "degraded"
    cold = fleet.registry.get("cold")
    vip = fleet.registry.get("vip")
    assert cold.mode == "reeval_on_read"   # cold + sheddable → degraded
    assert vip.mode == "incremental"       # reserved capacity is spared
    for i in range(2):
        fleet.submit("vip", "W", *ups[4 + i])
    assert fleet.tier() == "shedding"      # 6/8
    assert fleet.submit("cold", "W", *ups[6]) == SHED
    assert fleet.submit("vip", "W", *ups[7]) == ADMITTED  # not sheddable
    # a degraded tenant is not scheduled; its pending deltas fold in on
    # the READ, via the same lease/commit protocol
    assert all(t.spec.tenant_id != "cold" for t in fleet._claimable())
    y = fleet.read("cold", "Y").numpy()
    assert cold.stats.reeval_on_read == 1
    assert not cold.dirty()
    W = np.asarray(inputs0["W"])
    for i in range(4):
        u, v = ups[i]
        W = W + u @ v.T
    np.testing.assert_allclose(y, inputs0["H"] @ W.T, rtol=1e-5, atol=1e-5)
    # drain the vip tenant; fleet cools down and modes recover
    fleet.run_until_idle(on_stall=lambda: vc.advance(1.1))
    fleet.submit("cold", "W", *ups[7])     # any submit re-applies tiers
    assert fleet.tier() == "normal"
    assert cold.mode == "incremental"


def test_noisy_neighbor_quarantine_and_probe():
    vc = VClock()
    fleet = FleetScheduler(FleetConfig(lease_ttl=1.0), clock=vc,
                           sleep=vc.sleep)
    prog_bad, inputs_bad = _logit_tenant(seed=0)
    prog_ok, inputs_ok = _logit_tenant(seed=1)
    # every firing of the bad tenant's engine raises (injected fault);
    # the guard aborts + quarantines, the fleet's breaker opens
    fleet.add_tenant(
        _spec("bad", prog_bad, {"W": 1},
              chaos=ChaosConfig(seed=0, trigger_raise_p=1.0),
              breaker_threshold=2, breaker_reset_s=10.0),
        inputs_bad)
    tenant_ok = fleet.add_tenant(_spec("ok", prog_ok, {"W": 1}), inputs_ok)
    bad = fleet.registry.get("bad")
    last_good = dict(bad.committed_views)
    rng = np.random.default_rng(6)
    for _ in range(2):
        fleet.submit("bad", "W", *_rank1(rng, 5, 4))
        fleet.submit("ok", "W", *_rank1(rng, 5, 4))
        out = fleet.run_until_idle(on_stall=lambda: vc.advance(1.1))
        assert out.get("quarantined", 0) >= 1
    # two all-aborted claims → breaker open → tenant unschedulable
    assert bad.breaker.state == "open"
    assert bad.stats.aborted_claims == 2
    assert len(bad.engine.guard.quarantine) > 0
    fleet.submit("bad", "W", *_rank1(rng, 5, 4))
    assert fleet.run_claim("w1") == "idle"     # quarantined, skipped
    # reads still serve the last-good committed snapshot
    assert max_abs_diff({"Y": fleet.read("bad", "Y")},
                        {"Y": last_good["Y"]}) == 0.0
    assert fleet.read("bad", "Y") is last_good["Y"]
    # the healthy tenant was never affected
    assert tenant_ok.stats.commits == 2 and not tenant_ok.dirty()
    # after the reset window, ONE probe claim is admitted (half-open)
    vc.advance(11.0)
    assert bad.breaker.state == "half_open"
    assert fleet.run_claim("w1") == "quarantined"   # probe fails again
    assert bad.breaker.state == "open"


def test_thread_mode_smoke():
    """Live worker threads (real clock): submit, drain, verify."""
    fleet = FleetScheduler(FleetConfig(lease_ttl=10.0, workers=2))
    prog, inputs = _logit_tenant()
    tenant = fleet.add_tenant(_spec("t1", prog, {"W": 1}), inputs)
    rng = np.random.default_rng(7)
    by_lsn = {}
    fleet.start()
    try:
        for i in range(12):
            u, v = _rank1(rng, 5, 4)
            assert fleet.submit("t1", "W", u, v) == ADMITTED
            by_lsn[i + 1] = (u, v)
        fleet.drain(["t1"], timeout_s=60.0)
    finally:
        fleet.stop()
    assert not any(t.is_alive() for t in threading.enumerate()
                   if t.name.startswith("fleet-worker"))
    assert not tenant.dirty()
    assert tenant.stats.committed_updates == 12
    ref = _replay_reference(tenant, inputs, by_lsn)
    assert max_abs_diff(tenant.committed_views, ref.views) == 0.0


def test_serve_engine_attach_fleet():
    """ServeEngine routes hot-swap deltas / reads / health through a
    fleet-backed logit view."""
    from repro_torch.launch.serve import EXAMPLES
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine

    cfg = EXAMPLES["custom-10m"]
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, batch_size=1, max_seq=32)
    rng = np.random.default_rng(8)
    m, d, p = 6, cfg.d_model, 16
    prog = build_logit_view_program(m, d, p)
    inputs = {"H": rng.standard_normal((m, d)).astype(np.float32),
              "W": (rng.standard_normal((p, d)) * 0.1).astype(np.float32)}
    fleet = FleetScheduler(FleetConfig(lease_ttl=2.0))
    fleet.add_tenant(_spec("acme", prog, {"W": 1}), inputs)
    eng.attach_fleet(fleet, {"lm_head": "acme"})
    u, v = _rank1(rng, p, d, scale=0.01)
    # tensors go to the fleet as they are
    assert eng.hot_swap("lm_head", torch.from_numpy(u), torch.from_numpy(v))
    eng.flush_views()                          # drains the fleet inline
    y = eng.view_logits("lm_head").numpy()
    W = np.asarray(inputs["W"]) + u @ v.T
    np.testing.assert_allclose(y, inputs["H"] @ W.T, rtol=1e-5, atol=1e-5)
    health = eng.view_health()["lm_head"]
    assert health["tenant"] == "acme" and not health["dirty"]
    with pytest.raises(ValueError):
        eng.attach_fleet(fleet, {"layers.0.mlp": "acme"})
    with pytest.raises(KeyError):
        eng.attach_fleet(fleet, {"lm_head.1": "nobody"})


def test_serve_cli_fleet_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", "custom-10m", "--device", "cpu", "--fleet",
                    "2", "--fleet-workers", "2", "--batch", "1",
                    "--prompt-len", "4", "--max-new", "2", "--corpus", "8"])
    out = capsys.readouterr().out
    for i in range(2):
        assert f"fleet view lm_head.{i}: (8, 8192)" in out
    assert "'committed_updates': 16" in out and "generated (1, 2)" in out


# ---------------------------------------------------------------------------
# satellite: thread-safe TriggerCache
# ---------------------------------------------------------------------------

def test_trigger_cache_concurrent_access():
    cache = TriggerCache(capacity=8)
    built = []
    build_lock = threading.Lock()

    def builder(key):
        def make():
            with build_lock:
                built.append(key)
            return ("fn", key)
        return make

    errors = []
    results = {}

    def worker(wid):
        rng = np.random.default_rng(wid)
        try:
            for _ in range(200):
                key = ("k", int(rng.integers(16)))
                fn = cache.get_or_build(key, builder(key))
                assert fn[1] == key            # never someone else's fn
                _ = len(cache), key in cache, cache.stats()
                results[(wid, key)] = fn
        except Exception as e:                 # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    stats = cache.stats()
    assert stats["hits"] + stats["misses"] == 8 * 200
    assert stats["entries"] <= 8               # capacity respected
    assert stats["evictions"] >= stats["misses"] - 8


def test_trigger_cache_lru_eviction_and_evict():
    cache = TriggerCache(capacity=2)
    cache.get_or_build(("a",), lambda: "A")
    cache.get_or_build(("b",), lambda: "B")
    assert cache.get_or_build(("a",), lambda: "A2") == "A"   # hit, MRU
    cache.get_or_build(("c",), lambda: "C")    # evicts LRU = ("b",)
    assert ("b",) not in cache and ("a",) in cache
    assert cache.stats()["evictions"] == 1
    assert cache.evict(("a",)) and not cache.evict(("a",))
    assert len(cache) == 1
    cache.clear()
    assert len(cache) == 0 and cache.stats() == {
        "entries": 0, "hits": 0, "misses": 0, "evictions": 0}
    with pytest.raises(ValueError):
        TriggerCache(capacity=0)


# ---------------------------------------------------------------------------
# satellite: chain-aware planner pricing (the fleet's cost term)
# ---------------------------------------------------------------------------

def test_chain_aware_pricing_demotes_lone_survivors():
    """When siblings re-evaluate, a lone incremental view bears the
    whole shared delta chain — chain-aware pricing must lower its
    effective crossover (never raise it)."""
    prog = build_ols_program(96, 12, 2)
    compiled = compile_program(prog, {"X": 1})
    base = plan_program(compiled, WorkloadDescriptor(update_rank=1,
                                                     batch_size=8))
    aware = plan_program(compiled, WorkloadDescriptor(update_rank=1,
                                                      batch_size=8,
                                                      chain_aware=True))
    order = {"reeval": 0, "hybrid": 1, "incremental": 2}
    demoted = 0
    for name, vp in aware.views.items():
        bp = base.views[name]
        assert order[vp.strategy] <= order[bp.strategy], name
        if vp.strategy != bp.strategy:
            demoted += 1
        if vp.strategy == "hybrid" and bp.strategy == "hybrid":
            assert vp.threshold_rank <= bp.threshold_rank
    assert demoted >= 1        # the chain price moved at least one view

    # a chain-aware plan still executes correctly
    rng = np.random.default_rng(9)
    inputs = {"X": rng.standard_normal((96, 12)).astype(np.float32),
              "Y": rng.standard_normal((96, 2)).astype(np.float32)}
    eng = IncrementalEngine(prog, {"X": 1}, plan=aware,
                            trigger_cache=TriggerCache(), device="cpu")
    ref = IncrementalEngine(prog, {"X": 1}, device="cpu")
    eng.initialize(inputs)
    ref.initialize(inputs)
    ups = [_rank1(rng, 96, 12, scale=0.05) for _ in range(4)]
    eng.apply_updates("X", ups)
    ref.apply_updates("X", ups)
    eng.refresh()
    for name in prog.outputs:
        np.testing.assert_allclose(eng.views[name].numpy(),
                                   ref.views[name].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_firing_cost_flops_prices_the_chain():
    prog = build_ols_program(96, 12, 2)
    compiled = compile_program(prog, {"X": 1})
    binding = dict(prog.dims)
    assign_flops, view_deps = trigger_chain_costs(
        compiled.triggers["X"], binding)
    assert all(c > 0 for c in assign_flops.values())
    c1 = firing_cost_flops(compiled, binding, "X", 1)
    c8 = firing_cost_flops(compiled, binding, "X", 8)
    assert c8 > c1 > 0                       # monotone in stacked rank
    # re-evaluating a view swaps its sweep for its reeval cost and can
    # only drop chain assigns, never add them
    views = [up.view for up in compiled.triggers["X"].updates
             if up.view in {s.target.name for s in prog.statements}]
    c_re = firing_cost_flops(compiled, binding, "X", 8,
                             reeval_views=frozenset(views[:1]))
    assert c_re != c8 and c_re > 0


# ---------------------------------------------------------------------------
# satellite: deterministic degrade (clock + jitter + single probe)
# ---------------------------------------------------------------------------

def test_retry_with_backoff_injectable_clock_and_deadline():
    vc = VClock()
    sleeps = []

    def sleep(dt):
        sleeps.append(dt)
        vc.advance(dt)

    calls = []

    def always_fails():
        calls.append(vc())
        raise RuntimeError("down")

    policy = DegradePolicy(max_retries=50, backoff_base=0.5,
                           backoff_max=8.0, retry_deadline=3.0,
                           full_jitter=False, jitter=0.0)
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError):
        retry_with_backoff(always_fails, policy, rng, sleep=sleep,
                           clock=vc)
    # deadline bounded the loop long before 50 retries
    assert len(calls) < 10
    assert vc() <= 3.0 + 8.0               # never sleeps past the budget


def test_retry_full_jitter_decorrelates():
    vc = VClock()
    sleeps = []

    def sleep(dt):
        sleeps.append(dt)
        vc.advance(dt)

    def fails():
        raise RuntimeError("down")

    policy = DegradePolicy(max_retries=6, backoff_base=1.0,
                           backoff_max=4.0, full_jitter=True)
    with pytest.raises(RuntimeError):
        retry_with_backoff(fails, policy, np.random.default_rng(1),
                           sleep=sleep, clock=vc)
    assert len(sleeps) == 6                # one pause per retry
    caps = [min(1.0 * 2 ** i, 4.0) for i in range(len(sleeps))]
    assert all(0.0 <= s <= c for s, c in zip(sleeps, caps))
    assert len({round(s / c, 6) for s, c in zip(sleeps, caps)}) > 1


def test_breaker_half_open_single_probe():
    vc = VClock()
    br = CircuitBreaker(threshold=2, reset_timeout=5.0, clock=vc)
    assert br.allow()
    br.record_failure()
    br.record_failure()
    assert br.state == "open" and not br.allow()
    vc.advance(5.0)
    assert br.state == "half_open"
    assert br.allow()                      # the single probe
    assert not br.allow()                  # concurrent caller: wait
    br.record_failure()                    # probe failed → open again
    assert br.state == "open"
    vc.advance(5.0)
    assert br.allow()
    br.record_success()                    # probe succeeded → closed
    assert br.state == "closed" and br.allow()


def test_breaker_abandoned_probe_rearms():
    vc = VClock()
    br = CircuitBreaker(threshold=1, reset_timeout=2.0, clock=vc)
    br.record_failure()
    vc.advance(2.0)
    assert br.allow()                      # probe claimed …
    assert not br.allow()                  # … and in flight
    vc.advance(2.0)                        # prober crashed; window re-arms
    assert br.allow()


# ---------------------------------------------------------------------------
# the port's decisions: out-of-place tenants, owned log entries
# ---------------------------------------------------------------------------

def _chain_prog(core, n=64, m=32, k=16):
    p = core.Program(name="chain")
    X = p.input("X", (core.dim("N"), core.dim("M")))
    W1 = p.input("W1", (core.dim("M"), core.dim("K")))
    W2 = p.input("W2", (core.dim("K"), core.dim("K")))
    Y1 = p.let("Y1", core.matmul(X, W1))
    p.let("Y2", core.matmul(Y1, W2))
    p.outputs = ["Y1", "Y2"]
    return p.bind_dims(N=n, M=m, K=k)


def _chain_inputs(seed, n=64, m=32, k=16):
    rng = np.random.default_rng(seed)
    return {"X": rng.standard_normal((n, m)).astype(np.float32),
            "W1": rng.standard_normal((m, k)).astype(np.float32) / m ** .5,
            "W2": rng.standard_normal((k, k)).astype(np.float32) / k ** .5}


def _row_carrier(factored, rng, n=64, m=32, rows=4, rank=2, scale=0.1):
    """A row-local carrier of one package on ``rows`` sorted rows."""
    idx = np.sort(rng.choice(n, rows, replace=False)).astype(np.int32)
    block = (rng.standard_normal((rows, rank)) * scale).astype(np.float32)
    V = (rng.standard_normal((m, rank)) * scale).astype(np.float32)
    return factored.RowLocalCarrier(idx, block, V, n)


@pytest.mark.parametrize("kind", ["dense", "rowlocal"])
def test_unguarded_reader_keeps_pre_claim_values_mid_flight(kind):
    """An unguarded tenant writes out of place all the same: while a
    claim is mid-flight (fired, not committed: the worker crashed), the
    reader's committed tensors keep their pre-claim values bit for bit,
    and the reclaimer's rollback restores the very pre-claim tensors."""
    vc = VClock()
    fleet = FleetScheduler(
        FleetConfig(lease_ttl=1.0,
                    chaos=ChaosConfig(seed=0, worker_crash_p=1.0)),
        clock=vc, sleep=vc.sleep)
    rng = np.random.default_rng(10)
    if kind == "dense":
        prog, inputs = _logit_tenant()
        name, ranks = "W", {"W": 1}
        ups = [_rank1(rng, 5, 4) for _ in range(3)]
    else:
        prog, inputs = _chain_prog(tcore), _chain_inputs(0)
        name, ranks = "X", {"X": 2}
        ups = [_row_carrier(tfactored, rng) for _ in range(3)]
    tenant = fleet.add_tenant(_spec("t", prog, ranks, guarded=False),
                              inputs)
    assert tenant.engine.guard is None and tenant.engine._out_of_place
    held = dict(tenant.committed_views)     # what a reader holds
    values = {k: t.clone() for k, t in held.items()}
    for up in ups:
        fleet.submit("t", name, *(up if kind == "dense" else (up,)))
    with pytest.raises(WorkerCrashed):
        fleet.run_claim("w1")
    moved = [k for k in held if not torch.equal(tenant.engine.views[k],
                                                values[k])]
    assert moved, "the crashed claim fired nothing"
    for k, t in held.items():                # the reader saw none of it
        assert torch.equal(t, values[k]), k
        assert fleet.read_views("t")[k] is t
    if kind == "rowlocal":
        assert tenant.engine.stats.rowlocal_firings == 1
    vc.advance(1.5)
    fleet.chaos = None
    pre = dict(tenant.inflight.snapshot.views)
    rolled = {}
    restore = tenant.engine.apply_updates

    def spy(*args, **kw):                     # the replay's starting store
        rolled.update(tenant.engine.views)
        return restore(*args, **kw)
    tenant.engine.apply_updates = spy
    assert fleet.run_claim("w2") == "committed"
    assert all(rolled[k] is pre[k] for k in pre)
    assert all(pre[k] is held[k] for k in held)
    assert tenant.stats.replays == 1 and tenant.stats.committed_updates == 3
    by_lsn = {i + 1: up for i, up in enumerate(ups)}
    if kind == "rowlocal":
        ref = IncrementalEngine(prog, ranks, device="cpu")
        ref._write_out_of_place()
        ref.initialize(inputs)
        for _, lsns in tenant.commit_log:
            ref.apply_updates(name, [by_lsn[l] for l in lsns])
    else:
        ref = _replay_reference(tenant, inputs, by_lsn)
    assert max_abs_diff(tenant.committed_views, ref.views) == 0.0


def test_guarded_rowlocal_rollback_keeps_the_pre_firing_tensors():
    """A guarded row-local firing that aborts on an out-of-place engine
    hands back the very pre-firing tensors (not its restored copies), so
    the fleet's commit test by identity sees no change."""
    eng = IncrementalEngine(_chain_prog(tcore), {"X": 2},
                            guard=GuardConfig(), device="cpu")
    eng._write_out_of_place()
    eng.initialize(_chain_inputs(1))
    rng = np.random.default_rng(11)
    good = _row_carrier(tfactored, rng)
    eng.apply_update("X", good)
    before = dict(eng.views)
    bad = _row_carrier(tfactored, rng, scale=1.0)
    bad.block[:] = 1e38                      # overflows every touched row
    bad.V[:] = 10.0
    eng.apply_update("X", bad)
    assert eng.guard.stats.rollbacks == 1
    assert all(eng.views[k] is t for k, t in before.items())


def test_log_entries_own_their_factors_on_the_engine_device():
    """Raw factors are logged as float32 copies on the engine's device and
    carriers with copied arrays: a submitter that reuses its buffers
    changes nothing the fleet fires."""
    vc = VClock()
    fleet = FleetScheduler(FleetConfig(lease_ttl=1.0), clock=vc,
                           sleep=vc.sleep)
    prog, inputs = _logit_tenant()
    tenant = fleet.add_tenant(_spec("t", prog, {"W": 1}), inputs)
    rng = np.random.default_rng(12)
    u, v = _rank1(rng, 5, 4)
    ut, vt = (torch.from_numpy(x) for x in _rank1(rng, 5, 4))
    c = _row_carrier(tfactored, rng, n=5, m=4, rows=2, rank=1)
    P, Q = c.factors()
    W = inputs["W"] + u @ v.T + ut.numpy() @ vt.numpy().T + P @ Q.T
    for args in ((u, v), (ut, vt), (c,)):
        assert fleet.submit("t", "W", *args) == ADMITTED
    e1, e2, e3 = tenant.log.pending(0)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               and x.dtype == torch.float32 for x in (e1.u, e1.v, e2.u))
    assert e2.u.data_ptr() != ut.data_ptr()
    assert e3.carrier is not c and e3.carrier.kind == "row_local"
    u[:] = np.nan                            # the submitter reuses buffers
    ut.fill_(float("nan"))
    c.block[:] = np.nan
    fleet.run_until_idle(on_stall=lambda: vc.advance(1.1))
    assert tenant.stats.committed_updates == 3
    np.testing.assert_allclose(fleet.read("t", "Y").numpy(),
                               inputs["H"] @ W.T, rtol=1e-5, atol=1e-5)


def test_tenant_engines_run_on_the_card_unless_asked():
    prog, inputs = _logit_tenant()
    spec = TenantSpec("t", prog, {"W": 1})
    fleet = FleetScheduler(FleetConfig())
    if torch.cuda.is_available():
        tenant = fleet.add_tenant(spec, inputs)
        assert tenant.engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            fleet.add_tenant(spec, inputs)


# ---------------------------------------------------------------------------
# satellite: thread-safe kernel loading and launch counters
# ---------------------------------------------------------------------------

class _FakeLib:
    def __getattr__(self, name):
        fn = type("_Fn", (), {})()
        setattr(self, name, fn)
        return fn


def test_library_builds_and_loads_once_under_threads(monkeypatch):
    builds, loads = [], []
    gate = threading.Barrier(8)

    def build_all(names=None):
        builds.append(list(names))
        threading.Event().wait(0.05)     # a slow nvcc widens the race
        return {n: 0.0 for n in names}

    def cdll(path):
        loads.append(path)
        return _FakeLib()

    monkeypatch.setattr(cuda_build, "build_all", build_all)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(cuda_build, "LIBS", {})
    got, errors = [], []

    def worker():
        try:
            gate.wait(timeout=30)
            got.append(cuda_build.library(
                "select_commit", {"select_commit_f32": [cuda_build.PTR]}))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert builds == [["select_commit"]] and len(loads) == 1
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert got[0].select_commit_f32.restype is cuda_build.I32


def test_launch_counts_are_exact_under_threads(monkeypatch):
    monkeypatch.setattr(cuda_ru, "LAUNCHES", dict.fromkeys(cuda_ru.LAUNCHES,
                                                            0))
    monkeypatch.setattr(cuda_ru, "RANKS", {k: type(v)() for k, v in
                                            cuda_ru.RANKS.items()})
    per, n = 2000, 8

    def worker():
        for i in range(per):
            cuda_build.count_launch(cuda_ru.LAUNCHES, "rank_update_batched",
                                    cuda_ru.RANKS, 1 + i % 4)

    threads = [threading.Thread(target=worker) for _ in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert cuda_ru.LAUNCHES["rank_update_batched"] == per * n
    assert dict(cuda_ru.RANKS["rank_update_batched"]) == {
        k: per * n // 4 for k in (1, 2, 3, 4)}


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------

def _both(seed, scenario):
    """Drive one scenario through ``repro.fleet`` and ``repro_torch.fleet``
    on the same numpy inputs, virtual clock schedule and chaos seed;
    returns, per package, (fleet, decisions, outcomes, inputs by tenant,
    logged updates by tenant and LSN)."""
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            fl, gd, fac, core = jfleet, jguard, jfactored, jcore
            logit, ols, spec_of = jax_logit, jax_ols, jfleet.TenantSpec
        else:
            fl, gd, fac, core = tfleet, tguard, tfactored, tcore
            logit, ols, spec_of = build_logit_view_program, \
                build_ols_program, _spec
        vc = VClock()
        overload = (fl.OverloadPolicy(degraded_at=0.5, shedding_at=0.75,
                                      cold_after_s=2.0)
                    if scenario == "overload" else
                    fl.OverloadPolicy(degraded_at=0.7, shedding_at=0.9,
                                      cold_after_s=1e9))
        chaos = None if scenario == "overload" else gd.ChaosConfig(
            seed=seed, worker_crash_p=0.1, lease_expiry_p=0.1,
            slow_worker_p=0.05, slow_worker_s=1.5, poison_p=0.03)
        fleet = fl.FleetScheduler(
            fl.FleetConfig(lease_ttl=1.0, overload=overload, chaos=chaos),
            clock=vc, sleep=vc.sleep)
        shapes, inputs_of = {}, {}
        capacity = 8 if scenario == "overload" else 16

        def add(tid, prog, inputs, name, nm, rank=1, **kw):
            fleet.add_tenant(spec_of(tid, prog, {name: rank}, slo_s=0.5,
                                     queue_capacity=capacity, **kw),
                             inputs)
            shapes[tid], inputs_of[tid] = (name, nm), inputs

        for i, (m, d, p) in enumerate([(8, 4, 5), (8, 4, 5), (6, 3, 4)]):
            _, inputs = _logit_tenant(m, d, p, seed=i)
            kw = {}
            if scenario == "noisy" and i == 2:
                kw.update(chaos=gd.ChaosConfig(seed=seed,
                                               trigger_raise_p=0.5),
                          breaker_threshold=2, breaker_reset_s=2.0)
            if scenario == "overload" and i == 0:
                kw["sheddable"] = False
            add(f"logit{i}", logit(m, d, p), inputs, "W", (p, d),
                max_claim_rank=4, **kw)
        if scenario == "chaos":
            _, inputs = _ols_tenant(24, 6, 1, seed=10)
            add("ols0", ols(24, 6, 1), inputs, "X", (24, 6))
        if scenario == "carriers":
            add("chain", _chain_prog(core), _chain_inputs(seed), "X",
                (64, 32), rank=2, max_claim_rank=6)
        tids = sorted(shapes)
        rng = np.random.default_rng(seed + 31)
        decisions, outcomes = [], []
        logged = {tid: {} for tid in tids}
        for step in range(160):
            tid = tids[int(rng.integers(len(tids)))]
            name, (n, m) = shapes[tid]
            if tid == "chain":
                args = (_row_carrier(fac, rng),)
            else:
                args = _rank1(rng, n, m, scale=0.05)
            decisions.append(fleet.submit(tid, name, *args))
            if decisions[-1] == ADMITTED:
                entry = fleet.registry.get(tid).log.pending(0)[-1]
                logged[tid][entry.lsn] = entry.payload()
            vc.advance(0.01 if scenario != "overload" else 0.05)
            if step % 20 == 19:
                for t in tids:             # a degraded tenant folds on read
                    if fleet.registry.get(t).mode == "reeval_on_read":
                        fleet.read(t)
                outcomes.append(fleet.run_until_idle(
                    workers=3, on_stall=lambda: vc.advance(1.1)))
                if scenario == "overload":
                    fleet.read("logit1")   # a warm reader stays incremental
        for tid in tids:
            if fleet.registry.get(tid).mode == "reeval_on_read":
                fleet.read(tid)
        vc.advance(10.0)                   # half-open every breaker
        outcomes.append(fleet.run_until_idle(
            workers=3, on_stall=lambda: vc.advance(1.1)))
        out[pkg] = (fleet, decisions, outcomes, inputs_of, logged)
    return out


def _views_np(views):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in views.items()}


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
@pytest.mark.parametrize("scenario", ["chaos", "noisy", "overload",
                                      "carriers"])
def test_fleet_matches_jax_fleet(scenario, seed):
    """One fleet scenario through both packages: identical admission
    decisions, ``run_until_idle`` outcomes, commit logs, tenant stats,
    lease and chaos counters; committed views within f32 parity; and the
    port's own isolated replay of each tenant bit-identical."""
    runs = _both(seed, scenario)
    jf, jdec, jout, _, _ = runs["jax"]
    tf, tdec, tout, inputs_of, logged = runs["torch"]
    assert tdec == jdec
    assert tout == jout
    js, ts = jf.fleet_stats(), tf.fleet_stats()
    for s in (js, ts):
        s.pop("trigger_cache")
    assert ts == js
    for tid in jf.registry.ids():
        jt, tt = jf.registry.get(tid), tf.registry.get(tid)
        assert tt.commit_log == jt.commit_log, tid
        assert dataclasses.asdict(tt.stats) == dataclasses.asdict(jt.stats)
        assert (tt.applied_lsn, tt.mode, tt.breaker.state) == \
            (jt.applied_lsn, jt.mode, jt.breaker.state)
        jv, tv = _views_np(jt.committed_views), _views_np(tt.committed_views)
        for k in jv:
            scale = np.abs(jv[k]).max() or 1.0
            assert np.abs(tv[k].astype(np.float64) - jv[k]).max() / scale \
                <= TOL, (tid, k)
        # the port's own isolated replay, bit for bit (an engine with its
        # own chaos draws, or one folded on read, has no such replay)
        if tt.spec.chaos is None and tt.stats.reeval_on_read == 0:
            ref = _replay_reference(tt, inputs_of[tid], logged[tid])
            assert max_abs_diff(tt.committed_views, ref.views) == 0.0, tid
    if scenario == "overload":
        assert SHED in tdec
        assert any(t.stats.reeval_on_read for t in tf.registry)
    elif scenario == "noisy":
        assert any(t.stats.aborted_claims for t in tf.registry)
    else:
        assert tf.chaos.worker_crashes + tf.chaos.lease_expiries > 0
    if scenario == "carriers":
        eng = tf.registry.get("chain").engine
        assert eng.stats.rowlocal_firings > 0 and eng.stats.row_applies > 0


# ---------------------------------------------------------------------------
# higher-order (deferred-cascade) tenants under fleet chaos
# ---------------------------------------------------------------------------


def _ho_fleet(pkg, seed):
    """The reference's higher-order fleet scenario through one package:
    two order-2 matrix-powers tenants, a first-order control and two
    logit tenants, 150 submissions under worker crashes, lease expiry
    and poison.  Returns (fleet, decisions, logged updates by tenant and
    LSN, admitted counts, inputs by tenant)."""
    if pkg == "jax":
        from repro.apps.matrix_powers import build_powers_program
        fl, gd, spec_of, logit = jfleet, jguard, jfleet.TenantSpec, jax_logit
    else:
        from repro_torch.apps.matrix_powers import build_powers_program
        fl, gd, spec_of, logit = tfleet, tguard, _spec, \
            build_logit_view_program
    vc = VClock()
    fleet = fl.FleetScheduler(
        fl.FleetConfig(lease_ttl=1.0,
                       chaos=gd.ChaosConfig(seed=seed, worker_crash_p=0.15,
                                            lease_expiry_p=0.1,
                                            poison_p=0.02)),
        clock=vc, sleep=vc.sleep)
    shapes, tenant_inputs = {}, {}
    rng0 = np.random.default_rng(99)
    for i in range(3):   # two deferred tenants + one first-order control
        tid = f"pow{i}"
        a = rng0.standard_normal((10, 10)).astype(np.float32)
        a *= 0.5 / max(abs(np.linalg.eigvals(a)))
        opts = {"order": 2, "fold_window": 2} if i < 2 else {}
        fleet.add_tenant(spec_of(tid, build_powers_program(k=4, n=10,
                                                           model="exp"),
                                 {"A": 1}, max_claim_rank=4,
                                 engine_opts=opts), {"A": a})
        shapes[tid] = ("A", (10, 10))
        tenant_inputs[tid] = {"A": a}
    for i, (m, d, p) in enumerate([(8, 4, 5), (6, 3, 4)]):
        tid = f"logit{i}"
        _, inputs = _logit_tenant(m, d, p, seed=i)
        fleet.add_tenant(spec_of(tid, logit(m, d, p), {"W": 1},
                                 max_claim_rank=4), inputs)
        shapes[tid] = ("W", (p, d))
        tenant_inputs[tid] = inputs
    tids = sorted(shapes)
    rng = np.random.default_rng(seed + 5)
    by_lsn = {tid: {} for tid in tids}
    admitted = {tid: 0 for tid in tids}
    decisions = []
    for step in range(150):
        tid = tids[int(rng.integers(len(tids)))]
        input_name, (n, m) = shapes[tid]
        u, v = _rank1(rng, n, m, scale=0.02)
        decisions.append(fleet.submit(tid, input_name, u, v))
        if decisions[-1] == ADMITTED:
            admitted[tid] += 1
            entry = fleet.registry.get(tid).log.pending(0)[-1]
            by_lsn[tid][entry.lsn] = entry.payload()
        vc.advance(0.01)
        if step % 25 == 24:
            fleet.run_until_idle(workers=3,
                                 on_stall=lambda: vc.advance(1.1))
    fleet.run_until_idle(workers=3, on_stall=lambda: vc.advance(1.1))
    return fleet, decisions, by_lsn, admitted, tenant_inputs


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_fleet_higher_order_chaos_bit_identical_and_exact(seed):
    """Two tenants on order-2 engines (``TenantSpec.engine_opts``) under
    fleet chaos: exactly-once commits; committed stores bit for bit
    against same-order isolated replays (an aborted or replayed claim
    never ticks a window twice); after a fold barrier, within 5e-6 of a
    first-order replay; and the JAX fleet's decisions, commit logs,
    tenant stats and fold counters under the same seed."""
    jfl, jdec, _, _, _ = _ho_fleet("jax", seed)
    fleet, decisions, by_lsn, admitted, tenant_inputs = \
        _ho_fleet("torch", seed)
    assert decisions == jdec
    assert fleet.registry.get("pow0").engine._deferred
    assert not fleet.registry.get("pow2").engine._deferred
    assert fleet.chaos.worker_crashes + fleet.chaos.lease_expiries > 0
    for tid in sorted(tenant_inputs):
        tenant, jt = fleet.registry.get(tid), jfl.registry.get(tid)
        assert tenant.commit_log == jt.commit_log, tid
        assert dataclasses.asdict(tenant.stats) == \
            dataclasses.asdict(jt.stats), tid
        for k in ("folds", "fold_sweeps", "fold_reevals", "fold_aborts"):
            assert getattr(tenant.engine.stats, k) == \
                getattr(jt.engine.stats, k), (tid, k)
        assert not tenant.dirty()
        assert tenant.stats.committed_updates == admitted[tid], tid
        ref = _replay_reference(tenant, tenant_inputs[tid], by_lsn[tid])
        assert max_abs_diff(tenant.committed_views, ref.views) == 0.0, tid
        # fold barrier, then the first-order differential: two float32
        # maintenance paths (per-firing sweeps against window folds)
        # drift apart by a few ulps per firing
        views = dict(tenant.engine.flush())
        first = IncrementalEngine(tenant.spec.program,
                                  tenant.spec.update_ranks,
                                  guard=GuardConfig() if tenant.spec.guarded
                                  else None, **CPU)
        first.initialize(tenant_inputs[tid])
        for input_name, lsns in tenant.commit_log:
            first.apply_updates(input_name, [by_lsn[tid][l] for l in lsns])
        for st in tenant.spec.program.statements:
            name = st.target.name
            want = first.views[name].double()
            err = float((views[name].double() - want).abs().max()) / max(
                float(want.abs().max()), 1.0)
            assert err <= 5e-6, f"{tid}/{name}: {err:.2e}"
    assert fleet.registry.get("pow0").engine.stats.folds > 0 or \
        fleet.registry.get("pow1").engine.stats.folds > 0
