"""The port's learning views (``repro_torch.fivm``) against the JAX
package's (``repro.fivm``).

Mirrors ``tests/test_fivm.py`` case for case on the port's engine (on the
CPU), and holds the two packages side by side where they share inputs:
the labeled stream is event for event the reference's, ``compress_leaf``
gives the reference's low-rank factors, and a ring driven by the same
events keeps the JAX ring's views within f32 parity (1e-5, scale-
normalized).  The reference's own contracts keep their tolerances: ring
views against a dense numpy oracle 1e-4, solvers against batch retrain
1e-5, insert-then-delete 1e-6.

The property suite runs under REPRO_CHAOS_SEEDS (comma-separated;
default "0"), as the reference's does.
"""

import os

import numpy as np
import pytest

import repro.data as jdata
import repro.fivm as jfivm
from conftest import assert_close
from repro_torch.core import (LowRankCarrier, NoOpCarrier, RowLocalCarrier,
                              row_delta_carrier)
from repro_torch.core.cost import solver_crossover_rank
from repro_torch.data import LabeledStream, LabeledUpdate, labeled_stream
from repro_torch.fivm import (DowndateError, KMeansSolver, OLSSolver, Ring,
                              RingRegistry, RingSpec, RidgeSolver,
                              batch_kmeans, batch_ridge, chol_rank1_update,
                              solve_cholesky)
from repro_torch.fivm.registry import submit_event
from repro_torch.plan import TriggerCache, solver_resolve_strategy

CHAOS_SEEDS = [int(s) for s in
               os.environ.get("REPRO_CHAOS_SEEDS", "0").split(",")]

CPU = {"device": "cpu"}
SPEC = RingSpec(features=8, targets=2, capacity=48, model_slots=2)
# port ring against the JAX ring, scale-normalized
PARITY = 1e-5


def _jspec(spec):
    return jfivm.RingSpec(features=spec.features, targets=spec.targets,
                          capacity=spec.capacity,
                          model_slots=spec.model_slots,
                          proj_dim=spec.proj_dim)


def _ring(spec=SPEC, **kw):
    return Ring(spec, trigger_cache=TriggerCache(), **CPU, **kw)


def drive(ring, stream, count):
    ring.apply_events(stream.events(count))


def _jax_events(events):
    return [jdata.LabeledUpdate(e.kind, e.slot, e.x, e.y) for e in events]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def oracle_views(stream: LabeledStream, spec: RingSpec):
    """Dense-replay oracle: the ring aggregates recomputed from the
    stream's live set."""
    X = np.zeros((spec.capacity, spec.features), np.float64)
    Y = np.zeros((spec.capacity, spec.targets), np.float64)
    W = np.zeros((spec.capacity, 1), np.float64)
    for slot in stream.live_slots:
        x, y = stream._live[slot]
        X[slot], Y[slot], W[slot] = x, y, 1.0
    return {"G": X.T @ X, "XY": X.T @ Y, "s": X.T @ W, "c": W.T @ W,
            "YY": Y.T @ Y}


# ---------------------------------------------------------------------------
# carriers: negation / downdate algebra
# ---------------------------------------------------------------------------


def dense_of(carrier):
    P, Q = carrier.factors()
    return np.asarray(P) @ np.asarray(Q).T


def test_carrier_negation_cancels():
    rng = np.random.default_rng(0)
    rl = row_delta_carrier([3, 7], rng.normal(size=(5, 2)), 12)
    lr = LowRankCarrier(rng.normal(size=(6, 2)).astype(np.float32),
                        rng.normal(size=(4, 2)).astype(np.float32))
    for c in (rl, lr):
        assert np.abs(dense_of(c) + dense_of(c.negate())).max() == 0.0
    assert isinstance(rl.negate(), RowLocalCarrier)
    assert list(rl.negate().rows) == [3, 7]
    assert NoOpCarrier(5, 4).negate().is_noop()


def test_row_delta_carrier_insert_delete_shapes():
    x = np.arange(4, dtype=np.float32)
    ins = row_delta_carrier(2, x, 10, weight=1.0)
    dele = row_delta_carrier(2, x, 10, weight=-1.0)
    d = dense_of(ins)
    assert d.shape == (10, 4) and np.array_equal(d[2], x)
    assert np.array_equal(dense_of(dele), -d)
    with pytest.raises(Exception):
        row_delta_carrier([0, 1], np.ones((4, 3)), 10)


# ---------------------------------------------------------------------------
# labeled stream contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("churn", [0.0, 0.5, 0.9])
def test_labeled_stream_matches_jax(churn):
    """The same seed gives the reference's events, event for event."""
    a = labeled_stream(6, targets=2, capacity=16, churn=churn, seed=9)
    b = jdata.labeled_stream(6, targets=2, capacity=16, churn=churn, seed=9)
    for x, y in zip(a.events(150), b.events(150)):
        assert (x.kind, x.slot, x.weight) == (y.kind, y.slot, y.weight)
        assert np.array_equal(x.x, y.x) and np.array_equal(x.y, y.y)
    assert np.array_equal(a.w_true, b.w_true)
    assert a.live_slots == b.live_slots


def test_labeled_stream_deterministic_replay():
    a = labeled_stream(6, targets=2, capacity=16, churn=0.5, seed=9)
    b = labeled_stream(6, targets=2, capacity=16, churn=0.5, seed=9)
    ea, eb = a.events(120), b.events(120)
    for x, y in zip(ea, eb):
        assert x.kind == y.kind and x.slot == y.slot
        assert np.array_equal(x.x, y.x) and np.array_equal(x.y, y.y)
    a.reset()
    for x, y in zip(ea, a.events(120)):
        assert x.kind == y.kind and x.slot == y.slot


def test_labeled_stream_deletes_replay_stored_payload():
    s = labeled_stream(5, capacity=8, churn=0.6, seed=2)
    live = {}
    for ev in s.events(200):
        if ev.kind == "insert":
            live[ev.slot] = ev
        else:
            prev = live.pop(ev.slot)
            assert np.array_equal(prev.x, ev.x)
            assert np.array_equal(prev.y, ev.y)
            assert ev.weight == -1.0


def test_labeled_stream_churn_knob():
    def delete_frac(churn):
        s = labeled_stream(4, capacity=512, churn=churn, seed=3)
        evs = s.events(400)
        return sum(e.kind == "delete" for e in evs) / len(evs)
    assert delete_frac(0.0) == 0.0
    assert delete_frac(0.2) < delete_frac(0.8)
    with pytest.raises(ValueError):
        labeled_stream(4, churn=1.0)


# ---------------------------------------------------------------------------
# ring exactness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
@pytest.mark.parametrize("churn", [0.0, 0.35, 0.8])
def test_ring_views_match_oracle_and_jax(seed, churn):
    ring = _ring()
    s = labeled_stream(SPEC.features, targets=SPEC.targets,
                       capacity=SPEC.capacity, churn=churn,
                       seed=seed * 65537 + 11)
    events = s.events(150)
    ring.apply_events(events)
    jring = jfivm.Ring(_jspec(SPEC))
    jring.apply_events(_jax_events(events))
    got = ring.read("G", "XY", "s", "c", "YY")
    want = oracle_views(s, SPEC)
    jgot = jring.read("G", "XY", "s", "c", "YY")
    for name in want:
        assert_close(got[name], want[name], rtol=1e-4, atol=1e-4,
                     msg=f"view {name} diverged (churn={churn})")
        assert _rel(got[name], jgot[name]) <= PARITY, name
    assert ring.count() == pytest.approx(s.live_count)


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_insert_then_delete_restores_ring(seed):
    ring = _ring()
    s = labeled_stream(SPEC.features, targets=SPEC.targets,
                       capacity=SPEC.capacity, churn=0.3, seed=seed)
    drive(ring, s, 60)
    before = ring.read("G", "XY", "s", "c", "YY")
    rng = np.random.default_rng(seed + 100)
    x = rng.normal(size=SPEC.features).astype(np.float32)
    y = rng.normal(size=SPEC.targets).astype(np.float32)
    slot = next(i for i in range(SPEC.capacity) if i not in s.live_slots)
    ring.apply(LabeledUpdate("insert", slot, x, y))
    mid = ring.gram()
    assert np.abs(mid - before["G"]).max() > 1e-3
    ring.apply(LabeledUpdate("delete", slot, x, y))
    after = ring.read("G", "XY", "s", "c", "YY")
    for name in before:
        scale = max(np.abs(before[name]).max(), 1.0)
        resid = np.abs(after[name] - before[name]).max() / scale
        assert resid < 1e-6, (name, resid)


def test_ring_projection_view_is_row_local():
    spec = RingSpec(features=8, targets=1, capacity=64, model_slots=0,
                    proj_dim=3)
    ring = _ring(spec)
    verdicts = ring.engine.compiled.triggers["X"].carriers
    assert verdicts.get("XP") == "row_local"
    assert verdicts.get("G") != "row_local"
    s = labeled_stream(spec.features, capacity=spec.capacity, churn=0.3,
                       seed=1)
    events = s.events(80)
    ring.apply_events(events)
    got = ring.read("XP", "G")
    X = ring.engine.views["X"].numpy()
    R = ring.engine.views["R"].numpy()
    assert_close(got["XP"], X @ R, rtol=1e-4, atol=1e-4)
    assert ring.stats.rowlocal_firings > 0 and ring.stats.row_applies > 0
    jring = jfivm.Ring(_jspec(spec))
    jring.apply_events(_jax_events(events))
    assert np.array_equal(R, np.asarray(jring.engine.views["R"]))
    assert _rel(got["XP"], jring.view("XP")) <= PARITY
    assert _rel(got["G"], jring.view("G")) <= PARITY


# ---------------------------------------------------------------------------
# Cholesky update/downdate, compression, pricing
# ---------------------------------------------------------------------------


def test_chol_rank1_update_and_downdate():
    rng = np.random.default_rng(4)
    n = 12
    A = rng.normal(size=(n, 2 * n))
    A = A @ A.T + np.eye(n)
    L = np.linalg.cholesky(A)
    x = rng.normal(size=n)
    chol_rank1_update(L, x, sign=1.0)
    assert_close(L @ L.T, A + np.outer(x, x), rtol=1e-9, atol=1e-9)
    chol_rank1_update(L, x, sign=-1.0)
    assert_close(L @ L.T, A, rtol=1e-8, atol=1e-8)


def test_chol_downdate_nonpd_raises():
    L = np.linalg.cholesky(np.eye(3))
    with pytest.raises(DowndateError):
        chol_rank1_update(L, np.array([2.0, 0.0, 0.0]), sign=-1.0)


def test_solve_cholesky_matches_solve():
    rng = np.random.default_rng(5)
    n = 9
    A = rng.normal(size=(n, 2 * n))
    A = A @ A.T + np.eye(n)
    L = np.linalg.cholesky(A)
    rhs = rng.normal(size=(n, 2))
    assert_close(solve_cholesky(L, rhs), np.linalg.solve(A, rhs),
                 rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("shape,k", [((8, 2), 2), ((16, 3), 1),
                                     ((3, 4, 5), 2)])
def test_compress_leaf_matches_jax(shape, k):
    """The port's power-iteration step gives the reference's ``P Qᵀ``
    and error feedback (the factors up to column signs)."""
    from repro.train.grad_compression import compress_leaf as jax_compress
    from repro_torch.train.grad_compression import compress_leaf
    rng = np.random.default_rng(7)
    g = rng.normal(size=shape).astype(np.float32)
    m = shape[-1]
    q0 = rng.normal(size=(m, k)).astype(np.float32)
    err = (rng.normal(size=(int(np.prod(shape[:-1])), m)) * 0.1
           ).astype(np.float32)
    P, Q, e = compress_leaf(g, q0, err)
    jP, jQ, je = (np.asarray(x) for x in jax_compress(g, q0, err))
    assert P.shape == jP.shape and Q.shape == jQ.shape
    assert _rel(P.numpy() @ Q.numpy().T, jP @ jQ.T) <= PARITY
    assert _rel(e.numpy(), je) <= PARITY
    assert compress_leaf(g, None, None) == (g, None, None)


def test_solver_resolve_strategy_crossover():
    n = 60
    k_star = solver_crossover_rank(n)
    assert k_star == 10
    assert solver_resolve_strategy(n, 1) == "update"
    assert solver_resolve_strategy(n, k_star - 1) == "update"
    assert solver_resolve_strategy(n, 2 * k_star) == "refactor"
    assert solver_resolve_strategy(n, 0) == "update"
    assert solver_resolve_strategy(n, k_star - 1,
                                   cost_scale=4.0) == "refactor"


# ---------------------------------------------------------------------------
# solvers vs batch retrain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_ridge_matches_batch_retrain_and_jax(seed, lam):
    ring = _ring()
    jring = jfivm.Ring(_jspec(SPEC))
    s = labeled_stream(SPEC.features, targets=SPEC.targets,
                       capacity=SPEC.capacity, churn=0.0,
                       seed=seed * 131 + 5)
    first = s.events(SPEC.capacity)        # warm fill
    ring.apply_events(first)
    jring.apply_events(_jax_events(first))
    solver = RidgeSolver(ring, lam=lam)
    jsolver = jfivm.RidgeSolver(jring, lam=lam)
    s.churn = 0.45
    for _ in range(3):                 # interleave churn and refresh
        evs = s.events(25)
        ring.apply_events(evs)
        jring.apply_events(_jax_events(evs))
        B = solver.coefficients()
        Xl, Yl = ring.live_data()
        assert Xl.shape[0] > SPEC.features
        assert np.abs(B - batch_ridge(Xl, Yl, lam)).max() < 1e-5, \
            (lam, solver.stats.strategy_log)
        assert np.abs(B - jsolver.coefficients()).max() < 1e-5
    assert solver.stats.refreshes == 3
    assert solver.stats.strategy_log == jsolver.stats.strategy_log
    # grad{slot} after the pushes, against the JAX ring's
    assert _rel(ring.gradient(solver.slot, lam),
                jring.gradient(jsolver.slot, lam)) <= 1e-4


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_ridge_after_delete_heavy_churn(seed):
    spec = RingSpec(features=6, targets=1, capacity=64)
    ring = _ring(spec)
    s = labeled_stream(spec.features, capacity=spec.capacity, churn=0.0,
                       seed=seed + 17)
    drive(ring, s, spec.capacity)
    solver = RidgeSolver(ring, lam=0.1)
    solver.coefficients()
    s.churn = 0.85
    drive(ring, s, 50)
    B = solver.coefficients()
    Xl, Yl = ring.live_data()
    assert 0 < Xl.shape[0] < spec.capacity
    assert np.abs(B - batch_ridge(Xl, Yl, 0.1)).max() < 1e-5
    assert np.abs(B - s.w_true).max() < 0.5


def test_downdate_fallback_refactors():
    spec = RingSpec(features=3, targets=1, capacity=8)
    ring = _ring(spec)
    e1 = np.array([1.0, 0, 0], np.float32)
    e2 = np.array([0, 1.0, 0], np.float32)
    e3 = np.array([0, 0, 1.0], np.float32)
    y = np.ones(1, np.float32)
    for slot, x in enumerate((e1, e2, e3)):
        ring.apply(LabeledUpdate("insert", slot, x, y))
    solver = RidgeSolver(ring, lam=1e-6)
    solver.coefficients()
    ring.apply(LabeledUpdate("delete", 2, e3, y))
    B = solver.coefficients()
    assert np.isfinite(B).all()
    assert solver.stats.downdate_fallbacks >= 1 or \
        "refactor" in solver.stats.strategy_log


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_kmeans_matches_batch_retrain(seed):
    ring = _ring()
    s = labeled_stream(SPEC.features, targets=SPEC.targets,
                       capacity=SPEC.capacity, churn=0.4, seed=seed + 3)
    drive(ring, s, 170)
    km = KMeansSolver(ring, 3, seed=seed)
    C = km.fit()
    Xl, _ = ring.live_data()
    C_batch, labels = batch_kmeans(Xl, 3, seed=seed)
    assert np.abs(C - C_batch).max() < 1e-5
    assert np.array_equal(km.assign(Xl), labels)


def test_gradient_stays_maintained_after_data_arrival():
    ring = _ring()
    s = labeled_stream(SPEC.features, targets=SPEC.targets,
                       capacity=SPEC.capacity, churn=0.0, seed=11)
    drive(ring, s, 40)
    solver = RidgeSolver(ring, lam=0.2)
    B = solver.coefficients()
    s.churn = 0.4
    drive(ring, s, 30)                 # more data, no re-solve
    g = ring.gradient(solver.slot, 0.2)
    want = ring.gram() @ B - ring.xty() + 0.2 * B
    assert_close(g, want, rtol=1e-4, atol=1e-4)
    assert np.abs(g).max() > 1e-3


def test_ols_solver_is_lam_zero():
    ring = _ring()
    s = labeled_stream(SPEC.features, targets=SPEC.targets,
                       capacity=SPEC.capacity, churn=0.0, seed=21)
    drive(ring, s, SPEC.capacity)
    ols = OLSSolver(ring)
    assert ols.lam == 0.0
    Xl, Yl = ring.live_data()
    assert np.abs(ols.coefficients() - batch_ridge(Xl, Yl, 0.0)).max() \
        < 1e-5


# ---------------------------------------------------------------------------
# deferred (decoupled-refresh) + guarded rings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_deferred_ring_matches_first_order(seed):
    """order=2: ingest banks the widened carriers, the read folds — the
    per-firing ring's answers, the JAX deferred ring's fold counters."""
    s = labeled_stream(SPEC.features, targets=SPEC.targets,
                       capacity=SPEC.capacity, churn=0.35, seed=seed)
    events = s.events(120)
    eager = _ring()
    lazy = _ring(order=2, fold_window=4)
    jlazy = jfivm.Ring(_jspec(SPEC), order=2, fold_window=4)
    eager.apply_events(events)
    lazy.apply_events(events)
    jlazy.apply_events(_jax_events(events))
    ge, gl = eager.read("G", "XY"), lazy.read("G", "XY")
    assert_close(gl["G"], ge["G"], rtol=1e-4, atol=1e-4)
    assert_close(gl["XY"], ge["XY"], rtol=1e-4, atol=1e-4)
    assert _rel(gl["G"], jlazy.view("G")) <= PARITY
    assert lazy.stats.folds == jlazy.stats.folds > 0
    assert lazy.stats.rowlocal_firings == 0
    assert lazy.stats.fold_reevals == jlazy.stats.fold_reevals
    solver = RidgeSolver(lazy, lam=0.1)
    B = solver.coefficients()
    Xl, Yl = lazy.live_data()
    assert np.abs(B - batch_ridge(Xl, Yl, 0.1)).max() < 1e-5


def test_guarded_ring_stays_exact():
    ring = _ring(guard=True)
    s = labeled_stream(SPEC.features, targets=SPEC.targets,
                       capacity=SPEC.capacity, churn=0.3, seed=6)
    drive(ring, s, 90)
    want = oracle_views(s, SPEC)
    got = ring.read("G", "XY", "c")
    for name in got:
        assert_close(got[name], want[name], rtol=1e-4, atol=1e-4)
    assert ring.engine.guard.stats.admitted == 3 * 90


# ---------------------------------------------------------------------------
# registry: one ring, many models; fleet face
# ---------------------------------------------------------------------------


def test_registry_shares_one_ring_across_models():
    reg = RingRegistry(TriggerCache())
    spec = RingSpec(features=6, targets=1, capacity=32, model_slots=3)
    r1, r2 = reg.acquire(spec, **CPU), reg.acquire(spec, **CPU)
    assert r1 is r2
    ridge = reg.model(spec, "ridge", "ridge", lam=0.2)
    ols = reg.model(spec, "ols", "ols")
    km = reg.model(spec, "km", "kmeans", k=2)
    assert reg.model(spec, "ridge") is ridge
    assert ridge.slot != ols.slot
    s = labeled_stream(spec.features, capacity=spec.capacity, churn=0.2,
                       seed=8)
    drive(r1, s, 70)
    Xl, Yl = r1.live_data()
    assert np.abs(ridge.coefficients()
                  - batch_ridge(Xl, Yl, 0.2)).max() < 1e-5
    assert np.abs(ols.coefficients()
                  - batch_ridge(Xl, Yl, 0.0)).max() < 1e-5
    km.fit()
    stats = reg.stats()
    assert stats["rings"] == 1 and len(stats["models"]) == 1
    assert reg.release(spec) == 1
    assert reg.release(spec) == 0 and reg.evictions == 1
    with pytest.raises(KeyError):
        reg.get(spec)


def test_registry_slot_exhaustion():
    reg = RingRegistry(TriggerCache())
    spec = RingSpec(features=4, capacity=8, model_slots=1)
    reg.acquire(spec, **CPU)
    reg.model(spec, "a", "ridge")
    with pytest.raises(RuntimeError, match="model slots"):
        reg.model(spec, "b", "ols")


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_fleet_ring_tenant_matches_local(seed):
    """The same labeled events submitted as carriers through the fleet
    give a ring bit for bit equal to a local one, and the JAX fleet's
    admission decisions."""
    from repro_torch.fleet import FleetConfig, FleetScheduler
    spec = RingSpec(features=5, targets=1, capacity=24, model_slots=1)
    fleet = FleetScheduler(FleetConfig(lease_ttl=0.5))
    reg = RingRegistry(TriggerCache())
    reg.add_fleet_tenant(fleet, spec, "ring-t", slo_s=0.5,
                         engine_opts=CPU)
    s = labeled_stream(spec.features, capacity=spec.capacity, churn=0.4,
                       seed=seed + 29)
    events = s.events(60)
    for ev in events:
        decs = submit_event(fleet, "ring-t", spec.capacity, ev)
        assert set(decs) == {"admitted"}
    fleet.run_until_idle()
    local = _ring(spec)
    local.apply_events(events)
    for name in ("G", "XY", "c"):
        assert np.abs(fleet.read_views("ring-t")[name].numpy()
                      - local.view(name)).max() == 0.0
    health = fleet.tenant_health()[0]
    assert health["pending"] == 0 and health["quarantined"] == 0
    assert fleet.registry.get("ring-t").engine.stats.rowlocal_firings == 0


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------


def test_app_registry_enumerates_fivm():
    from repro_torch.apps import available_apps, get_app
    apps = available_apps()
    assert "fivm_learning" in apps and "ols" in apps
    with pytest.raises(KeyError, match="available"):
        get_app("nope")


def test_fivm_app_end_to_end():
    """The order-2 serve demo: ingest banks, reads fold and re-solve; the
    JAX app driven alike gives the same ledger and the same model."""
    from repro.apps import get_app as jax_get_app
    from repro_torch.apps import get_app
    app = get_app("fivm_learning")(features=6, capacity=32, order=2,
                                   churn=0.3, seed=4, **CPU)
    japp = jax_get_app("fivm_learning")(features=6, capacity=32, order=2,
                                        churn=0.3, seed=4)
    out = app.serve_demo(bursts=4, burst_size=12, reads=2)
    jout = japp.serve_demo(bursts=4, burst_size=12, reads=2)
    assert out["events"] == 48
    assert out["folds"] > 0
    assert out["refreshes"] >= 1
    for k in ("events", "live", "folds", "refreshes", "strategies"):
        assert out[k] == jout[k], k
    B = app.model.coefficients()
    Xl, Yl = app.ring.live_data()
    assert np.abs(B - batch_ridge(Xl, Yl, app.model.lam)).max() < 1e-5
    assert np.abs(B - japp.model.coefficients()).max() < 1e-5
