"""repro_torch.plan against the JAX package's repro.plan, on the CPU.

The port's planner is pure arithmetic over the symbolic program, so its
plans must be the reference's plans string for string (fingerprint and
JSON, depth pricing and chain-aware pricing included).  Its engine must
execute a plan as the reference does: for any update stream and any
plan, planned engine == unplanned engine == re-evaluation within f32
tolerance, and the same views re-evaluated, skipped and recomputed.  The
rest mirrors tests/test_planner.py (its two mesh tests are held in
tests/test_torch_ivm_shard.py against the reference's single-device
engine), plus what only the port has to get right: in-place applies
against a recomputed view's storage, a plan's mesh key, and the carrier
path under a plan.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.plan as jplan
import repro_torch.core as tcore
import repro_torch.plan as tplan
from repro.apps.ols import build_ols_program as jax_ols
from repro.data.updates import UpdateStream
from repro_torch.apps.ols import build_ols_program as torch_ols
from repro_torch.core import IncrementalEngine, ReevalEngine
from repro_torch.plan import (AdaptivePlanner, MaintenancePlan, TriggerCache,
                              WorkloadDescriptor, calibrate_cost_scale,
                              calibrate_op_cost_scales, plan_for_engine,
                              static_plan)

# f32 engine parity, as max |a - b| over the view's largest entry
TOL = 1e-5


def _chain(core, n=64, m=12, k=8):
    """Left chain Y1 = X·W1, Y2 = Y1·W2 (every view row-local)."""
    p = core.Program(name="chain")
    X = p.input("X", (core.dim("N"), core.dim("M")))
    W1 = p.input("W1", (core.dim("M"), core.dim("K")))
    W2 = p.input("W2", (core.dim("K"), core.dim("K")))
    Y1 = p.let("Y1", core.matmul(X, W1))
    p.let("Y2", core.matmul(Y1, W2))
    p.outputs = ["Y1", "Y2"]
    return p.bind_dims(N=n, M=m, K=k)


# name -> (builder taking (core, ols builder) of one package, input, shape)
PROGRAMS = {
    "ols": (lambda core, ols: ols(96, 48, 1), "X", (96, 48)),
    "powers": (lambda core, ols: core.iterative.matrix_powers(
        k=8, n=48, model="exp"), "A", (48, 48)),
    "chain": (lambda core, ols: _chain(core), "X", (64, 12)),
}


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "ols":
        return {"X": rng.normal(size=(96, 48)).astype(np.float32),
                "Y": rng.normal(size=(96, 1)).astype(np.float32)}
    if name == "powers":
        a = (0.5 / np.sqrt(48)) * rng.normal(size=(48, 48))
        return {"A": a.astype(np.float32)}
    return {"X": rng.normal(size=(64, 12)).astype(np.float32),
            "W1": (rng.normal(size=(12, 8)) / 4).astype(np.float32),
            "W2": (rng.normal(size=(8, 8)) / 3).astype(np.float32)}


def _programs(name):
    build = PROGRAMS[name][0]
    return build(jcore, jax_ols), build(tcore, torch_ols)


def _updates(n, m, count, seed=3, rank=1):
    it = iter(UpdateStream(n=n, m=m, rank=rank, scale=0.02, seed=seed))
    return [next(it) for _ in range(count)]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() or 1.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_views(got, want, what, keys=None):
    for k in keys or want:
        r = _rel(_np(got[k]), _np(want[k]))
        assert r <= TOL, f"{what}: view {k} off by {r}"


def _ols_engine(**kw):
    return IncrementalEngine(torch_ols(96, 48, 1), device="cpu", **kw)


def _ols_reeval(ups):
    ree = ReevalEngine(torch_ols(96, 48, 1), device="cpu")
    ree.initialize(_inputs("ols"))
    for u, v in ups:
        ree.apply_update("X", u, v)
    return ree


# -- planner parity ------------------------------------------------------------

WORKLOADS = {
    "batch2": dict(batch_size=2),
    "batch100000": dict(batch_size=100000),
    "rare_reads": dict(batch_size=4, reads_per_firing=1e-4),
    "contained": dict(update_rank=8, affected_fraction=0.01),
    "chain_aware": dict(batch_size=4, chain_aware=True),
    "max_order2": dict(max_order=2),
    "max_order2_rare_reads": dict(batch_size=16, max_order=2,
                                  reads_per_firing=0.01),
    "straddling": dict(batch_size=3, rank_lo=1, rank_hi=400,
                       cost_scale=2.5, op_cost_scales={"inverse": 3.0}),
}


@pytest.mark.parametrize("prog_name", sorted(PROGRAMS))
def test_fingerprint_matches_jax(prog_name):
    jprog, tprog = _programs(prog_name)
    assert tplan.program_fingerprint(tprog) == \
        jplan.program_fingerprint(jprog)
    binding = {k: v + 1 for k, v in tprog.dims.items()}
    assert tplan.program_fingerprint(tprog, binding) == \
        jplan.program_fingerprint(jprog, binding)


@pytest.mark.parametrize("prog_name", sorted(PROGRAMS))
@pytest.mark.parametrize("wl_name", sorted(WORKLOADS))
def test_plan_json_matches_jax(prog_name, wl_name):
    jprog, tprog = _programs(prog_name)
    want = jplan.plan_program(jprog, jplan.WorkloadDescriptor(
        **WORKLOADS[wl_name])).to_json()
    got = tplan.plan_program(tprog, WorkloadDescriptor(
        **WORKLOADS[wl_name])).to_json()
    assert got == want
    assert MaintenancePlan.from_json(got).to_json() == got


def test_depth_pricing_assigns_order_two():
    """The rare-reads depth workload really prices a view at order 2 (so
    the JSON parity above covers _price_depth and _resolve_depths)."""
    _, tprog = _programs("powers")
    plan = tplan.plan_program(tprog, WorkloadDescriptor(
        **WORKLOADS["max_order2_rare_reads"]))
    assert any(vp.order == 2 for vp in plan.views.values())


@pytest.mark.parametrize("prog_name", sorted(PROGRAMS))
def test_firing_cost_flops_matches_jax(prog_name):
    jprog, tprog = _programs(prog_name)
    jc, tc = jcore.compile_program(jprog), tcore.compile_program(tprog)
    inp = PROGRAMS[prog_name][1]
    views = [st.target.name for st in tprog.statements]
    for wl in (None, dict(cost_scale=3.0, chain_aware=True),
               dict(affected_fraction=0.05, op_cost_scales={"other": 2.0})):
        jw = None if wl is None else jplan.WorkloadDescriptor(**wl)
        tw = None if wl is None else WorkloadDescriptor(**wl)
        for rank in (1, 7, 64):
            for reeval in (frozenset(), frozenset(views[:1])):
                for orders in (None, {views[-1]: 2}):
                    for frac in (None, 0.02):
                        kw = dict(reeval_views=reeval, view_orders=orders,
                                  affected_fraction=frac)
                        want = jplan.firing_cost_flops(
                            jc, dict(jprog.dims), inp, rank, workload=jw,
                            **kw)
                        got = tplan.firing_cost_flops(
                            tc, dict(tprog.dims), inp, rank, workload=tw,
                            **kw)
                        assert got == pytest.approx(want, rel=1e-12)
    ja, jd = jplan.trigger_chain_costs(jc.triggers[inp], dict(jprog.dims))
    ta, td = tplan.trigger_chain_costs(tc.triggers[inp], dict(tprog.dims))
    assert (ta, td) == (ja, jd)


def test_solver_resolve_strategy_matches_jax():
    for n in (4, 48, 1000):
        for pending in (0, 1, 7, 200, 5000):
            for scale in (0.5, 1.0, 30.0):
                assert tplan.solver_resolve_strategy(
                    n, pending, cost_scale=scale) == \
                    jplan.solver_resolve_strategy(n, pending,
                                                  cost_scale=scale)


# -- engine parity: planned == JAX planned == re-evaluation --------------------


def _forced_hybrid_json(prog_name, threshold=5):
    jprog, _ = _programs(prog_name)
    eng = jcore.IncrementalEngine(jprog)
    base = jplan.plan_for_engine(eng, jplan.WorkloadDescriptor())
    views = {n: replace(v, strategy="hybrid", threshold_rank=threshold)
             for n, v in base.views.items()}
    return jplan.MaintenancePlan(fingerprint=base.fingerprint,
                                 workload=base.workload,
                                 views=views).to_json()


def _plans(prog_name, plan_kind, threshold=5):
    """The same plan for each package: a workload descriptor, or (forced
    hybrid) the JAX plan handed to the port through its JSON."""
    if plan_kind == "hybrid":
        s = _forced_hybrid_json(prog_name, threshold)
        return jplan.MaintenancePlan.from_json(s), MaintenancePlan.from_json(s)
    batch = {"incremental": 2, "reeval": 100000}[plan_kind]
    return (jplan.WorkloadDescriptor(batch_size=batch),
            WorkloadDescriptor(batch_size=batch))


def _planned_engines(prog_name, plan_kind, threshold=5):
    jprog, tprog = _programs(prog_name)
    jp, tp = _plans(prog_name, plan_kind, threshold)
    je = jcore.IncrementalEngine(jprog, plan=jp,
                                 trigger_cache=jplan.TriggerCache())
    te = IncrementalEngine(tprog, plan=tp, trigger_cache=TriggerCache(),
                           device="cpu")
    tr = ReevalEngine(tprog, device="cpu")
    for e in (je, te, tr):
        e.initialize(_inputs(prog_name))
    return je, te, tr


@pytest.mark.parametrize("prog_name", ["ols", "powers"])
@pytest.mark.parametrize("plan_kind", ["incremental", "reeval", "hybrid"])
@pytest.mark.parametrize("t_batch", [3, 8])  # 3: ragged, pads to bucket 4
def test_planned_engine_matches_jax_and_reeval(prog_name, plan_kind,
                                               t_batch):
    inp, (n, m) = PROGRAMS[prog_name][1:]
    ups = _updates(n, m, t_batch, seed=41 + t_batch)
    je, te, tr = _planned_engines(prog_name, plan_kind)
    assert te.plan.to_json() == je.plan.to_json()
    je.apply_updates(inp, ups, block=True)
    te.apply_updates(inp, ups, block=True)
    je.refresh()
    te.refresh()
    for u, v in ups:
        tr.apply_update(inp, u, v)
    _assert_views(te.views, je.views, "port vs JAX planned")
    _assert_views(te.views, tr.views, "port planned vs reeval",
                  keys=[st.target.name for st in te.program.statements])
    for k in ("plan_reevals", "lazy_skips", "updates_applied",
              "triggers_fired"):
        assert getattr(te.stats, k) == getattr(je.stats, k), k
    assert te.stats.triggers_fired == 1
    if plan_kind == "reeval":
        assert te.stats.plan_reevals > 0
    # the kernel runs only for the incremental views (and the input)
    bucket = 4 if t_batch == 3 else 8
    (fn,) = [f for (_, b, _, _), f in te._planned_fns.items() if b == bucket]
    incr = sum(up.kind == "lowrank" for up in
               te._bucket_trigger(inp, bucket).updates
               if up.view in fn.incr_views)
    assert te.stats.lowrank_applies == fn.lowrank_applies == incr


@pytest.mark.parametrize("prog_name", ["ols", "powers"])
def test_planned_per_update_stream_matches_jax(prog_name):
    """Single-update firings through a forced-hybrid plan: the
    switchover happens mid-stream and every view stays exact."""
    inp, (n, m) = PROGRAMS[prog_name][1:]
    ups = _updates(n, m, 9, seed=53)
    je, te, tr = _planned_engines(prog_name, "hybrid", threshold=4)
    for u, v in ups:
        je.apply_update(inp, jnp.asarray(u), jnp.asarray(v))
        te.apply_update(inp, u, v)
        tr.apply_update(inp, u, v)
    assert te.stats.plan_reevals == je.stats.plan_reevals > 0
    assert te._accum_rank == je._accum_rank
    _assert_views(te.views, je.views, "port vs JAX planned")
    _assert_views(te.views, tr.views, "port planned vs reeval",
                  keys=te.program.output_names())


def test_recomputed_view_owns_its_storage():
    """A view re-evaluated inside a firing to a torch view of an input
    (``T = Xᵀ``) gets storage of its own: the next firing's in-place
    apply to X must not write through to T, which it then also sweeps."""
    p = tcore.Program(name="alias_reeval")
    X = p.input("X", (tcore.dim("N"), tcore.dim("M")))
    p.let("T", tcore.transpose(X))
    p.outputs = ["T"]
    p.bind_dims(N=12, M=7)
    eng0 = IncrementalEngine(p, device="cpu")
    base = plan_for_engine(eng0, WorkloadDescriptor())
    # hybrid at threshold 2 under rank-1 firings: sweep, re-evaluate,
    # sweep, ...
    plan = MaintenancePlan(base.fingerprint, base.workload, {
        "T": replace(base.views["T"], strategy="hybrid", threshold_rank=2)})
    eng = IncrementalEngine(p, plan=plan, trigger_cache=TriggerCache(),
                            device="cpu")
    ree = ReevalEngine(p, device="cpu")
    x0 = np.random.default_rng(2).normal(size=(12, 7)).astype(np.float32)
    for e in (eng, ree):
        e.initialize({"X": x0})
    for u, v in _updates(12, 7, 5, seed=9):
        eng.apply_update("X", u, v)
        ree.apply_update("X", u, v)
        t = eng.views["T"]
        assert t.untyped_storage().data_ptr() != \
            eng.views["X"].untyped_storage().data_ptr()
    assert eng.stats.plan_reevals == 2
    _assert_views(eng.views, ree.views, "alias reeval")


# -- plans with depth, and plans the port cannot execute yet -------------------


def test_depth_two_plan_raises_not_run_at_first_order():
    """A plan with per-view depths is adopted as the JAX engine adopts it
    (never dropped to first order without a trace), and a depth plan that
    leaves a view unmaterialized raises."""
    eng = _ols_engine()
    plan = plan_for_engine(eng, WorkloadDescriptor())
    deep = replace(plan, views={**plan.views, "W": replace(
        plan.views["W"], order=2)})
    eng.set_plan(deep)
    assert eng.plan is deep
    jeng = jcore.IncrementalEngine(jax_ols(96, 48, 1))
    jeng.set_plan(jplan.MaintenancePlan.from_json(deep.to_json()))
    assert eng._view_orders == jeng._view_orders
    assert _ols_engine(plan=deep)._view_orders == jeng._view_orders
    # the planner's own depth assignment runs at depth, exactly as JAX's
    jprog, tprog = _programs("powers")
    wl = WORKLOADS["max_order2_rare_reads"]
    te = IncrementalEngine(tprog, device="cpu",
                           plan=WorkloadDescriptor(**wl))
    je = jcore.IncrementalEngine(jprog, plan=jplan.WorkloadDescriptor(**wl))
    assert te._view_orders == je._view_orders
    assert te._deferred and te._deferred == je._deferred
    for e in (te, je):
        e.initialize(_inputs("powers"))
        for u, v in _updates(48, 48, 5):
            e.apply_update("A", u, v)
        e.flush()
    assert te.stats.folds == je.stats.folds > 0
    _assert_views(te.views, je.views, "port vs JAX at depth 2")
    lazy = replace(deep, views={**deep.views, "Z": replace(
        deep.views["Z"], materialize=False)})
    with pytest.raises(ValueError, match="materialize"):
        _ols_engine(plan=lazy)


def test_mesh_raises_naming_item_12(tmp_path):
    """A plan runs only on the mesh it was priced for (the refusal of any
    mesh, ROADMAP.md Queue 1 item 12, was lifted by item 12b-i): set_plan
    raises ValueError for another mesh's key, on a mesh engine and on a
    single-device one."""
    import torch_shard_workers as w
    assert tplan.mesh_cache_key(None) is None
    other = ((("rows", 2),), "rows", "cpu", (0, 1))
    eng = _ols_engine()
    plan = plan_for_engine(eng, WorkloadDescriptor())
    assert plan.mesh_key is None
    with pytest.raises(ValueError, match="mesh key"):
        eng.set_plan(replace(plan, mesh_key=other))
    with w.one_rank_mesh(tmp_path) as mesh:
        _, tprog = _programs("ols")
        meng = IncrementalEngine(tprog, mesh=mesh)
        with pytest.raises(ValueError, match="mesh key"):
            meng.set_plan(plan)
        with pytest.raises(ValueError, match="mesh key"):
            meng.set_plan(replace(plan, mesh_key=other))


def test_planned_mesh_engine_honours_its_key(tmp_path):
    """plan_program(mesh=...) records the mesh's shape, axes and key
    (JSON round trip included); the planned mesh engine adopts it, keys
    its trigger cache on it, and matches the single-device planned
    engine."""
    import torch_shard_workers as w
    wl = WorkloadDescriptor(batch_size=100000)
    with w.one_rank_mesh(tmp_path) as mesh:
        key = tplan.mesh_cache_key(mesh)
        assert key == ((("rows", 1),), "rows", "cpu", (0,))
        assert hash(key) == hash(tplan.mesh_cache_key(mesh, "rows"))
        _, tprog = _programs("powers")
        plan = tplan.plan_program(tprog, wl, mesh=mesh)
        assert plan.mesh_key == key
        assert plan.workload.mesh_shape == (1,)
        assert plan.workload.mesh_axes == ("rows",)
        assert MaintenancePlan.from_json(plan.to_json()) == plan
        cache = TriggerCache()
        eng = IncrementalEngine(tprog, mesh=mesh, plan=plan,
                                trigger_cache=cache)
        assert eng.plan.mesh_key == key
        eng.initialize(_inputs("powers"))
        for u, v in _updates(48, 48, 5):
            eng.apply_update("A", u, v)
        assert eng.stats.plan_reevals > 0
        assert any(key in k for k in cache._fns)
        got = eng.views_numpy()
    single = IncrementalEngine(_programs("powers")[1], device="cpu",
                               plan=wl, trigger_cache=TriggerCache())
    single.initialize(_inputs("powers"))
    for u, v in _updates(48, 48, 5):
        single.apply_update("A", u, v)
    _assert_views(got, single.views, "mesh vs single-device, planned")


# -- planner decisions --------------------------------------------------------


def test_planner_picks_reeval_past_crossover_and_incremental_below():
    from repro_torch.core.cost import (batch_crossover_rank, expr_cost,
                                       shape_of)
    eng = _ols_engine()
    below = plan_for_engine(eng, WorkloadDescriptor(batch_size=2))
    assert all(vp.strategy == "incremental" for vp in below.views.values())
    above = plan_for_engine(eng, WorkloadDescriptor(batch_size=10 ** 6))
    assert all(vp.strategy == "reeval" for vp in above.views.values())
    for name, vp in below.views.items():
        st = eng.program.statement_for(name)
        shape = shape_of(st.target, eng.binding)
        kstar = batch_crossover_rank(shape,
                                     expr_cost(st.expr, eng.binding).flops)
        assert vp.crossover_rank == kstar
        assert below.workload.expected_rank() < kstar
        assert above.workload.expected_rank() >= kstar


def test_planner_straddling_distribution_goes_hybrid():
    eng = _ols_engine()
    kstars = sorted(vp.crossover_rank for vp in
                    plan_for_engine(eng, WorkloadDescriptor()).views.values())
    plan = plan_for_engine(eng, WorkloadDescriptor(
        batch_size=kstars[0], rank_lo=1, rank_hi=kstars[-1] + 1))
    assert any(vp.strategy == "hybrid" for vp in plan.views.values())
    for vp in plan.views.values():
        if vp.strategy == "hybrid":
            assert vp.threshold_rank == vp.crossover_rank


def test_cost_scale_lowers_effective_crossover():
    eng = _ols_engine()
    base = plan_for_engine(eng, WorkloadDescriptor(batch_size=8))
    assert all(vp.strategy == "incremental" for vp in base.views.values())
    kstars = [vp.crossover_rank for vp in base.views.values()]
    scaled = plan_for_engine(
        eng, WorkloadDescriptor(batch_size=8, cost_scale=max(kstars)))
    assert all(vp.strategy == "reeval" for vp in scaled.views.values())
    assert [vp.crossover_rank for vp in scaled.views.values()] == kstars
    hyb = plan_for_engine(eng, WorkloadDescriptor(
        batch_size=1, rank_lo=1, rank_hi=10 ** 6, cost_scale=4.0))
    for vp in hyb.views.values():
        if vp.strategy == "hybrid":
            assert vp.threshold_rank == max(1, vp.crossover_rank // 4)


def test_static_plan_forces_strategy_and_stays_exact():
    eng = _ols_engine(trigger_cache=TriggerCache())
    eng.set_plan(static_plan(eng, "reeval"))
    eng.initialize(_inputs("ols"))
    ups = _updates(96, 48, 3, seed=77)
    eng.apply_updates("X", ups, block=True)
    assert eng.stats.plan_reevals == 3
    # only the input's own apply is left to the kernel
    assert eng.stats.lowrank_applies == 1
    _assert_views(eng.views, _ols_reeval(ups).views, "static reeval",
                  keys=["Z", "W", "beta"])


def test_calibrate_cost_scale_smoke():
    cache = TriggerCache()
    scale = calibrate_cost_scale(
        lambda: IncrementalEngine(torch_ols(64, 32, 1), device="cpu",
                                  trigger_cache=cache),
        {"X": np.random.default_rng(0).normal(size=(64, 32)).astype(
            np.float32),
         "Y": np.ones((64, 1), np.float32)}, "X", probe_rank=4, samples=2,
        trigger_cache=cache)
    assert 0 < scale < float("inf")
    eng = IncrementalEngine(torch_ols(64, 32, 1), device="cpu")
    plan = plan_for_engine(eng, WorkloadDescriptor(batch_size=2,
                                                   cost_scale=scale))
    assert set(plan.views) == {"Z", "W", "beta"}


def test_calibrate_op_cost_scales_smoke():
    scales = calibrate_op_cost_scales(n=32, samples=2, device="cpu")
    assert set(scales) == {"matmul", "inverse", "other"}
    assert scales["matmul"] == 1.0
    assert all(0 < s < float("inf") for s in scales.values())


def test_plan_json_roundtrip():
    eng = _ols_engine()
    plan = plan_for_engine(eng, WorkloadDescriptor(batch_size=4,
                                                   reads_per_firing=0.001))
    back = MaintenancePlan.from_json(plan.to_json())
    assert back.views == plan.views
    assert back.fingerprint == plan.fingerprint
    assert back.workload == plan.workload


def test_plan_fingerprint_mismatch_rejected():
    eng = _ols_engine()
    other = IncrementalEngine(torch_ols(64, 32, 1), device="cpu")
    with pytest.raises(ValueError):
        eng.set_plan(plan_for_engine(other, WorkloadDescriptor()))


# -- per-view reeval fallback without a plan (cost flush policy) --------------


def test_cost_policy_firing_reevaluates_losing_view():
    """The 'cost' policy flushes at the crossover, and the flushed firing
    re-evaluates exactly the views past their crossover — the same ones
    the JAX engine re-evaluates."""
    jprog, _ = _programs("ols")
    je = jcore.IncrementalEngine(jprog, flush_policy="cost", flush_age=1e9)
    te = _ols_engine(flush_policy="cost", flush_age=1e9)
    for e in (je, te):
        e.initialize(_inputs("ols"))
    k_star = te.cost_flush_rank("X")
    assert k_star == je.cost_flush_rank("X")
    ups = _updates(96, 48, k_star, seed=61)
    for u, v in ups:
        je.enqueue_update("X", u, v)
        te.enqueue_update("X", u, v)
    assert te.stats.batches_applied == 1
    assert te.stats.plan_reevals == je.stats.plan_reevals > 0
    _assert_views(te.views, je.views, "port vs JAX cost policy")
    _assert_views(te.views, _ols_reeval(ups).views, "cost policy vs reeval",
                  keys=["Z", "W", "beta"])


# -- lazy materialization -----------------------------------------------------


def test_lazy_intermediate_skipped_then_refreshed():
    plan = plan_for_engine(_ols_engine(), WorkloadDescriptor(
        batch_size=4, reads_per_firing=1e-4))
    assert "Z" in plan.lazy_views()
    assert "beta" not in plan.lazy_views()
    eng = _ols_engine(plan=plan, trigger_cache=TriggerCache())
    eng.initialize(_inputs("ols"))
    ups = _updates(96, 48, 4, seed=67)
    eng.apply_updates("X", ups, block=True)
    assert eng.stats.lazy_skips > 0
    assert "Z" in eng._stale
    ree = _ols_reeval(ups)
    beta = eng.output("beta")
    assert eng.stats.reads == 1
    assert _rel(beta.numpy(), ree.views["beta"].numpy()) <= TOL
    assert not eng._stale
    _assert_views(eng.views, ree.views, "lazy refresh",
                  keys=["Z", "W", "beta"])


def test_stale_lazy_view_recomputed_for_cross_trigger_reeval():
    """A lazy view left stale by one input's firing is refreshed inside a
    LATER firing of a different input whose plan re-evaluates a consumer
    — the recompute closure may not read the stale value."""
    n = 16
    prog = tcore.Program(name="xtrig")
    N = tcore.dim("n")
    A = prog.input("A", (N, N))
    B = prog.input("B", (N, N))
    L = prog.let("L", tcore.matmul(B, B))
    prog.let("R", tcore.matmul(A, L))
    prog.bind_dims(n=n)
    eng0 = IncrementalEngine(prog, {"A": 1, "B": 1}, device="cpu")
    base = plan_for_engine(eng0, WorkloadDescriptor())
    plan = MaintenancePlan(
        fingerprint=base.fingerprint, workload=base.workload,
        views={"L": replace(base.views["L"], strategy="incremental",
                            materialize=False),
               "R": replace(base.views["R"], strategy="hybrid",
                            threshold_rank=2, materialize=True)})
    eng = IncrementalEngine(prog, {"A": 1, "B": 1}, plan=plan,
                            trigger_cache=TriggerCache(), device="cpu")
    rng = np.random.default_rng(11)
    A0 = rng.normal(size=(n, n)).astype(np.float32)
    B0 = rng.normal(size=(n, n)).astype(np.float32)
    eng.initialize({"A": A0, "B": B0})
    fac = lambda: 0.1 * rng.normal(size=(n, 1)).astype(np.float32)
    u1, v1, u2, v2 = fac(), fac(), fac(), fac()
    eng.apply_update("B", u1, v1)
    assert "L" in eng._stale
    eng.apply_update("A", u2, v2)
    A1 = A0 + u2 @ v2.T
    B1 = B0 + u1 @ v1.T
    assert np.abs(eng.views["R"].numpy() - A1 @ (B1 @ B1)).max() < 1e-4
    eng.flush(block=True)
    assert not eng._stale
    assert np.abs(eng.views["L"].numpy() - B1 @ B1).max() < 1e-4


# -- persistent trigger cache -------------------------------------------------


def test_trigger_cache_no_rebuild_on_second_engine():
    """Two engines, identical program, sizes, device and plan: the second
    reuses every trigger fn — no new cache entry, the same objects."""
    cache = TriggerCache()
    wl = WorkloadDescriptor(batch_size=4)
    ups = _updates(96, 48, 8, seed=71)
    eng1 = _ols_engine(plan=wl, trigger_cache=cache)
    eng1.initialize(_inputs("ols"))
    eng1.apply_update("X", *ups[0])
    eng1.apply_updates("X", ups, block=True)
    misses = cache.misses
    assert misses > 0
    eng2 = _ols_engine(plan=wl, trigger_cache=cache)
    eng2.initialize(_inputs("ols", seed=1))
    eng2.apply_update("X", *ups[0])
    eng2.apply_updates("X", ups, block=True)
    assert cache.misses == misses == len(cache)
    assert cache.hits > 0
    assert eng2._trigger_fns["X"] is eng1._trigger_fns["X"]
    assert (eng2._planned_trigger_fn("X", 8)
            is eng1._planned_trigger_fn("X", 8))
    # the key carries the device: a CPU engine's entries are its own
    assert eng1._cache_key(())[1:3] == ("cpu", None)
    # different sizes -> different fingerprint -> no false sharing
    eng3 = IncrementalEngine(torch_ols(64, 32, 1), plan=wl,
                             trigger_cache=cache, device="cpu")
    eng3.initialize({"X": np.ones((64, 32), np.float32) + np.eye(
        64, 32, dtype=np.float32), "Y": np.ones((64, 1), np.float32)})
    eng3.apply_update("X", *_updates(64, 32, 1, seed=3)[0])
    assert cache.misses > misses


# -- adaptive re-planning -----------------------------------------------------


def test_adaptive_planner_replans_on_drift():
    planner = AdaptivePlanner(WorkloadDescriptor(batch_size=1),
                              replan_every=4)
    eng = _ols_engine(plan=planner, trigger_cache=TriggerCache())
    eng.initialize(_inputs("ols"))
    assert all(vp.strategy == "incremental"
               for vp in eng.plan.views.values())
    streams = [_updates(96, 48, 1, seed=80 + i) for i in range(4)]
    for ups in streams:
        eng.apply_updates("X", ups)
    assert eng.stats.replans == 0
    drift = [_updates(96, 48, 160, seed=90 + i) for i in range(8)]
    for ups in drift:
        eng.apply_updates("X", ups)
    assert eng.stats.replans >= 1
    assert any(vp.strategy != "incremental"
               for vp in eng.plan.views.values())
    eng.refresh()
    ree = _ols_reeval([uv for ups in streams + drift for uv in ups])
    assert _rel(eng.views["beta"].numpy(),
                ree.views["beta"].numpy()) <= 5e-3


def test_adaptive_planner_observes_per_update_path():
    planner = AdaptivePlanner(WorkloadDescriptor(batch_size=100000),
                              replan_every=4)
    eng = _ols_engine(plan=planner, trigger_cache=TriggerCache())
    eng.initialize(_inputs("ols"))
    assert all(vp.strategy == "reeval" for vp in eng.plan.views.values())
    for u, v in _updates(96, 48, 8, seed=83):
        eng.apply_update("X", u, v)
    assert eng.stats.replans >= 1
    assert any(vp.strategy == "incremental"
               for vp in eng.plan.views.values())


def test_set_plan_syncs_adaptive_planner():
    planner = AdaptivePlanner(WorkloadDescriptor(batch_size=1))
    eng = _ols_engine(plan=planner, trigger_cache=TriggerCache())
    swapped = plan_for_engine(eng, WorkloadDescriptor(batch_size=100000))
    eng.set_plan(swapped)
    assert planner.plan is swapped
    assert planner.workload == swapped.workload


def test_adaptive_planner_binding_guard():
    planner = AdaptivePlanner(WorkloadDescriptor())
    _ols_engine(plan=planner)
    with pytest.raises(ValueError):
        IncrementalEngine(torch_ols(64, 32, 1), plan=planner, device="cpu")


# -- the carrier path under a plan ---------------------------------------------


@pytest.mark.parametrize("plan_kind", ["incremental", "reeval"])
def test_rowlocal_carrier_under_plan(plan_kind):
    """A row-local carrier stays on the row kernel under an incremental
    plan; under a re-evaluating plan it goes to the planned dense
    firing (widened), and both stay exact."""
    from repro_torch.data import row_local_stream
    _, tprog = _programs("chain")
    _, tp = _plans("chain", plan_kind)
    eng = IncrementalEngine(tprog, {"X": 2}, plan=tp,
                            trigger_cache=TriggerCache(), device="cpu")
    ree = ReevalEngine(tprog, device="cpu")
    for e in (eng, ree):
        e.initialize(_inputs("chain"))
    stream = row_local_stream(64, 3, m=12, rank=2, seed=5)
    carriers = [stream.next_carrier() for _ in range(3)]
    for c in carriers:
        eng.apply_update("X", c)
        ree.apply_update("X", *c.factors())
    if plan_kind == "incremental":
        assert eng.stats.rowlocal_firings == 3
        assert eng.stats.row_applies == 3 * 3
        assert eng.stats.widened_carriers == eng.stats.plan_reevals == 0
        assert eng._accum_rank == {"X": 6, "Y1": 6, "Y2": 6}
    else:
        assert eng.stats.rowlocal_firings == eng.stats.row_applies == 0
        assert eng.stats.widened_carriers == 3
        assert eng.stats.plan_reevals == 3 * 2
        assert eng.stats.lowrank_applies == 3  # X's own apply
    _assert_views(eng.views, ree.views, f"carriers under {plan_kind} plan")


# -- serving hot-swap contract ------------------------------------------------


def test_logit_view_replan_keeps_staleness_contract(rng):
    from repro_torch.serve import IncrementalLogitView
    H = rng.normal(size=(40, 16)).astype(np.float32)
    W = rng.normal(size=(10, 16)).astype(np.float32)
    view = IncrementalLogitView(H, W, flush_size=3, flush_age=1e9,
                                device="cpu")
    ups = [(0.05 * rng.normal(size=(10, 1)).astype(np.float32),
            0.05 * rng.normal(size=(16, 1)).astype(np.float32))
           for _ in range(3)]
    assert not view.submit_head_update(*ups[0])
    assert not view.submit_head_update(*ups[1])
    assert view.pending_updates == 2
    plan = view.replan(WorkloadDescriptor(batch_size=2))
    assert view.engine.plan is plan
    assert view.pending_updates == 2
    assert view.submit_head_update(*ups[2])
    assert view.pending_updates == 0
    W_new = W + sum(u @ v.T for u, v in ups)
    assert _rel(view.logits.numpy(), H @ W_new.T) <= TOL


def test_serve_engine_replan_views(rng):
    from repro_torch.serve import IncrementalLogitView
    from repro_torch.serve.engine import ServeEngine

    class _Stub(ServeEngine):  # no LM needed for a plan test
        def __init__(self):
            self._logit_views = {}

    eng = _Stub()
    H = rng.normal(size=(24, 8)).astype(np.float32)
    W = rng.normal(size=(6, 8)).astype(np.float32)
    eng._logit_views["lm_head"] = IncrementalLogitView(
        H, W, flush_size=8, flush_age=1e9, device="cpu")
    eng._logit_views["lm_head"].submit_head_update(
        0.1 * rng.normal(size=(6, 1)).astype(np.float32),
        0.1 * rng.normal(size=(8, 1)).astype(np.float32))
    plans = eng.replan_views(WorkloadDescriptor(batch_size=4))
    assert set(plans) == {"lm_head"}
    assert eng._logit_views["lm_head"].pending_updates == 1
    assert eng._logit_views["lm_head"].engine.plan is plans["lm_head"]
