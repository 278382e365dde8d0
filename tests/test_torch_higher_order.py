"""The port's higher-order deferred cascade against the JAX package's.

Mirrors ``tests/test_higher_order.py`` case for case as a differential:
the same numpy inputs and update streams go through
``repro.core.IncrementalEngine(order=k)`` and
``repro_torch.core.IncrementalEngine(order=k, device="cpu")``; their
views must agree within 1e-5 (scale-normalized), their fold counters
exactly, and the port's views must match its own re-evaluation engine
within the reference's tolerances (1e-6 scale-normalized for the
polynomial families, 2e-3 for OLS through a float32 inverse).  On top,
the port's own design is held: an engine with a deferred view writes out
of place, so a window's base snapshot is never moved — pinned by a
mixed-depth engine (only the output view deferred) — same-order replays
are bit for bit, and a firing that only banks launches nothing.

The property suite runs under REPRO_CHAOS_SEEDS (comma-separated;
default "0"), as the reference's does.
"""

import os
import threading
from dataclasses import replace

import numpy as np
import pytest

import repro.apps as japps
import repro.core as jcore
import repro.plan as jplan
import repro_torch.apps as tapps
import repro_torch.core as tcore
from repro.data import row_local_stream as jax_row_stream
from repro_torch.core import (IncrementalEngine, IncrementalInverseError,
                              ReevalEngine, compile_delta_trigger,
                              compile_program, delta_view_name, max_abs_diff)
from repro_torch.core.cost import shape_of
from repro_torch.data import row_local_stream
from repro_torch.plan import (AdaptivePlanner, TriggerCache,
                              WorkloadDescriptor, plan_program)

CHAOS_SEEDS = [int(s) for s in
               os.environ.get("REPRO_CHAOS_SEEDS", "0").split(",")]

CPU = {"device": "cpu"}
# port against the JAX engine, scale-normalized
PARITY = 1e-5

# family → ((program factory, args[, kwargs]), updatable inputs,
#           per-input init scale, scale-normalized tolerance against
#           re-evaluation)
FAMILIES = {
    "powers_exp": (("build_powers_program", (4, 12)), ("A",),
                   {"A": 0.25}, 1e-6),
    "sums_powers": (("build_sums_program", (4, 10)), ("A",),
                    {"A": 0.25}, 1e-6),
    "general_form": (("build_general_program", (4, 10, 6)), ("A", "B"),
                     {"A": 0.25, "B": 0.3, "T0": 0.3}, 1e-6),
    "pagerank": (("build_pagerank_program", (10,), {"k": 4}), ("M",),
                 {"M": 0.15}, 1e-6),
    "bgd": (("build_bgd_program", (16, 6, 1), {"k": 4}), ("X",),
            {"X": 0.5, "Y": 1.0, "Theta0": 0.1}, 1e-6),
    "ols": (("build_ols_program", (24, 6, 1)), ("X",),
            {"X": 1.0, "Y": 1.0}, 2e-3),
}


def _programs(family):
    """(JAX program, port program) of one family."""
    name, args, *kw = FAMILIES[family][0]
    kw = kw[0] if kw else {}
    return (getattr(japps, name)(*args, **kw),
            getattr(tapps, name)(*args, **kw))


def _gen_inputs(prog, rng, scales):
    out = {}
    for name, v in prog.inputs.items():
        n, m = shape_of(v, dict(prog.dims))
        out[name] = (rng.standard_normal((n, m))
                     * scales.get(name, 0.3)).astype(np.float32)
    return out


def _ragged_stream(rng, shape, T):
    """T mixed-rank factored updates for one (n, m) input."""
    n, m = shape
    ups = []
    for _ in range(T):
        k = int(rng.integers(1, 3))
        ups.append(((rng.standard_normal((n, k)) * 0.02).astype(np.float32),
                    (rng.standard_normal((m, k)) * 0.02).astype(np.float32)))
    return ups


def _np(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(
        x, np.ndarray) else np.asarray(x)


def _rel(got, want):
    got = np.asarray(_np(got), np.float64)
    want = np.asarray(_np(want), np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _assert_views(got, want, names, tol, label=""):
    for name in names:
        r = _rel(got[name], want[name])
        assert r <= tol, f"{label}{name}: {r:.3e} > {tol}"


def _stmts(prog):
    return [st.target.name for st in prog.statements]


FOLD_COUNTERS = ("folds", "fold_sweeps", "fold_reevals", "fold_aborts",
                 "updates_applied", "triggers_fired", "recompressions")


def _assert_counters(te, je):
    for k in FOLD_COUNTERS:
        assert getattr(te.stats, k) == getattr(je.stats, k), k


# ---------------------------------------------------------------------------
# the property suite: every app family × depth 1/2/3 × chaos-seed matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_depth_k_views_match_jax_and_reevaluation(family, depth, seed,
                                                  case):
    _, upd_inputs, scales, tol = FAMILIES[family]
    jprog, tprog = _programs(family)
    fold_window = 2 + case
    rng = np.random.default_rng((seed << 20) ^ (7919 * (case + 1)))
    inputs = _gen_inputs(tprog, rng, scales)
    te = IncrementalEngine(tprog, order=depth, fold_window=fold_window,
                           **CPU)
    je = jcore.IncrementalEngine(jprog, order=depth,
                                 fold_window=fold_window)
    ref = ReevalEngine(tprog, **CPU)
    for e in (te, je, ref):
        e.initialize(inputs)
    assert te._view_orders == je._view_orders
    if depth >= 2:
        assert te._deferred, "depth >= 2 must defer some view"
        assert te._out_of_place, "a deferred engine writes out of place"
    shapes = {n: a.shape for n, a in inputs.items()}
    for _ in range(7):
        name = upd_inputs[int(rng.integers(len(upd_inputs)))]
        ups = _ragged_stream(rng, shapes[name], T=int(rng.integers(1, 4)))
        te.apply_updates(name, ups)
        je.apply_updates(name, ups)
        for u, v in ups:
            ref.apply_update(name, u, v)
    te.flush()   # the read barrier: folds every pending window
    je.flush()
    assert not te._cascade_pending()
    names = _stmts(tprog)
    _assert_views(te.views, je.views, names, PARITY,
                  f"{family}@d{depth} port vs JAX: ")
    _assert_views(te.views, ref.views, names, tol,
                  f"{family}@d{depth} port vs reeval: ")
    _assert_counters(te, je)
    if depth >= 2:
        assert te.stats.folds > 0


def test_reads_interleaved_with_stream_stay_exact():
    """output() mid-stream folds every tier and serves exact values."""
    jprog, tprog = _programs("sums_powers")
    rng = np.random.default_rng(3)
    inputs = _gen_inputs(tprog, rng, {"A": 0.25})
    te = IncrementalEngine(tprog, order=3, fold_window=3, **CPU)
    je = jcore.IncrementalEngine(jprog, order=3, fold_window=3)
    ref = ReevalEngine(tprog, **CPU)
    for e in (te, je, ref):
        e.initialize(inputs)
    out = tprog.output_names()[0]
    for i in range(10):
        ups = _ragged_stream(rng, (10, 10), T=1)
        for e in (te, je):
            e.apply_updates("A", ups)
        ref.apply_update("A", *ups[0])
        if i % 4 == 1:  # read mid-window
            got = te.output(out)
            assert _rel(got, ref.views[out]) <= 1e-6
            assert _rel(got, je.output(out)) <= PARITY
    assert te.stats.reads >= 2
    _assert_counters(te, je)


# ---------------------------------------------------------------------------
# the symbolic Δᵏ hierarchy and the Δᵈ views
# ---------------------------------------------------------------------------


def test_delta_view_registration_and_names():
    jprog, tprog = _programs("general_form")
    c = compile_program(tprog, order=2)
    jc = jcore.compile_program(jprog, order=2)
    assert c.order == 2
    assert delta_view_name("P2", 2) == "__d2__P2"
    reg = c.delta_views[("A", 2)]
    assert reg, "Δ² of the A-chain must register auxiliary views"
    assert sorted(reg) == sorted(jc.delta_views[("A", 2)])
    for name, dv in reg.items():
        jdv = jc.delta_views[("A", 2)][name]
        assert dv.view == name
        assert dv.name == delta_view_name(name, 2) == jdv.name
        assert dv.depth == 2 and dv.input_name == "A"
        assert dv.kind == jdv.kind and dv.kind in ("lowrank", "dense")
        assert dv.flops == pytest.approx(jdv.flops) and dv.flops >= 0.0
    c1 = compile_program(tprog)
    assert c1.order == 1 and not c1.delta_views


def test_delta_hierarchy_terminates_at_degree():
    """Δ^(d+1) ≡ 0 for a degree-d polynomial: matrix powers at k = 4."""
    c = compile_program(tapps.build_powers_program(4, 8), order=5)
    assert c.delta_views[("A", 2)]
    assert c.delta_views[("A", 4)]
    assert not c.delta_views.get(("A", 5))


def test_inverse_unsupported_at_depth_two():
    c = compile_program(tapps.build_ols_program(20, 6, 1), order=2)
    assert "Z" in c.delta_views[("X", 2)]
    assert set(c.delta_unsupported[("X", 2)]) == {"W", "beta"}
    with pytest.raises(IncrementalInverseError):
        compile_delta_trigger(c, "X", 2)


def test_delta2_trigger_matches_second_difference():
    """The Δ² trigger against Δ²E(A; d, d) = E(A+2d) − 2E(A+d) + E(A),
    and against the JAX engine's Δ² trigger on the same inputs."""
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((8, 8)) * 0.3).astype(np.float32)
    u = (rng.standard_normal((8, 1)) * 0.2).astype(np.float32)
    v = (rng.standard_normal((8, 1)) * 0.2).astype(np.float32)
    eng = IncrementalEngine(tapps.build_powers_program(2, 8), order=2,
                            **CPU)
    eng.initialize({"A": A})
    assert eng.materialize_delta_views("A", 2) == ("__d2__P2",)
    before = dict(eng.views)
    out = eng.delta_trigger_fn("A", 2)(dict(eng.views), u, v)
    # out of place: the engine's store is untouched
    assert all(eng.views[k] is t for k, t in before.items())
    assert not eng.views["__d2__P2"].any()
    d = u @ v.T
    expected = (A + 2 * d) @ (A + 2 * d) - 2 * (A + d) @ (A + d) + A @ A
    np.testing.assert_allclose(out["__d2__P2"].numpy(), expected,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(expected, 2 * d @ d, rtol=1e-4, atol=1e-5)
    je = jcore.IncrementalEngine(japps.build_powers_program(2, 8), order=2)
    je.initialize({"A": A})
    je.materialize_delta_views("A", 2)
    jout = je.delta_trigger_fn("A", 2)(dict(je.views), u, v)
    assert _rel(out["__d2__P2"], jout["__d2__P2"]) <= PARITY


# ---------------------------------------------------------------------------
# the trigger cache carries the order
# ---------------------------------------------------------------------------


def test_trigger_cache_namespace_carries_order():
    prog = tapps.build_powers_program(4, 12)
    cache = TriggerCache(capacity=64)
    e1 = IncrementalEngine(prog, trigger_cache=cache, **CPU)
    e2 = IncrementalEngine(prog, order=2, fold_window=2,
                           trigger_cache=cache, **CPU)
    tail = ("trigger", "A", 1)
    assert e1._cache_key(tail) != e2._cache_key(tail)
    e3 = IncrementalEngine(prog, order=3, fold_window=2,
                           trigger_cache=cache, **CPU)
    assert e3._cache_key(tail) not in (e1._cache_key(tail),
                                       e2._cache_key(tail))
    rng = np.random.default_rng(0)
    e3.initialize({"A": (rng.standard_normal((12, 12)) * 0.25
                         ).astype(np.float32)})
    f2 = e3.delta_trigger_fn("A", 2)
    f3 = e3.delta_trigger_fn("A", 3)
    assert f2 is not f3
    assert e3.delta_trigger_fn("A", 2) is f2
    assert ("delta", "A", 2, 1) == e3._cache_key(("delta", "A", 2, 1))[-4:]
    assert e3._cache_key(("delta", "A", 2, 1)) in cache


def test_trigger_cache_concurrent_cross_order_engines():
    """Same-program engines at different orders share one cache and are
    driven concurrently; each ends bit for bit equal to an isolated
    engine of its own order."""
    prog = tapps.build_sums_program(4, 10)
    rng = np.random.default_rng(7)
    inputs = _gen_inputs(prog, rng, {"A": 0.25})
    stream = [_ragged_stream(rng, (10, 10), T=2) for _ in range(6)]
    cache = TriggerCache(capacity=64)
    orders = [None, 2]
    shared = [IncrementalEngine(prog, order=o, fold_window=2,
                                trigger_cache=cache, **CPU) for o in orders]
    isolated = [IncrementalEngine(prog, order=o, fold_window=2, **CPU)
                for o in orders]
    for e in shared + isolated:
        e.initialize(inputs)
    errors = []

    def drive(eng):
        try:
            for ups in stream:
                eng.apply_updates("A", ups)
            eng.flush()
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=drive, args=(e,)) for e in shared]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for e in isolated:
        drive(e)
    for e_shared, e_iso in zip(shared, isolated):
        assert max_abs_diff(e_shared.views, e_iso.views) == 0.0
    assert cache.stats()["entries"] >= 2  # one namespace per order


# ---------------------------------------------------------------------------
# plans with depth
# ---------------------------------------------------------------------------


def _deep_plans(n=12):
    """The same all-incremental depth-2 plan for both packages."""
    tprog = tapps.build_powers_program(4, n)
    base = plan_program(compile_program(tprog),
                        WorkloadDescriptor(update_rank=1))
    deep = replace(base, views={k: replace(vp, strategy="incremental",
                                           threshold_rank=None,
                                           materialize=True, order=2)
                                for k, vp in base.views.items()})
    return deep, jplan.MaintenancePlan.from_json(deep.to_json())


def test_engine_adopts_plan_depth_and_stays_exact():
    deep, jdeep = _deep_plans()
    rng = np.random.default_rng(11)
    tprog = tapps.build_powers_program(4, 12)
    inputs = _gen_inputs(tprog, rng, {"A": 0.25})
    te = IncrementalEngine(tprog, plan=deep, fold_window=3,
                           trigger_cache=TriggerCache(), **CPU)
    je = jcore.IncrementalEngine(japps.build_powers_program(4, 12),
                                 plan=jdeep, fold_window=3,
                                 trigger_cache=jplan.TriggerCache())
    ref = ReevalEngine(tprog, **CPU)
    for e in (te, je, ref):
        e.initialize(inputs)
    assert set(te._deferred) == set(deep.views)
    assert te._view_orders == je._view_orders
    for _ in range(8):
        ups = _ragged_stream(rng, (12, 12), T=2)
        te.apply_updates("A", ups)
        je.apply_updates("A", ups)
        for u, v in ups:
            ref.apply_update("A", u, v)
    te.flush()
    je.flush()
    names = _stmts(tprog)
    _assert_views(te.views, ref.views, names, 1e-6, "planned-d2: ")
    _assert_views(te.views, je.views, names, PARITY, "port vs JAX: ")
    _assert_counters(te, je)
    assert te.stats.folds > 0


def test_engine_rejects_lazy_plus_deferred_plan():
    deep, _ = _deep_plans()
    names = sorted(deep.views)
    bad = replace(deep, views={**deep.views, names[0]: replace(
        deep.views[names[0]], materialize=False, order=1)})
    with pytest.raises(ValueError, match="materialize"):
        IncrementalEngine(tapps.build_powers_program(4, 12), plan=bad, **CPU)


def test_engine_adaptive_depth_hot_swap_stays_exact():
    """Sparse reads observed online tip the adaptive planner into a depth
    plan; the engine hot-swaps it mid-stream (folding the old windows
    first) and keeps serving exact reads, as the JAX engine does."""
    tprog = tapps.build_powers_program(4, 12)
    wl = dict(update_rank=1, max_order=2, fold_window=4)
    te = IncrementalEngine(
        tprog, {"A": 4},
        plan=AdaptivePlanner(WorkloadDescriptor(**wl), replan_every=6,
                             drift_tol=0.2),
        fold_window=4, trigger_cache=TriggerCache(), **CPU)
    je = jcore.IncrementalEngine(
        japps.build_powers_program(4, 12), {"A": 4},
        plan=jplan.AdaptivePlanner(jplan.WorkloadDescriptor(**wl),
                                   replan_every=6, drift_tol=0.2),
        fold_window=4, trigger_cache=jplan.TriggerCache())
    ref = ReevalEngine(tprog, **CPU)
    rng = np.random.default_rng(13)
    inputs = _gen_inputs(tprog, rng, {"A": 0.25})
    for e in (te, je, ref):
        e.initialize(inputs)
    for _ in range(20):
        ups = [_ragged_stream(rng, (12, 12), T=1)[0] for _ in range(4)]
        ups = [(np.hstack([u for u, _ in ups]),
                np.hstack([v for _, v in ups]))]
        te.apply_updates("A", ups)
        je.apply_updates("A", ups)
        for u, v in ups:
            ref.apply_update("A", u, v)
    assert any(o >= 2 for o in te._view_orders.values()), \
        "sparse-read workload past the crossover must adopt depth"
    assert te._view_orders == je._view_orders
    assert te._out_of_place
    out = tprog.output_names()[0]
    assert _rel(te.output(out), ref.views[out]) <= 1e-6
    assert _rel(te.output(out), je.output(out)) <= PARITY
    assert te.stats.replans == je.stats.replans > 0


# ---------------------------------------------------------------------------
# carriers × order 2
# ---------------------------------------------------------------------------


def _carrier_chain_prog(core, n=48, m=24, k=12):
    p = core.Program(name="ho_carrier_chain")
    X = p.input("X", (core.dim("N"), core.dim("M")))
    W1 = p.input("W1", (core.dim("M"), core.dim("K")))
    Y1 = p.let("Y1", core.matmul(X, W1))
    p.let("Y2", core.matmul(Y1, p.input("W2", (core.dim("K"),
                                                core.dim("K")))))
    p.outputs = ["Y1", "Y2"]
    return p.bind_dims(N=n, M=m, K=k)


def _carrier_chain_inputs(seed, n=48, m=24, k=12):
    rng = np.random.default_rng(seed)
    return {"X": rng.standard_normal((n, m)).astype(np.float32) * 0.3,
            "W1": rng.standard_normal((m, k)).astype(np.float32) * 0.3,
            "W2": rng.standard_normal((k, k)).astype(np.float32) * 0.3}


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_rowlocal_carriers_through_order2_engine(seed):
    """At depth >= 2 a row-local carrier widens into the banked window
    (no row-local path), on the engine's device; it folds exact."""
    inputs = _carrier_chain_inputs(seed)
    tprog = _carrier_chain_prog(tcore)
    lazy = IncrementalEngine(tprog, {"X": 4}, order=2, fold_window=3, **CPU)
    eager = IncrementalEngine(tprog, {"X": 4}, **CPU)
    ref = ReevalEngine(tprog, **CPU)
    je = jcore.IncrementalEngine(_carrier_chain_prog(jcore), {"X": 4},
                                 order=2, fold_window=3)
    for e in (lazy, eager, ref, je):
        e.initialize(dict(inputs))
    stream = row_local_stream(48, 3, m=24, rank=2, seed=seed + 1)
    jstream = jax_row_stream(48, 3, m=24, rank=2, seed=seed + 1)
    for _ in range(10):
        c, jc = stream.next_carrier(), jstream.next_carrier()
        lazy.apply_update("X", c)
        eager.apply_update("X", c)
        je.apply_update("X", jc)
        ref.apply_update("X", *c.factors())
    lazy.output()
    je.output()
    assert eager.stats.rowlocal_firings == 10
    assert lazy.stats.rowlocal_firings == 0
    assert lazy.stats.folds > 0
    _assert_views(lazy.views, ref.views, ("Y1", "Y2"), 1e-5, "lazy: ")
    _assert_views(lazy.views, je.views, ("Y1", "Y2"), PARITY, "vs JAX: ")
    _assert_counters(lazy, je)


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_noop_carriers_through_order2_engine(seed):
    from repro_torch.core import NoOpCarrier
    lazy = IncrementalEngine(_carrier_chain_prog(tcore), {"X": 4}, order=2,
                             fold_window=3, **CPU)
    lazy.initialize(_carrier_chain_inputs(seed))
    before = {k: v.clone() for k, v in lazy.views.items()}
    for _ in range(7):
        lazy.apply_update("X", NoOpCarrier(48, 24))
    lazy.output()
    assert lazy.stats.noop_skips == 7
    assert lazy.stats.folds == 0 and not lazy._cascade_pending()
    for name in ("Y1", "Y2"):
        assert bool((lazy.views[name] == before[name]).all())


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_mixed_carriers_and_dense_through_order2(seed):
    """Interleaved row-local / low-rank / dense / no-op updates through a
    depth-2 window fold to the re-evaluation answer and the JAX
    engine's."""
    from repro_torch.core import LowRankCarrier, NoOpCarrier
    rng = np.random.default_rng(seed + 5)
    inputs = _carrier_chain_inputs(seed)
    tprog = _carrier_chain_prog(tcore)
    lazy = IncrementalEngine(tprog, {"X": 4}, order=2, fold_window=2, **CPU)
    je = jcore.IncrementalEngine(_carrier_chain_prog(jcore), {"X": 4},
                                 order=2, fold_window=2)
    ref = ReevalEngine(tprog, **CPU)
    for e in (lazy, je, ref):
        e.initialize(dict(inputs))
    stream = row_local_stream(48, 2, m=24, rank=2, seed=seed)
    jstream = jax_row_stream(48, 2, m=24, rank=2, seed=seed)
    for step in range(12):
        kind = step % 4
        if kind == 0:
            c, jc = stream.next_carrier(), jstream.next_carrier()
            lazy.apply_update("X", c)
            je.apply_update("X", jc)
            ref.apply_update("X", *c.factors())
        elif kind == 1:
            P = (rng.standard_normal((48, 2)) * 0.1).astype(np.float32)
            Q = (rng.standard_normal((24, 2)) * 0.1).astype(np.float32)
            lazy.apply_update("X", LowRankCarrier(P, Q))
            je.apply_update("X", jcore.LowRankCarrier(P, Q))
            ref.apply_update("X", P, Q)
        elif kind == 2:
            u = (rng.standard_normal((48, 4)) * 0.1).astype(np.float32)
            v = (rng.standard_normal((24, 4)) * 0.1).astype(np.float32)
            lazy.apply_update("X", u, v)
            je.apply_update("X", u, v)
            ref.apply_update("X", u, v)
        else:
            lazy.apply_update("X", NoOpCarrier(48, 24))
            je.apply_update("X", jcore.NoOpCarrier(48, 24))
    lazy.output()
    je.output()
    _assert_views(lazy.views, ref.views, ("Y1", "Y2"), 1e-5, "lazy: ")
    _assert_views(lazy.views, je.views, ("Y1", "Y2"), PARITY, "vs JAX: ")
    assert lazy.stats.folds > 0 and lazy.stats.noop_skips == 3
    _assert_counters(lazy, je)


# ---------------------------------------------------------------------------
# the port's own design: out-of-place windows, bit-for-bit replays, launches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_mixed_depth_base_snapshot_is_never_moved(seed):
    """Only the output view at depth 2, its producers at depth 1: every
    firing writes the producers, which the window base also holds.  Out
    of place, the base keeps the window-start tensors untouched, the
    fold sweeps from them, and the result matches the JAX engine, the
    re-evaluation engine, and a same-order replay bit for bit."""
    jprog, tprog = _programs("powers_exp")
    out = tprog.output_names()[0]
    rng = np.random.default_rng(seed + 40)
    inputs = _gen_inputs(tprog, rng, {"A": 0.25})
    engines = [IncrementalEngine(tprog, order={out: 2}, fold_window=4,
                                 **CPU) for _ in range(2)]
    je = jcore.IncrementalEngine(jprog, order={out: 2}, fold_window=4)
    ref = ReevalEngine(tprog, **CPU)
    for e in (*engines, je, ref):
        e.initialize(inputs)
    eng = engines[0]
    assert eng._deferred == {out}
    assert all(o == 1 for n, o in eng._view_orders.items() if n != out)
    assert eng._view_orders == je._view_orders
    base = eng._tier_base[2]
    saved = {k: t.clone() for k, t in base.items()}
    stream = [_ragged_stream(rng, (12, 12), T=2) for _ in range(3)]
    for ups in stream:
        for e in (*engines, je):
            e.apply_updates("A", ups)
        for u, v in ups:
            ref.apply_update("A", u, v)
    # mid-window: the producers moved, the base did not
    assert eng._tier_base[2] is base
    for k, t in base.items():
        assert bool((t == saved[k]).all()), f"base view {k} was moved"
    assert any(eng.views[k] is not base[k] for k in base)
    ups = _ragged_stream(rng, (12, 12), T=2)
    for e in (*engines, je):
        e.apply_updates("A", ups)   # the window's 4th firing folds it
    for u, v in ups:
        ref.apply_update("A", u, v)
    assert eng.stats.folds == je.stats.folds == 1
    assert eng.stats.fold_sweeps == 1
    names = _stmts(tprog)
    _assert_views(eng.views, ref.views, names, 1e-6, "mixed: ")
    _assert_views(eng.views, je.views, names, PARITY, "vs JAX: ")
    assert max_abs_diff(engines[0].views, engines[1].views) == 0.0
    _assert_counters(eng, je)


def test_banking_launches_nothing_and_a_fold_counts_its_applies():
    """A firing that only banks applies nothing; a fold applies the dense
    kernel once per banked input and once per low-rank apply of its
    sweep, which is the firing's own trigger fn (the input's apply
    included, its result discarded, as the reference's fold does)."""
    tprog = tapps.build_powers_program(4, 48)
    rng = np.random.default_rng(5)
    inputs = _gen_inputs(tprog, rng, {"A": 0.05})
    eng = IncrementalEngine(tprog, order=2, fold_window=4, **CPU)
    eng.initialize(inputs)
    views = dict(eng.views)
    one = [((rng.standard_normal((48, 1)) * 0.02).astype(np.float32),
            (rng.standard_normal((48, 1)) * 0.02).astype(np.float32))
           for _ in range(4)]
    for u, v in one[:3]:
        eng.apply_update("A", u, v)
    assert eng.stats.lowrank_applies == 0
    assert all(eng.views[k] is t for k, t in views.items())
    assert sum(len(p) for p in eng._pending_input.values()) == 3
    eng.apply_update("A", *one[3])
    assert eng.stats.folds == 1
    assert eng.stats.fold_sweeps == len(_stmts(tprog))
    sweep = eng._planned_trigger_fn("A", 4)
    assert sweep.lowrank_applies == len(_stmts(tprog)) + 1
    assert eng.stats.lowrank_applies == 1 + sweep.lowrank_applies
    assert not any(eng._pending_input.values())


def test_snapshot_restores_banked_inputs():
    """A rolled-back firing of an unguarded deferred engine (a fleet
    claim that crashed) restores its banked input factors too: replaying
    it banks the updates once, and the engine ends bit for bit equal to
    one that never rolled back."""
    from repro_torch.guard.txn import restore_snapshot, take_snapshot
    tprog = tapps.build_powers_program(4, 12)
    rng = np.random.default_rng(9)
    inputs = _gen_inputs(tprog, rng, {"A": 0.25})
    eng, clean = (IncrementalEngine(tprog, order=2, fold_window=4, **CPU)
                  for _ in range(2))
    for e in (eng, clean):
        e.initialize(inputs)
    stream = [_ragged_stream(rng, (12, 12), T=2) for _ in range(6)]
    snap = take_snapshot(eng)
    eng.apply_updates("A", stream[0])
    restore_snapshot(eng, snap)
    assert not any(eng._pending_input.values())
    for ups in stream:
        for e in (eng, clean):
            e.apply_updates("A", ups)
    for e in (eng, clean):
        e.flush()
    assert eng.stats.folds == clean.stats.folds > 0
    assert max_abs_diff(eng.views, clean.views) == 0.0


def test_recompressed_tier3_window_sweeps_its_own_factors():
    """Tiers 2 and 3 under single rank-8 updates at the default rank cap
    of 64: at the 9th firing the tier-3 window (rank 72) is re-compressed
    to one entry, and the banked inputs hold one pair (tier 2 folded at
    the 8th).  Equal length is then no proof of equal content: a read
    must sweep tier 3 with its whole window, not with the 9th firing's
    factors alone, and match re-evaluation."""
    tprog = tapps.build_powers_program(16, 48)
    rng = np.random.default_rng(23)
    inputs = _gen_inputs(tprog, rng, {"A": 0.2})
    order = {"P2": 2, "P4": 2, "P8": 2, "P16": 3}
    eng = IncrementalEngine(tprog, order=order, fold_window=4, **CPU)
    ref = ReevalEngine(tprog, **CPU)
    for e in (eng, ref):
        e.initialize(inputs)
    for _ in range(9):
        u = (rng.standard_normal((48, 8)) * 0.02).astype(np.float32)
        v = (rng.standard_normal((48, 8)) * 0.02).astype(np.float32)
        eng.apply_update("A", u, v)
        ref.apply_update("A", u, v)
    assert eng.stats.recompressions >= 1
    assert len(eng._tier_factors[3]["A"]) == 1
    assert sum(len(p) for p in eng._pending_input.values()) == 1
    eng.output()
    assert eng.stats.fold_sweeps > 0
    _assert_views(eng.views, ref.views, _stmts(tprog), 1e-6, "tier 3: ")
