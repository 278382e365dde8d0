"""The port's guard (``repro_torch.guard``) against the JAX package's.

The same numpy inputs, update streams and seeds go through ``repro.guard``
on the JAX engine and through ``repro_torch.guard`` on the port's engine
(on the CPU); their guard counters, chaos counters and quarantine records
must come out the same and their views agree to f32 parity.  On top of
the reference's own contracts the port's design is held: a guarded
firing writes out of place, so a rollback restores the very pre-firing
tensors; a row-local firing saves and restores its touched rows; and a
degraded serving snapshot is never moved by the live view's updates.

The chaos suite runs under REPRO_CHAOS_SEEDS (comma-separated; default
"0"), as the reference's does.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.guard as jg
import repro.plan as jplan
import repro_torch.core as tcore
import repro_torch.guard as tg
import repro_torch.plan as tplan
from repro.apps.matrix_powers import build_powers_program as jax_powers
from repro.apps.ols import build_ols_program as jax_ols
from repro.data.updates import UpdateStream
from repro_torch.apps.matrix_powers import build_powers_program as torch_powers
from repro_torch.apps.ols import build_ols_program as torch_ols
from repro_torch.kernels import ops, ref

CHAOS_SEEDS = [int(s) for s in
               os.environ.get("REPRO_CHAOS_SEEDS", "0").split(",")]

# f32 engine parity against the JAX engine, as max |a - b| over the view's
# largest entry (the port's engine tests' tolerance)
TOL = 1e-5


def _ols_inputs(m=96, n=12, p=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, n)).astype(np.float32)
    Y = rng.standard_normal((m, p)).astype(np.float32)
    return {"X": X, "Y": Y}


def _guard(pkg, validation=None, sentinel=None, **kw):
    """One package's GuardConfig from plain keyword dicts."""
    return pkg.GuardConfig(
        validation=pkg.ValidationPolicy(**(validation or {})),
        sentinel=pkg.SentinelConfig(**sentinel) if sentinel else None, **kw)


def _pair(family="ols", guard=None, chaos=None, plan=None, ranks=None):
    """(JAX engine, port engine) on one program, initialized alike.
    ``guard`` and ``chaos`` are keyword dicts for each package's config;
    ``plan="incremental"`` installs a static all-incremental plan on both
    (the guard's snapshot path)."""
    if family == "ols":
        progs = jax_ols(96, 12, 2), torch_ols(96, 12, 2)
        inputs = _ols_inputs()
    else:
        progs = (jax_powers(k=4, n=24, model="exp"),
                 torch_powers(k=4, n=24, model="exp"))
        rng = np.random.default_rng(0)
        a = rng.standard_normal((24, 24)).astype(np.float32)
        a *= 0.9 / max(abs(np.linalg.eigvals(a)))
        inputs = {"A": a}
    engines = []
    for pkg, core, prog, extra in ((jg, jcore, progs[0], {}),
                                   (tg, tcore, progs[1],
                                    {"device": "cpu"})):
        eng = core.IncrementalEngine(
            prog, ranks,
            guard=_guard(pkg, **guard) if guard is not None else None,
            chaos=pkg.ChaosConfig(**chaos) if chaos else None, **extra)
        if plan is not None:
            planner = jplan if pkg is jg else tplan
            eng.set_plan(planner.static_plan(eng, plan))
        eng.initialize(inputs)
        engines.append(eng)
    return engines


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() or 1.0)


def _same(je, te, tol=TOL):
    """Equal guard counters and quarantine records, views at parity."""
    js, ts = dataclasses.asdict(je.guard.stats), \
        dataclasses.asdict(te.guard.stats)
    assert ts.pop("max_drift") == pytest.approx(js.pop("max_drift"),
                                                rel=1e-3, abs=1e-6)
    assert ts == js
    assert [q.reason for q in te.guard.quarantine] == \
        [q.reason for q in je.guard.quarantine]
    for k in je.views:
        assert _rel(_np(te.views[k]), _np(je.views[k])) <= tol, k


def _snapshot(engine):
    return {k: _np(v).copy() for k, v in engine.views.items()}


def _reference_views(engine):
    """Re-evaluate every statement from the port engine's current inputs."""
    from repro_torch.core.codegen import evaluate
    env = {k: engine.views[k] for k in engine.program.inputs}
    for st in engine.program.statements:
        env[st.target.name] = evaluate(st.expr, env, engine.binding)
    return env


# ---------------------------------------------------------------------------
# layer 1: validation + quarantine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_validate_update_reasons(form):
    """The port's reasons equal the reference's, for numpy factors and for
    tensors (screened with torch where they live)."""
    as_in = (lambda x: torch.from_numpy(np.ascontiguousarray(x))) \
        if form == "tensor" else (lambda x: x)
    ok_u = np.ones((4, 1), np.float32)
    ok_v = np.ones((3, 1), np.float32)
    bad = ok_u.copy()
    bad[0] = np.nan
    cases = [(ok_u, ok_v, (4, 3)), (ok_u[:, 0], ok_v, (4, 3)),
             (ok_u, ok_v, (5, 3)), (np.ones((4, 2), np.float32), ok_v, (4, 3)),
             (ok_u.astype(np.int32), ok_v, (4, 3)),
             (np.ones((4, 3), np.float32), np.ones((3, 3), np.float32),
              (4, 3)),
             (bad, ok_v, (4, 3)), (100 * ok_u, 100 * ok_v, (4, 3))]
    reasons = []
    for u, v, shape in cases:
        want = jg.validate_update("X", u, v, shape, jg.ValidationPolicy(
            max_update_rank=2, max_norm=10.0))
        got = tg.validate_update("X", as_in(u), as_in(v), shape,
                                 tg.ValidationPolicy(max_update_rank=2,
                                                     max_norm=10.0))
        assert (got is None) == (want is None)
        if form == "numpy":
            assert got == want
        reasons.append(got)
    assert reasons[0] is None
    for i, word in enumerate(["2-D", "rows", "ranks disagree",
                              "floating point", "exceeds budget",
                              "non-finite", "norm bound"], start=1):
        assert word in reasons[i], (i, reasons[i])


def test_quarantine_never_corrupts_views():
    je, te = _pair(guard={})
    before = _snapshot(te)
    rng = np.random.default_rng(1)
    for kind in (np.nan, np.inf, -np.inf):
        u = rng.standard_normal((96, 1)).astype(np.float32)
        u[5] = kind
        v = rng.standard_normal((12, 1)).astype(np.float32)
        for eng in (je, te):
            eng.apply_update("X", u, v)
            assert eng.enqueue_update("X", u, v) is None
    for eng in (je, te):
        eng.guard.sync()  # resolve the deferred (device) screens
        assert len(eng.guard.quarantine) == 6
        assert eng.guard.stats.quarantined == 6
        assert len(eng.guard.quarantine.by_input("X")) == 6
        assert eng.guard.quarantine.reasons() == {
            "non-finite entries in update factors": 6}
    after = _snapshot(te)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])
    _same(je, te)


def test_quarantine_replay_after_repair():
    je, te = _pair(guard={})
    u = np.full((96, 1), np.nan, np.float32)
    v = np.ones((12, 1), np.float32) * 0.01
    out = []
    for eng in (je, te):
        eng.apply_update("X", u, v)
        eng.guard.sync()
        assert len(eng.guard.quarantine) == 1
        applied = eng.guard.quarantine.replay(
            eng, repair=lambda rec: (np.nan_to_num(rec.u), rec.v))
        assert applied == (1, 0)
        assert len(eng.guard.quarantine) == 0
        # replay without repair goes straight back to quarantine
        eng.apply_update("X", u, v)
        out.append(eng.guard.quarantine.replay(eng))
        assert len(eng.guard.quarantine) == 1
    assert out == [(0, 1), (0, 1)]
    _same(je, te)


def test_quarantine_capacity_evicts_oldest():
    je, te = _pair(guard={"quarantine_capacity": 3})
    u = np.full((96, 1), np.nan, np.float32)
    v = np.ones((12, 1), np.float32)
    for eng in (je, te):
        for _ in range(5):
            eng.apply_update("X", u, v)
        eng.guard.sync()
        assert len(eng.guard.quarantine) == 3
        assert eng.guard.quarantine.evicted == 2
    _same(je, te)


# ---------------------------------------------------------------------------
# layer 2: transactional firings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["fused", "snapshot"])
def test_injected_trigger_fault_rolls_back_bit_identically(path):
    je, te = _pair(guard={}, chaos={"seed": 0, "trigger_raise_p": 1.0},
                   plan="incremental" if path == "snapshot" else None)
    assert te._guard_fast_path == (path == "fused") == je._guard_fast_path
    rng = np.random.default_rng(2)
    u = rng.standard_normal((96, 1)).astype(np.float32) * 0.01
    v = rng.standard_normal((12, 1)).astype(np.float32) * 0.01
    for eng in (je, te):
        before_views = dict(eng.views)  # references: the same tensors
        before_stats = dataclasses.replace(eng.stats)
        out = eng.apply_update("X", u, v)
        for k, arr in before_views.items():
            assert out[k] is arr, f"{k}: rollback must restore the same buffer"
        assert eng.stats == before_stats
        assert eng.guard.stats.rollbacks == 1
        assert eng.guard.stats.aborted_firings == 1
        assert eng.chaos.raises == 1
        assert len(eng.guard.quarantine) == 1
    _same(je, te)


@pytest.mark.parametrize("path", ["fused", "snapshot"])
def test_nonfinite_output_rolls_back(path):
    """A finite-but-huge update passes admission, overflows f32 in the
    firing, and is caught by the output check and rolled back: by the
    kernel's flag and the select-commit on the fused path, by the output
    check and a dict swap on the snapshot path."""
    je, te = _pair(guard={},
                   plan="incremental" if path == "snapshot" else None)
    before = _snapshot(te)
    before_views = dict(te.views)
    u = np.full((96, 1), 1e38, np.float32)
    v = np.full((12, 1), 1.0, np.float32)
    assert tg.validate_update("X", u, v, (96, 12),
                              tg.ValidationPolicy()) is None  # admissible
    for eng in (je, te):
        eng.apply_update("X", u, v)
        eng.guard.sync()  # settle the deferred rollback accounting
        assert eng.guard.stats.rollbacks == 1
        assert "non-finite output" in list(eng.guard.quarantine)[0].reason
    after = _snapshot(te)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])
        assert np.isfinite(after[k]).all()
    if path == "snapshot":
        assert all(te.views[k] is t for k, t in before_views.items())
    _same(je, te)


def test_norm_budget_blocks_huge_updates_at_admission():
    je, te = _pair(guard={"validation": {"max_norm": 1e6}})
    for eng in (je, te):
        eng.apply_update("X", np.full((96, 1), 1e38, np.float32),
                         np.ones((12, 1), np.float32))
        assert eng.guard.stats.quarantined == 1
        assert eng.guard.stats.rollbacks == 0  # never reached the trigger
    _same(je, te)


@pytest.mark.parametrize("path", ["fused", "snapshot"])
def test_batched_firing_quarantines_only_poisoned(path):
    je, te = _pair(guard={},
                   plan="incremental" if path == "snapshot" else None)
    rng = np.random.default_rng(3)
    ups = [(rng.standard_normal((96, 1)).astype(np.float32) * 0.01,
            rng.standard_normal((12, 1)).astype(np.float32) * 0.01)
           for _ in range(6)]
    ups[2] = (np.full((96, 1), np.nan, np.float32), ups[2][1])
    for eng in (je, te):
        eng.apply_updates("X", ups)
        assert eng.guard.stats.quarantined == 1
        assert eng.guard.stats.admitted == 5
    assert all(np.isfinite(_np(a)).all() for a in te.views.values())
    ref_views = _reference_views(te)
    assert _rel(_np(te.views["beta"]), _np(ref_views["beta"])) <= 1e-4
    _same(je, te)


def test_clean_guarded_firing_writes_out_of_place():
    """A guarded engine's firing leaves every pre-firing tensor as it was
    and stores its views in new tensors: the rollback the snapshot holds
    is the old store itself."""
    for plan in (None, "incremental"):
        je, te = _pair(guard={}, plan=plan)
        old = dict(te.views)
        copies = {k: t.clone() for k, t in old.items()}
        rng = np.random.default_rng(8)
        ups = [(rng.standard_normal((96, 1)).astype(np.float32) * 0.01,
                rng.standard_normal((12, 1)).astype(np.float32) * 0.01)
               for _ in range(3)]
        for eng in (je, te):
            eng.apply_update("X", *ups[0])
            eng.apply_updates("X", ups[1:])
        for k, t in old.items():
            assert torch.equal(t, copies[k]), k
        for k in ("X", "Z", "W", "beta"):
            assert te.views[k] is not old[k], k
        _same(je, te)


def test_fused_path_defers_accounting_to_the_sync_window():
    """Poisoned updates on the fused path are counted admitted until a
    sync (every 32 firings, or explicit), as in the reference."""
    je, te = _pair(guard={})
    rng = np.random.default_rng(9)
    for i in range(40):
        u = rng.standard_normal((96, 1)).astype(np.float32) * 0.01
        v = rng.standard_normal((12, 1)).astype(np.float32) * 0.01
        if i in (3, 35):
            u[0] = np.nan
        for eng in (je, te):
            eng.apply_update("X", u, v)
        assert te.guard.stats.quarantined == je.guard.stats.quarantined
        assert len(te.guard._pending) == len(je.guard._pending)
    assert te.guard.stats.quarantined == 1   # the window of 32 synced once
    for eng in (je, te):
        eng.guard.sync()
    assert te.guard.stats.quarantined == 2
    _same(je, te)


def test_rowlocal_rollback_restores_touched_rows_bitwise():
    """A row-local firing keeps the in-place row kernel; its rollback
    scatters the saved rows back into the very same tensors."""
    from repro_torch.data import row_local_stream
    prog = _chain_prog(tcore)
    eng = tcore.IncrementalEngine(
        prog, {"X": 2}, guard=tg.GuardConfig(),
        chaos=tg.ChaosConfig(seed=0, trigger_raise_p=1.0), device="cpu")
    eng.initialize(_chain_inputs(0))
    carrier = row_local_stream(64, 3, m=32, rank=2, scale=0.1,
                               seed=4).next_carrier()
    before = dict(eng.views)
    copies = {k: t.clone() for k, t in before.items()}
    eng.apply_update("X", carrier)
    assert eng.stats.rowlocal_firings == 0
    assert eng.guard.stats.rollbacks == 1 and eng.chaos.raises == 1
    for k, t in before.items():
        assert eng.views[k] is t
        assert torch.equal(t, copies[k]), k
    # a clean row-local firing after it: rows written in place, exact
    eng.chaos = None
    eng.apply_update("X", carrier)
    assert eng.stats.rowlocal_firings == 1
    for k in ("X", "Y1", "Y2"):
        assert eng.views[k] is before[k]      # the row kernel, in place
    ref_views = _reference_views(eng)
    for k in ("Y1", "Y2"):
        assert _rel(_np(eng.views[k]), _np(ref_views[k])) <= 1e-5


def test_rowlocal_nonfinite_output_restores_rows():
    """A huge row-local carrier overflows only its touched rows: the
    output check reads those rows, and the rollback puts them back."""
    from repro_torch.data import row_local_stream
    eng = tcore.IncrementalEngine(_chain_prog(tcore), {"X": 2},
                                  guard=tg.GuardConfig(), device="cpu")
    eng.initialize(_chain_inputs(1))
    carrier = row_local_stream(64, 3, m=32, rank=2, scale=0.1,
                               seed=5).next_carrier()
    carrier.block[:] = 1e38
    copies = {k: t.clone() for k, t in eng.views.items()}
    eng.apply_update("X", carrier)
    assert eng.guard.stats.rollbacks == 1
    assert "non-finite output" in list(eng.guard.quarantine)[0].reason
    for k, t in copies.items():
        assert torch.equal(eng.views[k], t), k


# ---------------------------------------------------------------------------
# layer 3: drift sentinel
# ---------------------------------------------------------------------------


def test_sentinel_detects_and_recovers_drift():
    je, te = _pair(guard={"sentinel": {"probe_every": 1, "tol": 1e-3}})
    rng = np.random.default_rng(4)
    u = rng.standard_normal((96, 1)).astype(np.float32) * 0.01
    v = rng.standard_normal((12, 1)).astype(np.float32) * 0.01
    for eng in (je, te):
        # inject artificial drift: perturb a maintained view directly
        eng.views["Z"] = eng.views["Z"] + 0.5
        eng.apply_update("X", u, v)  # probe fires, sees drift, recovers
        sen = eng.guard.sentinel
        assert sen.probes >= 1 and sen.recoveries >= 1
        assert eng.guard.stats.drift_recoveries >= 1
    assert te.guard.sentinel.last_drift.keys() == \
        je.guard.sentinel.last_drift.keys()
    ref_views = _reference_views(te)
    for name in ("Z", "W", "beta"):
        assert _rel(_np(te.views[name]), _np(ref_views[name])) <= 5e-3
    drifts = te.guard.sentinel.probe(te)
    assert all(d <= te.guard.sentinel.config.tol for d in drifts.values())
    _same(je, te, tol=1e-4)


def test_sentinel_feeds_planner_note_drift():
    counts = []
    for core, pkg, planner, prog in (
            (jcore, jg, jplan, jax_ols(96, 12, 2)),
            (tcore, tg, tplan, torch_ols(96, 12, 2))):
        extra = {"device": "cpu"} if core is tcore else {}
        eng = core.IncrementalEngine(
            prog, plan=planner.AdaptivePlanner(),
            guard=_guard(pkg, sentinel={"probe_every": 1, "tol": 1e-3}),
            **extra)
        eng.initialize(_ols_inputs())
        eng.views["Z"] = eng.views["Z"] + 0.5
        rng = np.random.default_rng(5)
        eng.apply_update(
            "X", rng.standard_normal((96, 1)).astype(np.float32) * 0.01,
            rng.standard_normal((12, 1)).astype(np.float32) * 0.01)
        counts.append(dict(eng.planner.drift_counts))
    assert counts[1].get("Z", 0) >= 1
    assert counts[0] == counts[1]


def test_note_drift_forces_a_replan():
    for planner in (jplan, tplan):
        ap = planner.AdaptivePlanner(replan_every=10 ** 6)
        prog = (jax_ols if planner is jplan else torch_ols)(256, 32, 4)
        core = jcore if planner is jplan else tcore
        ap.bind(core.compile_program(prog))
        before = ap.plan
        assert ap.maybe_replan() is None and ap.plan is before  # not due
        ap.note_drift(["W", "W", "Z"])
        assert ap.drift_counts == {"W": 2, "Z": 1}
        ap.maybe_replan()
        assert ap.plan is not before          # forced: priced again
        assert not ap._force_replan


# ---------------------------------------------------------------------------
# the acceptance chaos run: 500 firings with poison + trigger faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
@pytest.mark.parametrize("family", ["ols", "powers"])
def test_chaos_500_firings_matches_jax(family, seed):
    """The reference's acceptance run on both engines: one seed poisons
    and raises at the same firings, the counters come out equal, every
    view stays finite, and the final views match re-evaluation within the
    sentinel tolerance."""
    chaos = {"seed": seed, "poison_p": 0.01, "poison_kind": "nan",
             "trigger_raise_p": 0.005}
    je, te = _pair(family, guard={"sentinel": {"probe_every": 100}},
                   chaos=chaos)
    input_name, (n_rows, n_cols) = (("X", (96, 12)) if family == "ols"
                                    else ("A", (24, 24)))
    for eng in (je, te):
        stream = UpdateStream(n=n_rows, m=n_cols, scale=0.005, seed=seed,
                              zipf=1.5)
        it = iter(stream)
        for i in range(500):
            u, v = next(it)
            eng.apply_update(input_name, u, v)
            if eng is te and i % 100 == 99:
                assert all(bool(torch.isfinite(a).all())
                           for a in te.views.values()), f"firing {i}"
        eng.guard.sync()
    for attr in ("poisoned", "raises"):
        assert getattr(te.chaos, attr) == getattr(je.chaos, attr), attr
    g = te.guard.stats
    assert te.chaos.poisoned > 0, "chaos never fired — test is vacuous"
    assert g.quarantined == te.chaos.poisoned
    assert g.rollbacks == te.chaos.raises
    assert g.admitted + g.quarantined == 500
    assert all(bool(torch.isfinite(a).all()) for a in te.views.values())
    ref_views = _reference_views(te)
    tol = te.guard.sentinel.config.tol
    for st in te.program.statements:
        name = st.target.name
        r = _np(ref_views[name]).astype(np.float64)
        c = _np(te.views[name]).astype(np.float64)
        drift = np.linalg.norm(r - c) / max(np.linalg.norm(r), 1e-30)
        assert drift <= tol, f"{name}: drift {drift:.2e} > {tol}"
    _same(je, te, tol=1e-4)


# ---------------------------------------------------------------------------
# the no-op gate (tests/test_sparse_delta.py's cases)
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
            "W1": rng.standard_normal((m, k)).astype(np.float32),
            "W2": rng.standard_normal((k, k)).astype(np.float32)}


def _chain_pair(seed, rank, tol):
    out = []
    for core, pkg in ((jcore, jg), (tcore, tg)):
        extra = {"device": "cpu"} if core is tcore else {}
        eng = core.IncrementalEngine(
            _chain_prog(core), {"X": rank},
            guard=pkg.GuardConfig(
                validation=pkg.ValidationPolicy(noop_tol=tol)), **extra)
        eng.initialize(_chain_inputs(seed))
        out.append(eng)
    return out


@pytest.mark.parametrize("seed,scale", [(0, 1e-9), (1, 1e-6), (2, 1e-4),
                                        (3, 3e-3), (4, 1e-2), (5, 5e-3)])
def test_noop_gate_never_skips_above_tolerance(seed, scale):
    tol = 1e-4
    je, te = _chain_pair(seed, 1, tol)
    rng = np.random.default_rng(seed)
    u = (scale * rng.standard_normal((64, 1))).astype(np.float32)
    v = (scale * rng.standard_normal((32, 1))).astype(np.float32)
    before = _snapshot(te)
    for eng in (je, te):
        eng.apply_update("X", u, v)
    if te.guard.stats.noop_skips:
        assert float(np.linalg.norm(u @ v.T)) <= tol
        for k, arr in before.items():
            np.testing.assert_array_equal(_np(te.views[k]), arr)
    else:
        assert not np.array_equal(_np(te.views["X"]), before["X"])
    _same(je, te)


def test_noop_gate_on_rowlocal_carrier_and_nan_falls_through():
    import repro.data as jdata
    import repro_torch.data as tdata
    tol = 1e-6
    je, te = _chain_pair(0, 2, tol)
    before = _snapshot(te)
    for eng, data in ((je, jdata), (te, tdata)):
        tiny = data.row_local_stream(64, 2, m=32, rank=2, scale=1e-8,
                                     seed=0).next_carrier()
        eng.apply_update("X", tiny)
        assert eng.guard.stats.noop_skips == 1
        assert eng.guard.stats.quarantined == 0   # a no-op is not a fault
        bad = data.row_local_stream(64, 2, m=32, rank=2, scale=1e-8,
                                    seed=1).next_carrier()
        bad.block[0, 0] = np.nan
        eng.apply_update("X", bad)
        assert eng.guard.stats.noop_skips == 1       # unchanged
        assert eng.guard.stats.quarantined == 1
    for k, arr in before.items():
        np.testing.assert_array_equal(_np(te.views[k]), arr)
    _same(je, te)


# ---------------------------------------------------------------------------
# layer 5: serve-path degradation
# ---------------------------------------------------------------------------


class _FlakyView:
    """Duck-typed logit view whose flush fails until told otherwise."""

    def __init__(self):
        self.logits = np.zeros((4, 4), np.float32)
        self.failing = False
        self.flushes = 0
        self.pending_updates = 0

    def submit_head_update(self, u, v):
        self.flush()
        return True

    def flush(self):
        if self.failing:
            raise RuntimeError("backend down")
        self.flushes += 1
        self.logits = self.logits + 1.0
        return self.logits


def test_circuit_breaker_state_machine():
    def run(pkg):
        clock = {"t": 0.0}
        br = pkg.CircuitBreaker(threshold=2, reset_timeout=10.0,
                                clock=lambda: clock["t"])
        seen = [(br.state, br.allow())]
        br.record_failure()
        seen.append(br.state)
        br.record_failure()
        seen.append((br.state, br.allow()))
        clock["t"] += 10.0
        seen.append((br.state, br.allow()))
        br.record_failure()
        seen.append(br.state)
        clock["t"] += 10.0
        br.record_success()
        seen.append((br.state, br.consecutive_failures))
        return seen
    want = run(jg)
    assert want == [("closed", True), "closed", ("open", False),
                    ("half_open", True), "open", ("closed", 0)]
    assert run(tg) == want


def test_guarded_view_degrades_to_snapshot_and_recovers():
    healths = []
    for pkg in (jg, tg):
        clock = {"t": 0.0}
        view = _FlakyView()
        gv = pkg.GuardedView(view, pkg.DegradePolicy(
            max_retries=1, backoff_base=0.0, breaker_threshold=2,
            breaker_reset=30.0), clock=lambda: clock["t"],
            sleep=lambda s: None)
        assert gv.flush()
        good = np.asarray(view.logits).copy()
        view.failing = True
        assert not gv.flush()
        assert not gv.flush()
        assert gv.breaker.state == "open"
        clock["t"] += 3.0
        np.testing.assert_array_equal(gv.read(), good)
        h = gv.health()
        assert h["serving"] == "snapshot"
        assert h["staleness_s"] == pytest.approx(3.0)
        assert h["degraded_reads"] == 1 and h["refresh_failures"] == 2
        clock["t"] += 30.0
        view.failing = False
        assert gv.flush()
        assert gv.breaker.state == "closed"
        assert gv.health()["serving"] == "fresh"
        assert gv.staleness() == 0.0
        h = gv.health()
        h.pop("last_error")
        healths.append(h)
    assert healths[0] == healths[1]


def test_serve_engine_view_health():
    from repro.serve.incremental_views import IncrementalLogitView as JView
    from repro_torch.serve import IncrementalLogitView as TView
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((8, 6)).astype(np.float32)
    head = rng.standard_normal((5, 6)).astype(np.float32)
    u = rng.standard_normal((5, 1)).astype(np.float32) * 0.01
    v = rng.standard_normal((6, 1)).astype(np.float32) * 0.01
    reads = []
    for pkg, view in ((jg, JView(hidden, head, flush_size=2)),
                      (tg, TView(hidden, head, flush_size=2,
                                 device="cpu"))):
        gv = pkg.GuardedView(view, pkg.DegradePolicy(max_retries=0))
        gv.submit(u, v)
        assert gv.flush()
        h = gv.health()
        assert h["breaker"] == "closed" and h["serving"] == "fresh"
        reads.append(_np(gv.read()))
    want = hidden @ (head + u @ v.T).T
    np.testing.assert_allclose(reads[1], want, rtol=2e-4, atol=2e-4)
    assert _rel(reads[1], reads[0]) <= TOL


def test_degraded_snapshot_does_not_move_when_live_view_updates():
    """The reference's snapshot is a reference to an immutable array.  A
    verbatim copy would hold the port's live Y, which the next flush
    updates in place; the port's GuardedView turns its engine out of
    place, so the snapshot keeps the last-good logits bitwise while the
    live view moves on."""
    from repro_torch.serve import IncrementalLogitView
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((16, 8)).astype(np.float32)
    head = rng.standard_normal((6, 8)).astype(np.float32)
    view = IncrementalLogitView(hidden, head, flush_size=4, flush_age=1e9,
                                device="cpu")
    clock = {"t": 0.0}
    gv = tg.GuardedView(view, tg.DegradePolicy(
        max_retries=0, breaker_threshold=1, breaker_reset=30.0),
        clock=lambda: clock["t"], sleep=lambda s: None)
    assert view.engine._out_of_place
    snap = gv.read()
    good = snap.clone()
    # a row-local carrier on H updates Y's touched rows with the in-place
    # row kernel: on a copy, never on the snapshot's tensor
    from repro_torch.data import row_local_stream
    carrier = row_local_stream(16, 2, m=8, rank=1, seed=3).next_carrier()
    view.engine.apply_update("H", carrier)
    assert view.engine.stats.rowlocal_firings == 1
    assert torch.equal(snap, good)
    # the live view moves on — in-place writes would move the snapshot too
    for _ in range(3):
        view.update_head(rng.standard_normal((6, 1)).astype(np.float32),
                         rng.standard_normal((8, 1)).astype(np.float32))
        view.update_head_batch([
            (rng.standard_normal((6, 1)).astype(np.float32),
             rng.standard_normal((8, 1)).astype(np.float32))
            for _ in range(3)])
    assert not torch.equal(view.logits, good)
    assert torch.equal(snap, good)
    # trip the breaker: the degraded read serves the untouched snapshot
    view.engine.chaos = tg.ChaosConfig(trigger_raise_p=1.0).monkey()
    view.submit_head_update(np.ones((6, 1), np.float32),
                            np.ones((8, 1), np.float32))
    assert not gv.flush()
    assert gv.breaker.state == "open"
    out = gv.read()
    assert out is snap and torch.equal(out, good)


def test_serve_engine_degrades_and_recovers_the_backlog():
    """ServeEngine(degrade=...) wraps each view; a failing flush leaves
    the last-good logits served bitwise and ``view_health`` degraded; on
    recovery the backlog flushes exactly."""
    from repro_torch.serve import IncrementalLogitView
    from repro_torch.serve.engine import ServeEngine

    clock = {"t": 0.0}

    class _Stub(ServeEngine):  # no LM needed for the view path
        def __init__(self, degrade):
            self.degrade = degrade
            self._logit_views = {}
            self._view_guards = {}

    eng = _Stub(tg.DegradePolicy(max_retries=1, backoff_base=0.0,
                                 breaker_threshold=1, breaker_reset=30.0))
    rng = np.random.default_rng(2)
    H = rng.standard_normal((24, 8)).astype(np.float32)
    W = rng.standard_normal((6, 8)).astype(np.float32)
    view = IncrementalLogitView(H, W, flush_size=8, flush_age=1e9,
                                device="cpu")
    eng.attach_logit_view("lm_head", view)
    gv = eng._view_guards["lm_head"]
    gv._clock = gv.breaker._clock = lambda: clock["t"]
    gv._sleep = lambda s: None
    deltas = [(rng.standard_normal((6, 1)).astype(np.float32) * 0.1,
               rng.standard_normal((8, 1)).astype(np.float32) * 0.1)
              for _ in range(6)]
    for u, v in deltas[:2]:
        eng.hot_swap("lm_head", u, v)
    eng.flush_views()
    good = eng.view_logits("lm_head").clone()
    assert eng.view_health()["lm_head"]["serving"] == "fresh"
    view.engine.chaos = tg.ChaosConfig(trigger_raise_p=1.0).monkey()
    for u, v in deltas[2:]:
        eng.hot_swap("lm_head", u, v)
    eng.flush_views()
    h = eng.view_health()["lm_head"]
    assert h["breaker"] == "open" and h["serving"] == "snapshot"
    assert torch.equal(eng.view_logits("lm_head"), good)
    assert view.pending_updates == 4
    view.engine.chaos = None
    clock["t"] += 30.0
    eng.flush_views()
    assert eng.view_health()["lm_head"]["serving"] == "fresh"
    Wn = W + sum(u @ v.T for u, v in deltas)
    assert _rel(_np(eng.view_logits("lm_head")), H @ Wn.T) <= 1e-5


# ---------------------------------------------------------------------------
# the kernels' plain versions (what the card's entries are held to)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,k", [(1, 1), (1, 5), (4, 3)])
def test_out_of_place_plain_version(t, k):
    """``rank_update_batched_out`` equals the in-place entry bitwise,
    leaves m alone, and sets its flag iff a stored value is not finite."""
    g = torch.Generator().manual_seed(t * 10 + k)
    m = torch.randn(37, 101, generator=g)
    u = torch.randn(t, 37, k, generator=g)
    v = torch.randn(t, 101, k, generator=g)
    m0 = m.clone()
    flag = torch.zeros(1, dtype=torch.int32)
    out = ops.rank_update_batched_out(m, u, v, flag)
    assert out.data_ptr() != m.data_ptr() and torch.equal(m, m0)
    assert torch.equal(out, ops.rank_update_batched(m0.clone(), u, v))
    assert int(flag) == 0
    u[0, 3, 0] = float("inf")
    ops.rank_update_batched_out(m, u, v, flag)
    assert int(flag) == 1
    ops.rank_update_batched_out(m0, u * 0, v, flag)   # never cleared
    assert int(flag) == 1


def test_select_commit_plain_version():
    """``select_commit`` is ``torch.where(ok, new, old)`` with ``ok`` iff
    every flag is zero, in place on new."""
    g = torch.Generator().manual_seed(0)
    old, new = torch.randn(9, 7, generator=g), torch.randn(9, 7, generator=g)
    for flags, want in (([0, 0], new), ([0, 1], old), ([1, 0], old),
                        ([1, 1], old)):
        f = torch.tensor(flags, dtype=torch.int32)
        got = new.clone()
        assert ops.select_commit(f, old, got) is got
        assert torch.equal(got, want)
        assert torch.equal(ref.select_commit(f, old, new),
                           torch.where(~f.bool().any(), new, old))


# ---------------------------------------------------------------------------
# regressions the reference keeps beside its guard tests
# ---------------------------------------------------------------------------


def test_update_stream_batch_advances():
    from repro_torch.data import UpdateStream as TStream
    s, j = TStream(n=16, m=4, seed=5), UpdateStream(n=16, m=4, seed=5)
    u1, v1 = s.batch(3)
    np.testing.assert_array_equal(u1, j.batch(3)[0])
    u2, v2 = s.batch(3)
    assert not (np.array_equal(u1, u2) and np.array_equal(v1, v2))
    s.reset()
    u3, v3 = s.batch(3)
    np.testing.assert_array_equal(u1, u3)
    np.testing.assert_array_equal(v1, v3)
    s2 = TStream(n=16, m=4, seed=5)
    next(iter(s2))
    assert not np.array_equal(u1, s2.batch(3)[0])


def test_planner_op_cost_scales_move_inverse_crossover():
    wl = dict(update_rank=1, rank_lo=1, rank_hi=40)
    plans = []
    for planner, ols in ((jplan, jax_ols), (tplan, torch_ols)):
        prog = ols(256, 32, 4)
        w = planner.WorkloadDescriptor(**wl)
        plain = planner.plan_program(prog, w)
        scaled = planner.plan_program(prog, dataclasses.replace(
            w, op_cost_scales={"inverse": 8.0}))
        assert scaled.views["W"].crossover_rank > \
            plain.views["W"].crossover_rank
        assert scaled.views["Z"].crossover_rank == \
            plain.views["Z"].crossover_rank
        assert plain.views["W"].strategy == "hybrid"
        assert scaled.views["W"].strategy == "incremental"
        rt = planner.MaintenancePlan.from_json(scaled.to_json())
        assert rt.workload.op_cost_scales == {"inverse": 8.0}
        plans.append(scaled.to_json())
    assert plans[0] == plans[1]


def test_adaptive_planner_refits_cost_scale_from_stats():
    ap = tplan.AdaptivePlanner(drift_tol=0.5)
    ap.bind(tcore.compile_program(torch_ols(256, 32, 4)))
    stats = tcore.EngineStats()
    assert ap.refit_from_stats(stats) is None  # unmeasurable: no-op
    stats.trigger_seconds, stats.sweep_flops_timed = 0.1, 1e6
    stats.reeval_seconds, stats.reeval_flops_timed = 0.1, 1e8
    assert ap.refit_from_stats(stats) == pytest.approx(100.0)
    assert ap.workload.cost_scale == pytest.approx(100.0)
    new = ap.maybe_replan()
    assert new is not None
    assert any(vp.strategy != "incremental" for vp in new.views.values())


def test_refit_through_engine_firing_path():
    eng = tcore.IncrementalEngine(torch_ols(96, 12, 2),
                                  plan=tplan.AdaptivePlanner(replan_every=2),
                                  device="cpu")
    eng.initialize(_ols_inputs())
    rng = np.random.default_rng(6)
    for _ in range(3):
        eng.apply_update(
            "X", rng.standard_normal((96, 1)).astype(np.float32) * 0.01,
            rng.standard_normal((12, 1)).astype(np.float32) * 0.01,
            block=True)
    eng.reevaluate(block=True)
    assert eng.stats.sweep_flops_timed > 0
    assert eng.stats.reeval_flops_timed > 0
    scale = eng.planner.refit_from_stats(eng.stats)
    assert scale is not None and scale > 0


# ---------------------------------------------------------------------------
# higher-order (deferred-cascade) engines under the guard
# ---------------------------------------------------------------------------


def _ho_pair(n, data_seed, chaos, order=2, fold_window=2):
    """(JAX engine, port engine): guarded matrix powers (k = 4, exp) at
    ``order``, under the same chaos config (a keyword dict), on the same
    stable input."""
    rng = np.random.default_rng(data_seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    a *= 0.5 / max(abs(np.linalg.eigvals(a)))
    out = []
    for pkg, core, prog, extra in (
            (jg, jcore, jax_powers(k=4, n=n, model="exp"), {}),
            (tg, tcore, torch_powers(k=4, n=n, model="exp"),
             {"device": "cpu"})):
        eng = core.IncrementalEngine(
            prog, order=order, fold_window=fold_window,
            guard=pkg.GuardConfig(),
            chaos=pkg.ChaosConfig(**chaos), **extra)
        eng.initialize({"A": a})
        out.append(eng)
    return out, a


def test_deferred_engine_never_takes_guard_fast_path():
    """The fused path keeps no host snapshot; a deferred cascade carries
    host window state, so it must stay off."""
    prog = torch_powers(k=4, n=12, model="exp")
    eng = tcore.IncrementalEngine(prog, order=2, fold_window=2,
                                  guard=tg.GuardConfig(), device="cpu")
    assert not eng._guard_fast_path
    assert tcore.IncrementalEngine(prog, guard=tg.GuardConfig(),
                                   device="cpu")._guard_fast_path


def test_higher_order_fault_rolls_back_cascade_bit_identically():
    """An aborted firing on an order-2 engine restores the views (the
    very tensors) AND the cascade window; the counters equal JAX's."""
    (je, te), _ = _ho_pair(12, 2, dict(seed=0, trigger_raise_p=1.0),
                           fold_window=4)
    rng = np.random.default_rng(2)
    rng.standard_normal((12, 12))
    before_cascade = te._cascade_snapshot()
    before_views = dict(te.views)
    u = rng.standard_normal((12, 1)).astype(np.float32) * 0.01
    v = rng.standard_normal((12, 1)).astype(np.float32) * 0.01
    out = te.apply_update("A", u, v)
    je.apply_update("A", u, v)
    for k, arr in before_views.items():
        assert out[k] is arr, f"{k}: rollback must restore the same tensor"
    factors, base, firings, _ = te._cascade_snapshot()
    bf_factors, bf_base, bf_firings, _ = before_cascade
    assert firings == bf_firings
    assert {o: {k: len(v) for k, v in fs.items()}
            for o, fs in factors.items()} == \
        {o: {k: len(v) for k, v in fs.items()}
         for o, fs in bf_factors.items()}
    assert all(base[o][k] is bf_base[o][k] for o in base for k in base[o])
    assert te.guard.stats.rollbacks == 1 and te.stats.folds == 0
    _same(je, te)


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_fold_abort_refolds_exactly(seed):
    """Chaos raised inside a fold rolls it back and re-folds through the
    exact re-evaluation; the same seed gives the JAX engine's counters,
    and the views stay exact and at parity."""
    (je, te), _ = _ho_pair(12, seed, dict(seed=seed, trigger_raise_p=0.35))
    it = iter(UpdateStream(n=12, m=12, scale=0.01, seed=seed))
    for _ in range(30):
        u, v = next(it)
        je.apply_update("A", u, v)
        te.apply_update("A", u, v)
    je.flush()
    te.flush()
    assert te.chaos.raises == je.chaos.raises > 0, \
        "chaos never fired — test is vacuous"
    for k in ("folds", "fold_sweeps", "fold_reevals", "fold_aborts"):
        assert getattr(te.stats, k) == getattr(je.stats, k), k
    assert te.stats.folds > 0
    assert all(bool(torch.isfinite(x).all()) for x in te.views.values())
    ref_views = _reference_views(te)
    for st in te.program.statements:
        name = st.target.name
        assert _rel(_np(te.views[name]), _np(ref_views[name])) <= 1e-5, name
    _same(je, te)


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_higher_order_chaos_matches_first_order_replay(seed):
    """An order-2 guarded engine under poison and trigger chaos stays
    exactly-once: it matches a clean first-order port engine replaying
    only the committed updates (the input bit for bit), and the JAX
    engine's counters under the same seed."""
    (je, te), a = _ho_pair(16, seed, dict(seed=seed, poison_p=0.05,
                                          poison_kind="nan",
                                          trigger_raise_p=0.05),
                           fold_window=3)
    it = iter(UpdateStream(n=16, m=16, scale=0.005, seed=seed))
    applied, n_updates = [], 60
    for _ in range(n_updates):
        u, v = next(it)
        before = te.guard.stats.admitted
        aborted = te.guard.stats.aborted_firings
        je.apply_update("A", u, v)
        te.apply_update("A", u, v)
        if (te.guard.stats.admitted > before
                and te.guard.stats.aborted_firings == aborted):
            applied.append((u, v))
    for e in (je, te):
        e.flush()
        e.guard.sync()
    g = te.guard.stats
    assert te.chaos.poisoned > 0, "chaos never fired — test is vacuous"
    assert g.admitted + g.quarantined == n_updates
    assert len(applied) == g.admitted - g.aborted_firings
    replay = tcore.IncrementalEngine(torch_powers(k=4, n=16, model="exp"),
                                     device="cpu")
    replay.initialize({"A": a})
    for u, v in applied:
        replay.apply_update("A", u, v)
    for st in te.program.statements:
        name = st.target.name
        assert _rel(_np(te.views[name]), _np(replay.views[name])) <= 1e-5
    assert torch.equal(te.views["A"], replay.views["A"])
    assert te.stats.folds == je.stats.folds
    _same(je, te)
