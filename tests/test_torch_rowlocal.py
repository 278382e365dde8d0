"""The port's delta carriers, carrier streams and carrier engine against
the JAX package's, at small sizes on the CPU."""

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.factored as jf
import repro.data.updates as jdata
import repro_torch.core as tcore
import repro_torch.core.factored as tf
import repro_torch.data as tdata
from repro.core.codegen import compact_chain_names as jax_compact_chain
from repro_torch.core.codegen import compact_chain_names

# f32 engine parity, as max |a - b| over the view's largest entry
TOL = 1e-5

COUNTERS = ("noop_skips", "rowlocal_firings", "widened_carriers",
            "updates_applied", "triggers_fired", "batches_applied",
            "recompressions")


def _chain(core, n=64, m=32, k=16):
    """Left chain Y1 = X·W1, Y2 = Y1·W2: every view row-local, compact."""
    p = core.Program(name="chain")
    X = p.input("X", (core.dim("N"), core.dim("M")))
    W1 = p.input("W1", (core.dim("M"), core.dim("K")))
    W2 = p.input("W2", (core.dim("K"), core.dim("K")))
    Y1 = p.let("Y1", core.matmul(X, W1))
    p.let("Y2", core.matmul(Y1, W2))
    p.outputs = ["Y1", "Y2"]
    return p.bind_dims(N=n, M=m, K=k)


def _gram(core, n=48, m=16):
    """G = XᵀX: the transpose widens a row-local ΔX."""
    p = core.Program(name="gram")
    X = p.input("X", (core.dim("N"), core.dim("M")))
    p.let("G", core.matmul(core.transpose(X), X))
    p.outputs = ["G"]
    return p.bind_dims(N=n, M=m)


def _general(core, n=40, p=4):
    """T_{i+1} = A·T_i + B, exp model, k = 4: A, T1, S2 row-local, the
    powers and later T, S views widened (the mixed regime)."""
    return core.iterative.general_form(k=4, n=n, p_dim=p, model="exp")


# name -> (builder, input, input shape)
PROGRAMS = {"chain": (_chain, "X", (64, 32)), "gram": (_gram, "X", (48, 16)),
            "general": (_general, "A", (40, 40))}


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "chain":
        return {"X": rng.standard_normal((64, 32)).astype(np.float32),
                "W1": rng.standard_normal((32, 16)).astype(np.float32),
                "W2": rng.standard_normal((16, 16)).astype(np.float32)}
    if name == "gram":
        return {"X": rng.standard_normal((48, 16)).astype(np.float32)}
    a = rng.standard_normal((40, 40)) * (0.9 / np.sqrt(40))
    return {"A": a.astype(np.float32),
            "T0": rng.standard_normal((40, 4)).astype(np.float32),
            "B": rng.standard_normal((40, 4)).astype(np.float32)}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() or 1.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_views(got, want, what):
    for k in want:
        assert _rel(_np(got[k]), _np(want[k])) <= TOL, \
            f"{what}: view {k} off by {_rel(_np(got[k]), _np(want[k]))}"


def _to_jax(c):
    """A port carrier as the JAX package's carrier of the same arrays."""
    if c.kind == "row_local":
        return jf.RowLocalCarrier(c.rows, c.block, c.V, c.n)
    if c.kind == "noop":
        return jf.NoOpCarrier(c.n, c.m)
    return jf.LowRankCarrier(c.P, c.Q)


def _assert_same_carrier(a, b):
    assert a.kind == b.kind and a.rank == b.rank and a.nm == b.nm
    assert a.affected_fraction() == b.affected_fraction()
    for x, y in zip(a.factors(), b.factors()):
        np.testing.assert_array_equal(x, y)
    if a.kind == "row_local":
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.block, b.block)


# ---------------------------------------------------------------------------
# carrier classes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_carrier_methods_match_jax(seed):
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(30, 5, replace=False)).astype(np.int32)
    block = rng.standard_normal((5, 2)).astype(np.float32)
    V = rng.standard_normal((7, 2)).astype(np.float32)
    W = rng.standard_normal((7, 3)).astype(np.float32)
    t = tf.RowLocalCarrier(rows, block, V, 30)
    j = jf.RowLocalCarrier(rows, block, V, 30)
    _assert_same_carrier(t, j)
    assert t.norm_bound() == pytest.approx(j.norm_bound(), rel=1e-6)
    for tt, jj in ((t.negate(), j.negate()), (t.scale(-0.5), j.scale(-0.5)),
                   (t.matmul_right(W), j.matmul_right(W))):
        _assert_same_carrier(tt, jj)
    P, Q = t.factors()
    tl, jl = tf.LowRankCarrier(P, Q), jf.LowRankCarrier(P, Q)
    _assert_same_carrier(tl, jl)
    _assert_same_carrier(tl.negate(), jl.negate())
    assert tl.norm_bound() == pytest.approx(jl.norm_bound(), rel=1e-6)
    tn, jn = tf.NoOpCarrier(30, 7), jf.NoOpCarrier(30, 7)
    _assert_same_carrier(tn, jn)
    assert tn.is_noop() and tn.negate() is tn


def test_row_delta_and_as_carrier_match_jax():
    V = np.arange(12, dtype=np.float32).reshape(4, 3)
    for weight in (1.0, -1.0):
        _assert_same_carrier(
            tf.row_delta_carrier([9, 2, 5], V, 12, weight=weight),
            jf.row_delta_carrier([9, 2, 5], V, 12, weight=weight))
    u, v = np.ones(6, np.float32), np.ones(3, np.float32)
    _assert_same_carrier(tf.as_carrier(u, v), jf.as_carrier(u, v))
    c = tf.NoOpCarrier(6, 3)
    assert tf.as_carrier(c) is c
    with pytest.raises(ValueError):
        tf.as_carrier(c, v)
    with pytest.raises(ValueError):
        tf.as_carrier(u)


@pytest.mark.parametrize("case", ["empty", "few", "many", "tiny_norm"])
def test_detect_row_local_matches_jax(case):
    rng = np.random.default_rng(4)
    u = np.zeros((20, 2), np.float32)
    v = rng.standard_normal((6, 2)).astype(np.float32)
    if case == "few":
        u[[3, 11, 12]] = rng.standard_normal((3, 2))
    elif case == "many":
        u[:15] = rng.standard_normal((15, 2))
    elif case == "tiny_norm":
        u[4] = 1e-9
    kw = {"noop_tol": 1e-6} if case == "tiny_norm" else {}
    _assert_same_carrier(tf.detect_row_local(u, v, **kw),
                         jf.detect_row_local(u, v, **kw))


@pytest.mark.parametrize("mix", ["row_local", "with_noop", "with_low_rank",
                                 "all_noop"])
def test_stack_carriers_matches_jax(mix):
    s = tdata.row_local_stream(50, 6, m=8, rank=2, seed=3)
    cs = [s.next_carrier() for _ in range(4)]
    cs.append(tf.RowLocalCarrier(cs[0].rows, cs[0].block, cs[0].V, 50))
    if mix == "with_noop":
        cs.insert(2, tf.NoOpCarrier(50, 8))
    elif mix == "with_low_rank":
        cs.append(tf.LowRankCarrier(*cs[1].factors()))
    elif mix == "all_noop":
        cs = [tf.NoOpCarrier(50, 8)] * 2
    _assert_same_carrier(tf.stack_carriers(cs),
                         jf.stack_carriers([_to_jax(c) for c in cs]))
    with pytest.raises(ValueError):
        tf.stack_carriers([])


# ---------------------------------------------------------------------------
# carrier streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("zipf", [None, 1.5])
def test_row_local_stream_is_the_same_draws(zipf):
    ts = tdata.row_local_stream(128, 6, m=16, rank=2, seed=7, zipf=zipf)
    js = jdata.row_local_stream(128, 6, m=16, rank=2, seed=7, zipf=zipf)
    for _ in range(4):
        _assert_same_carrier(ts.next_carrier(), js.next_carrier())
    _assert_same_carrier(ts.batch(3), js.batch(3))
    ts.reset()
    js.reset()
    _assert_same_carrier(ts.next_carrier(), js.next_carrier())


def test_zipf_row_stream_both_forms_match_jax():
    tz = tdata.zipf_row_stream(128, 32, 1.5, seed=3, rows_touched=6)
    jz = jdata.zipf_row_stream(128, 32, 1.5, seed=3, rows_touched=6)
    assert isinstance(tz, tdata.RowLocalStream)
    c = tz.next_carrier()
    _assert_same_carrier(c, jz.next_carrier())
    assert np.all(np.diff(c.rows) > 0) and 1 <= len(c.rows) <= 6
    tl = tdata.zipf_row_stream(128, 32, 1.5, seed=3)
    jl = jdata.zipf_row_stream(128, 32, 1.5, seed=3)
    for a, b in zip(tl.next_update(), jl.next_update()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tdata.row_local_stream(8, 9)


# ---------------------------------------------------------------------------
# the carrier engine
# ---------------------------------------------------------------------------


def test_compact_chain_and_carrier_verdicts_match_jax():
    for name, (build, inp, _) in PROGRAMS.items():
        jt = jcore.compile_program(build(jcore)).triggers[inp]
        tt = tcore.compile_program(build(tcore)).triggers[inp]
        assert tt.carriers == jt.carriers, name
        assert compact_chain_names(tt) == jax_compact_chain(jt), name
    assert compact_chain_names(tt) is None          # general: mixed
    rl = {v for v, kind in tt.carriers.items() if kind == "row_local"}
    assert rl == {"A", "T1", "S2"}


def _stream_steps(name, seed):
    """A mixed carrier stream for one program: (kind, payload) steps."""
    _, _, (n, m) = PROGRAMS[name]
    rng = np.random.default_rng(seed + 1)
    s = tdata.row_local_stream(n, 3, m=m, rank=2, seed=seed)
    steps = [("one", s.next_carrier()) for _ in range(3)]
    steps.append(("batch", [s.next_carrier() for _ in range(3)]))
    P = (0.1 * rng.standard_normal((n, 2))).astype(np.float32)
    Q = (0.1 * rng.standard_normal((m, 2))).astype(np.float32)
    u = (0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    v = (0.1 * rng.standard_normal((m, 1))).astype(np.float32)
    steps.append(("batch", [s.next_carrier(), tf.LowRankCarrier(P, Q),
                            tf.NoOpCarrier(n, m), (u, v)]))
    wide = tdata.row_local_stream(n, n // 2, m=m, rank=1, seed=seed + 2)
    steps.append(("one", wide.next_carrier()))      # past the crossover
    steps.append(("one", tf.NoOpCarrier(n, m)))
    steps.append(("one", s.next_carrier()))
    return steps


def _replay(engine, inp, steps):
    for kind, x in steps:
        for c in ([x] if kind == "one" else x):
            if isinstance(c, tuple):
                engine.apply_update(inp, *c)
            elif c.kind != "noop":
                engine.apply_update(inp, *c.factors())


@pytest.mark.parametrize("rowlocal_apply", ["jit", "inplace"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_carrier_engine_matches_jax(name, rowlocal_apply):
    """Single carriers, a pure row-local batch, a ragged mixed batch
    (row-local, low-rank, no-op, raw pair), a carrier past the
    crossover and a no-op: the same views and counters as the JAX
    carrier engine, and the same views as re-evaluation."""
    build, inp, _ = PROGRAMS[name]
    inputs = _inputs(name)
    je = jcore.IncrementalEngine(build(jcore), {inp: 2},
                                 rowlocal_apply=rowlocal_apply)
    te = tcore.IncrementalEngine(build(tcore), {inp: 2}, device="cpu")
    tr = tcore.ReevalEngine(build(tcore), device="cpu")
    for e in (je, te, tr):
        e.initialize(inputs)
    steps = _stream_steps(name, seed=5)
    for kind, x in steps:
        if kind == "one":
            je.apply_update(inp, _to_jax(x))
            te.apply_update(inp, x)
        else:
            je.apply_updates(inp, [c if isinstance(c, tuple) else _to_jax(c)
                                   for c in x])
            te.apply_updates(inp, x)
    _replay(tr, inp, steps)
    _assert_views(te.views, je.views, "port vs JAX carrier engine")
    _assert_views(te.views, tr.views, "port vs re-evaluation")
    for c in COUNTERS:
        assert getattr(te.stats, c) == getattr(je.stats, c), c
    if name == "gram":
        assert te.stats.rowlocal_firings == 0
    else:
        assert te.stats.rowlocal_firings == 5
    assert te.stats.noop_skips == 2


@pytest.mark.parametrize("name", ["chain", "general"])
def test_row_and_dense_applies_are_counted(name):
    build, inp, (n, m) = PROGRAMS[name]
    te = tcore.IncrementalEngine(build(tcore), {inp: 1}, device="cpu")
    te.initialize(_inputs(name))
    trig = te.compiled.triggers[inp]
    lowrank = [up.view for up in trig.updates if up.kind == "lowrank"]
    rows = [v for v in lowrank if trig.carriers.get(v) == "row_local"]
    s = tdata.row_local_stream(n, 2, m=m, seed=1)
    te.apply_update(inp, s.next_carrier())
    te.apply_updates(inp, [s.next_carrier() for _ in range(2)])
    one, two = te._rowlocal_fns[(inp, 1)], te._rowlocal_fns[(inp, 2)]
    assert one.compact == two.compact == (name == "chain")
    assert (one.row_applies, one.dense_applies) == (
        len(rows), len(lowrank) - len(rows))
    assert te.stats.row_applies == one.row_applies + two.row_applies
    assert te.stats.lowrank_applies == one.dense_applies + two.dense_applies


def test_rowlocal_batch_past_max_batch_rank_recompresses():
    build, inp, (n, m) = PROGRAMS["chain"]
    inputs = _inputs("chain", seed=2)
    je = jcore.IncrementalEngine(build(jcore), {inp: 1}, max_batch_rank=3)
    te = tcore.IncrementalEngine(build(tcore), {inp: 1}, device="cpu",
                                 max_batch_rank=3)
    tr = tcore.ReevalEngine(build(tcore), device="cpu")
    for e in (je, te, tr):
        e.initialize(inputs)
    s = tdata.row_local_stream(n, 2, m=m, seed=4)
    c = s.next_carrier()
    # six rank-1 carriers on the same two rows and two right factors:
    # numerical rank 2, stacked rank 6
    cs = [tf.RowLocalCarrier(c.rows, c.block * (i + 1),
                             c.V if i % 2 else 2 * c.V, n) for i in range(6)]
    je.apply_updates(inp, [_to_jax(x) for x in cs])
    te.apply_updates(inp, cs)
    _replay(tr, inp, [("batch", cs)])
    assert te.stats.recompressions == je.stats.recompressions == 1
    assert te.stats.rowlocal_firings == 1
    _assert_views(te.views, je.views, "recompressed batch")
    _assert_views(te.views, tr.views, "recompressed batch vs reeval")


def test_firing_copies_the_callers_carrier():
    """The firing's factors are copies of the carrier's arrays: changing
    them afterwards moves no view."""
    build, inp, (n, m) = PROGRAMS["chain"]
    te = tcore.IncrementalEngine(build(tcore), {inp: 1}, device="cpu")
    te.initialize(_inputs("chain"))
    c = tdata.row_local_stream(n, 3, m=m, seed=6).next_carrier()
    te.apply_update(inp, c)
    before = {k: v.clone() for k, v in te.views.items()}
    c.block[:] = 1e6
    c.V[:] = 1e6
    for k, v in te.views.items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


@pytest.mark.parametrize("rows", [[5, 2, 9], [2, 2, 9], [2, 9, 64]])
def test_rows_must_strictly_increase_within_the_view(rows):
    build, inp, (n, m) = PROGRAMS["chain"]
    te = tcore.IncrementalEngine(build(tcore), {inp: 1}, device="cpu")
    te.initialize(_inputs("chain"))
    c = tf.RowLocalCarrier(np.asarray(rows, np.int32),
                           np.ones((3, 1), np.float32),
                           np.ones((m, 1), np.float32), n)
    with pytest.raises(ValueError, match="strictly increase"):
        te.apply_update(inp, c)


def test_mixed_factor_sharing_a_written_view_reads_its_old_value():
    """In the mixed regime a factor block that is a view the same firing
    writes earlier (here B, updated by the row kernel before A's dense
    apply) must still carry the pre-update value, so the firing copies
    it before any apply."""
    n = 6
    prog = tcore.Program(name="alias_rows")
    prog.input("A", (n, 1))
    B = prog.input("B", (n, 1))
    du, dv = tcore.var("dU", (n, 1)), tcore.var("dV", (1, 1))
    trig = tcore.Trigger(
        "B", 1, du, dv, assigns=[tcore.Assign("f", B)],
        updates=[tcore.ViewUpdate("B", "lowrank", u="dU", v="dV"),
                 tcore.ViewUpdate("A", "lowrank", u="f", v="dV")])
    trig.carriers.update(B="row_local", A="low_rank")
    fn = tcore.build_rowlocal_trigger_fn(trig, prog, device="cpu")
    assert not fn.compact and (fn.row_applies, fn.dense_applies) == (1, 1)
    rng = np.random.default_rng(10)
    a0, b0 = (rng.normal(size=(n, 1)).astype(np.float32) for _ in range(2))
    views = {"A": torch.from_numpy(a0.copy()),
             "B": torch.from_numpy(b0.copy())}
    rows, block = np.array([1, 4]), np.array([[2.0], [-1.0]], np.float32)
    fn(views, rows, block, np.full((1, 1), 0.5, np.float32))
    b1 = b0.copy()
    b1[rows] += block * 0.5
    np.testing.assert_allclose(views["B"].numpy(), b1, rtol=1e-6)
    np.testing.assert_allclose(views["A"].numpy(), a0 + b0 * 0.5, rtol=1e-6)
