"""The port's engines against the JAX package's on every update path, each
also against its own re-evaluation engine; the port's aliasing rules for
in-place applies; mid-stream hand-over of state; no quiet CPU fallback."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.apps.ols import build_ols_program as jax_ols
from repro.data.updates import UpdateStream
from repro_torch.apps.ols import build_ols_program as torch_ols
from repro_torch.core.factored import ColSlice

# f32 engine parity, as max |a - b| over the view's largest entry
TOL = 1e-5

# name -> (builder taking (core, ols builder) of one package, input, shape)
PROGRAMS = {
    "ols": (lambda core, ols: ols(48, 12, 2), "X", (48, 12)),
    "powers_exp": (lambda core, ols: core.iterative.matrix_powers(
        8, 32, "exp"), "A", (32, 32)),
    "powers_linear": (lambda core, ols: core.iterative.matrix_powers(
        4, 32, "linear"), "A", (32, 32)),
}


def _inputs(name):
    rng = np.random.default_rng(7)
    if name == "ols":
        return {"X": rng.normal(size=(48, 12)).astype(np.float32),
                "Y": rng.normal(size=(48, 2)).astype(np.float32)}
    a = rng.normal(size=(32, 32)) * (0.9 / np.sqrt(32))
    return {"A": a.astype(np.float32)}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() or 1.0)


def _assert_views(got, want, what):
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = want[k].numpy() if isinstance(want[k], torch.Tensor) else want[k]
        assert _rel(g, w) <= TOL, f"{what}: view {k} off by {_rel(g, w)}"


def _updates(shape, count, seed, rows=None):
    stream = UpdateStream(n=shape[0], m=shape[1], seed=seed)
    ups = [stream.next_update() for _ in range(count)]
    if rows is not None:  # low numerical rank: every update hits `rows`
        for i, (u, _) in enumerate(ups):
            u[:] = 0.0
            u[rows[i % len(rows)], 0] = 1.0
    return ups


def _engines(name, **kw):
    build, inp, shape = PROGRAMS[name]
    jprog, tprog = build(jcore, jax_ols), build(tcore, torch_ols)
    je = jcore.IncrementalEngine(jprog, **kw)
    te = tcore.IncrementalEngine(tprog, device="cpu", **kw)
    jr = jcore.ReevalEngine(jprog)
    tr = tcore.ReevalEngine(tprog, device="cpu")
    inputs = _inputs(name)
    for e in (je, te, jr, tr):
        e.initialize(inputs)
    return je, te, jr, tr, inp, shape


def _replay(jr, tr, inp, ups):
    for u, v in ups:
        jr.apply_update(inp, jnp.asarray(u), jnp.asarray(v))
        tr.apply_update(inp, u, v)


def _assert_all(je, te, jr, tr):
    _assert_views(te.views, je.views, "port vs JAX engine")
    _assert_views(te.views, tr.views, "port vs port re-evaluation")
    _assert_views(je.views, jr.views, "JAX vs JAX re-evaluation")


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_apply_update_path(name):
    je, te, jr, tr, inp, shape = _engines(name)
    ups = _updates(shape, 4, seed=1)
    for u, v in ups:
        je.apply_update(inp, u, v)
        te.apply_update(inp, u, v, block=True)
    _replay(jr, tr, inp, ups)
    _assert_all(je, te, jr, tr)
    assert te.stats.updates_applied == te.stats.triggers_fired == 4
    assert te.stats.updates_timed == 4


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_apply_updates_batch_path(name):
    je, te, jr, tr, inp, shape = _engines(name)
    ups = _updates(shape, 6, seed=2)   # rank 6, padded to the 8 bucket
    je.apply_updates(inp, ups)
    te.apply_updates(inp, ups)
    _replay(jr, tr, inp, ups)
    _assert_all(je, te, jr, tr)
    assert te.stats.batches_applied == 1 and te.stats.updates_applied == 6


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_apply_updates_past_max_batch_rank_recompresses(name):
    je, te, jr, tr, inp, shape = _engines(name, max_batch_rank=3)
    ups = _updates(shape, 8, seed=3, rows=(2, 5))   # numerical rank 2
    je.apply_updates(inp, ups)
    te.apply_updates(inp, ups)
    assert je.stats.recompressions == te.stats.recompressions == 1
    _replay(jr, tr, inp, ups)
    _assert_all(je, te, jr, tr)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_enqueue_and_flush_path(name):
    je, te, jr, tr, inp, shape = _engines(name, flush_size=4, flush_age=1e9)
    ups = _updates(shape, 10, seed=4)
    flushed = []
    for u, v in ups:
        je.enqueue_update(inp, u, v)
        flushed.append(te.enqueue_update(inp, u, v) is not None)
    assert flushed == [False, False, False, True] * 2 + [False, False]
    assert te.pending_rank(inp) == 2
    je.flush()
    te.flush()
    assert te.pending_rank(inp) == 0
    assert te.stats.triggers_fired == 3 and te.stats.updates_applied == 10
    _replay(jr, tr, inp, ups)
    _assert_all(je, te, jr, tr)


def test_initialize_copies_the_callers_arrays():
    """In-place applies must not write through to the caller's inputs, nor
    to the re-evaluation engine initialized from the same arrays."""
    inputs = _inputs("powers_exp")
    keep = {k: v.copy() for k, v in inputs.items()}
    as_tensors = {k: torch.from_numpy(v) for k, v in inputs.items()}
    prog = tcore.iterative.matrix_powers(8, 32, "exp")
    te = tcore.IncrementalEngine(prog, device="cpu")
    tr = tcore.ReevalEngine(prog, device="cpu")
    te.initialize(as_tensors)
    tr.initialize(inputs)
    u, v = _updates((32, 32), 1, seed=5)[0]
    te.apply_update("A", u, v)
    tr.apply_update("A", u, v)
    for k in keep:
        np.testing.assert_array_equal(inputs[k], keep[k])
        np.testing.assert_array_equal(as_tensors[k].numpy(), keep[k])
    _assert_views(te.views, tr.views, "after one update")


def _alias_program(core, n=16):
    """Views that evaluate to an input (a bare Var) and to its transpose:
    without their own storage, an in-place apply to A would move them too."""
    prog = core.Program(name="alias")
    N = core.dim("n")
    A = prog.input("A", (N, N))
    B = prog.let("B", A)
    Bt = prog.let("Bt", core.transpose(A))
    prog.let("C", core.matmul(B, Bt))
    prog.bind_dims(n=n)
    return prog


def test_views_aliasing_an_input_get_their_own_storage():
    jprog, tprog = _alias_program(jcore), _alias_program(tcore)
    rng = np.random.default_rng(8)
    inputs = {"A": (rng.normal(size=(16, 16)) * 0.25).astype(np.float32)}
    je, jr = jcore.IncrementalEngine(jprog), jcore.ReevalEngine(jprog)
    te = tcore.IncrementalEngine(tprog, device="cpu")
    tr = tcore.ReevalEngine(tprog, device="cpu")
    for e in (je, te, jr, tr):
        e.initialize(inputs)
    ptrs = {k: v.untyped_storage().data_ptr() for k, v in te.views.items()}
    assert len(set(ptrs.values())) == len(ptrs)
    ups = _updates((16, 16), 5, seed=9)
    for u, v in ups[:2]:
        je.apply_update("A", u, v)
        te.apply_update("A", u, v)
    je.apply_updates("A", ups[2:])
    te.apply_updates("A", ups[2:])
    _replay(jr, tr, "A", ups)
    _assert_all(je, te, jr, tr)


@pytest.mark.parametrize("factor", ["var", "col_slice"])
def test_factor_sharing_a_written_view_reads_its_old_value(factor):
    """A factor block that shares storage with a view the same firing
    writes earlier must still carry the pre-update value (the delta
    derivation's contract), so the firing copies it before any apply."""
    n = 6
    prog = tcore.Program(name="alias_factor")
    A = prog.input("A", (n, 1))
    B = prog.input("B", (n, 1))
    du, dv = tcore.var("dU", (n, 1)), tcore.var("dV", (1, 1))
    f = B if factor == "var" else ColSlice.make(B, 0)
    trig = tcore.Trigger(
        "B", 1, du, dv, assigns=[tcore.Assign("f", f)],
        updates=[tcore.ViewUpdate("B", "lowrank", u="dU", v="dV"),
                 tcore.ViewUpdate("A", "lowrank", u="f", v="dV")])
    fn = tcore.build_trigger_fn(trig, prog, device="cpu")
    rng = np.random.default_rng(10)
    a0, b0, u = (rng.normal(size=(n, 1)).astype(np.float32)
                 for _ in range(3))
    scale = np.float32(0.5)
    views = {"A": torch.from_numpy(a0.copy()), "B": torch.from_numpy(b0.copy())}
    fn(views, torch.from_numpy(u), torch.full((1, 1), scale))
    np.testing.assert_allclose(views["B"].numpy(), b0 + u * scale, rtol=1e-6)
    np.testing.assert_allclose(views["A"].numpy(), a0 + b0 * scale, rtol=1e-6)


@pytest.mark.parametrize("name", ["ols", "powers_exp"])
def test_load_views_continues_a_jax_stream(name):
    """The JAX engine's mid-stream views become the port's state, and the
    stream continues in both packages to the same views."""
    build, inp, shape = PROGRAMS[name]
    je = jcore.IncrementalEngine(build(jcore, jax_ols))
    je.initialize(_inputs(name))
    ups = _updates(shape, 9, seed=11)
    for u, v in ups[:3]:
        je.apply_update(inp, u, v)
    te = tcore.IncrementalEngine(build(tcore, torch_ols), device="cpu")
    te.load_views({k: np.asarray(v) for k, v in je.views.items()})
    _assert_views(te.views_numpy(), je.views, "after the hand-over")
    for u, v in ups[3:6]:
        je.apply_update(inp, u, v)
        te.apply_update(inp, u, v)
    je.apply_updates(inp, ups[6:])
    te.apply_updates(inp, ups[6:])
    _assert_views(te.views, je.views, "after the continued stream")
    assert set(te.views_numpy()) == set(je.views)


def test_load_views_requires_every_view():
    te = tcore.IncrementalEngine(torch_ols(8, 4, 1), device="cpu")
    with pytest.raises(KeyError, match="beta"):
        te.load_views({"X": np.zeros((8, 4)), "Y": np.zeros((8, 1)),
                       "Z": np.eye(4), "W": np.eye(4)})


def test_float64_inputs_and_updates_become_float32():
    je, te, jr, tr, inp, shape = _engines("ols")
    inputs = {k: v.astype(np.float64) for k, v in _inputs("ols").items()}
    te.initialize(inputs)
    u, v = _updates(shape, 1, seed=12)[0]
    te.apply_update(inp, u.astype(np.float64), v.astype(np.float64))
    je.apply_update(inp, u, v)
    assert all(t.dtype == torch.float32 for t in te.views.values())
    _assert_views(te.views, je.views, "float64 callers")


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = torch_ols(8, 4, 1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcore.IncrementalEngine(prog)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcore.ReevalEngine(prog)
    assert tcore.IncrementalEngine(prog, device="cpu").device.type == "cpu"


def test_dropped_engines_free_their_views_without_the_collector():
    """Evaluation leaves no reference cycle behind: once the caller drops
    an engine, its views (device memory on the card) go at once, not when
    the garbage collector next runs."""
    import gc
    import weakref
    inputs = _inputs("powers_exp")
    prog = tcore.iterative.matrix_powers(8, 32, "exp")
    te = tcore.IncrementalEngine(prog, device="cpu")
    tr = tcore.ReevalEngine(prog, device="cpu")
    ups = _updates((32, 32), 4, seed=13)
    enabled = gc.isenabled()
    gc.disable()
    try:
        for e in (te, tr):
            e.initialize(inputs)
            e.apply_update("A", *ups[0])
        te.apply_updates("A", ups[1:])
        te.reevaluate()
        refs = [weakref.ref(v) for e in (te, tr) for v in e.views.values()]
        del te, tr, e
        assert [r for r in refs if r() is not None] == []
    finally:
        if enabled:
            gc.enable()
