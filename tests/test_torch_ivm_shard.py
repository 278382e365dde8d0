"""repro_torch.dist.ivm_shard and the engine's ``mesh=`` against the JAX
package's single-device engine, on the CPU.

The reference's own mesh path fails under this JAX (ROADMAP.md Queue 3),
so it is no yardstick: the same seeded inputs and update streams go
through the reference's single-device ``IncrementalEngine`` (and its
``ReevalEngine``) and through the port's row-sharded engine on gloo
ranks — one rank in this process, four (and a two-rank sub-mesh) in
spawned processes (``tests/torch_shard_workers.py``), the counterparts of
``tests/test_dist_engine.py``, ``tests/test_planner.py:135`` and
``tests/test_distributed.py:38``.  The bounds are the reference's:
1e-4 of max(|want|, 1) against the single-device engine
(``tests/test_distributed.py:63-68``), 1e-3 against re-evaluation
(``tests/test_dist_engine.py:96``).
"""

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.apps.ols import build_ols_program as jax_ols
from repro.core.iterative import matrix_powers as jax_powers
from repro_torch.apps.ols import build_ols_program
from repro_torch.core import IncrementalEngine
from repro_torch.core.iterative import matrix_powers
from repro_torch.dist import ivm_shard
from repro_torch.plan import (TriggerCache, WorkloadDescriptor,
                              mesh_cache_key)

import torch_shard_workers as w

SINGLE_TOL = 1e-4   # against the single-device engine, of max(|want|, 1)
REEVAL_TOL = 1e-3   # against re-evaluation


def _rel(got: dict, want: dict, names=None) -> dict:
    names = names or sorted(want)
    return {k: float(np.abs(np.asarray(got[k], np.float64)
                            - np.asarray(want[k], np.float64)).max()
                     / max(float(np.abs(np.asarray(want[k])).max()), 1.0))
            for k in names}


def _jax_engine(prog, inputs, name, ups, singles=3, **kw):
    eng = jcore.IncrementalEngine(prog, **kw)
    eng.initialize({k: np.asarray(v) for k, v in inputs.items()})
    return w.drive(eng, name, ups, singles)


def _jax_reeval(prog, inputs, name, ups):
    ree = jcore.ReevalEngine(prog)
    ree.initialize(dict(inputs))
    for u, v in ups:
        ree.apply_update(name, u, v)
    return ree


def _views(eng) -> dict:
    return {k: np.asarray(v) for k, v in eng.views.items()}


# -- one rank in this process -------------------------------------------------


@pytest.mark.parametrize("planned", [False, True], ids=["engine", "planned"])
def test_one_rank_mesh_matches_reference(tmp_path, planned):
    """IncrementalEngine(mesh=...) on a one-rank mesh fires every trigger
    through the row-sharded apply; planned or not it matches the
    reference's single-device engine (``tests/test_dist_engine.py:48``,
    ``tests/test_planner.py:135``)."""
    n = 48
    A = w.powers_input(n)
    ups = w.updates(n, n, 6, seed=13)
    kw = ({"plan": WorkloadDescriptor(batch_size=100000)} if planned
          else {})
    with w.one_rank_mesh(tmp_path) as mesh:
        eng = IncrementalEngine(matrix_powers(k=8, n=n, model="exp"),
                                mesh=mesh, trigger_cache=TriggerCache(),
                                **kw)
        eng.initialize(A)
        w.drive(eng, "A", ups)
        got = eng.views_numpy()
        assert eng.stats.triggers_fired == 4
        assert (eng.stats.plan_reevals > 0) == planned
        if planned:
            assert eng.plan.mesh_key == mesh_cache_key(mesh)
    from repro.plan import WorkloadDescriptor as JWorkload
    jkw = {"plan": JWorkload(batch_size=100000)} if planned else {}
    ref = _jax_engine(jax_powers(k=8, n=n, model="exp"), A, "A", ups, **jkw)
    assert ref.stats.triggers_fired == 4
    assert max(_rel(got, _views(ref)).values()) < SINGLE_TOL


def test_mesh_device_and_engine_refusals(tmp_path):
    """The mesh picks the device: a disagreeing ``device`` raises, a
    ``"cuda"`` mesh without a card raises; a drift sentinel is taken (it
    probes the rank's row blocks)."""
    from repro_torch.guard import GuardConfig, SentinelConfig

    class CudaMesh:
        device_type = "cuda"

    with w.one_rank_mesh(tmp_path) as mesh:
        assert ivm_shard.mesh_device(mesh) == torch.device("cpu")
        prog = matrix_powers(k=4, n=16, model="exp")
        with pytest.raises(ValueError, match="disagrees"):
            IncrementalEngine(prog, mesh=mesh, device="meta")
        assert IncrementalEngine(prog, mesh=mesh,
                                 device="cpu").device.type == "cpu"
        eng = IncrementalEngine(prog, mesh=mesh, guard=GuardConfig(
            sentinel=SentinelConfig()))
        assert eng.guard.sentinel is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ivm_shard.mesh_device(CudaMesh())


def test_one_rank_layouts_round_trip(tmp_path):
    """shard_views keeps owned row blocks (the whole tensor at W = 1),
    gather_views gives the tensors back, and a planned engine's
    ``output`` and ``refresh`` read whole views."""
    rng = np.random.default_rng(4)
    views = {"a": rng.normal(size=(8, 3)).astype(np.float32),
             "s": np.ones((1, 1), np.float32)}
    with w.one_rank_mesh(tmp_path) as mesh:
        assert ivm_shard.row_spec(mesh, None, (8, 3)) == ("rows", None)
        assert ivm_shard.row_spec(mesh, None, (8,)) == ()
        loc = ivm_shard.shard_views(views, mesh)
        kinds = {k: ivm_shard.Shards(mesh).kind_of(v.shape)
                 for k, v in views.items()}
        back = ivm_shard.gather_views(loc, mesh, kinds)
        for k in views:
            np.testing.assert_array_equal(back[k].numpy(), views[k])
        inputs, ups = _ols_case()
        eng = IncrementalEngine(build_ols_program(96, 48, 1), mesh=mesh,
                                plan=WorkloadDescriptor(
                                    batch_size=16, reads_per_firing=1e-4),
                                trigger_cache=TriggerCache())
        eng.initialize(inputs)
        w.drive(eng, "X", ups)
        beta = eng.output("beta").numpy()
        eng.reevaluate()
        np.testing.assert_allclose(eng.output("beta").numpy(), beta,
                                   rtol=1e-3, atol=1e-3)
    ref = _jax_engine(jax_ols(96, 48, 1), inputs, "X", ups)
    assert _rel({"beta": beta}, _views(ref), ["beta"])["beta"] < SINGLE_TOL


def _ols_case():
    return w.ols_inputs(*w.OLS_SHAPE), w.updates(*w.OLS_SHAPE, 6, seed=7)


# -- four ranks in spawned processes ------------------------------------------


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Every four-rank scenario of tests/torch_shard_workers.py, run once
    in one spawn; results by rank."""
    return w.spawn_world(4, tmp_path_factory.mktemp("world4"))


def test_distributed_trigger_matches_single_device(world4):
    """build_distributed_trigger == the reference's single-device firing
    (``tests/test_distributed.py:38``)."""
    n = w.POWERS_N
    A = w.powers_input(n)
    ref = jcore.IncrementalEngine(jax_powers(k=w.POWERS_K, n=n, model="exp"),
                                  {"A": 1})
    ref.initialize(A)
    ref.apply_update("A", *w.updates(n, n, 8, seed=1)[0])
    got = world4[0]["trigger"]
    assert world4[0]["trigger_applies"] == 4
    assert max(_rel(got, _views(ref), ["A", "P2", "P4", "P8"]).values()) \
        < SINGLE_TOL


def test_engine_on_four_ranks_matches_reeval(world4):
    """The engine on a four-rank mesh against the reference's
    re-evaluation and its single-device engine
    (``tests/test_dist_engine.py:68``)."""
    n = w.POWERS_N
    A, ups = w.powers_input(n), w.updates(n, n, 8, seed=1)
    prog = jax_powers(k=w.POWERS_K, n=n, model="exp")
    got = world4[0]["engine"]
    assert world4[0]["engine_fired"] == 4
    assert world4[0]["engine_local_rows"] == n // 4
    ree = _jax_reeval(prog, A, "A", ups)
    assert _rel(got, _views(ree), ["P8"])["P8"] < REEVAL_TOL
    ref = _jax_engine(prog, A, "A", ups)
    assert max(_rel(got, _views(ref)).values()) < SINGLE_TOL


def test_planned_engine_on_four_ranks(world4):
    """A planned engine re-evaluates every view inside its firings on the
    mesh, matches re-evaluation, and a second engine on the same trigger
    cache builds nothing (``tests/test_dist_engine.py:110``)."""
    n = w.POWERS_N
    A, ups = w.powers_input(n), w.updates(n, n, 8, seed=1)
    res = world4[0]
    assert res["plan_reevals"] > 0
    first, second = res["misses"]
    assert first > 0 and second == first
    assert res["plan_mesh_key"] == res["key"]
    ree = _jax_reeval(jax_powers(k=w.POWERS_K, n=n, model="exp"), A, "A",
                      ups)
    for got in (res["planned"], res["planned_second"]):
        assert max(_rel(got, _views(ree)).values()) < REEVAL_TOL


def test_distributed_reeval_matmul(world4):
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(w.POWERS_N, w.POWERS_N)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(world4[0]["reeval_matmul"], a @ b,
                               rtol=1e-4, atol=1e-4)


def test_ols_on_four_ranks(world4):
    """OLS row-sharded: the trigger's inverse (Sherman-Morrison) runs on
    replicated factors, beta takes a dense update."""
    inputs, ups = _ols_case()
    prog = jax_ols(*w.OLS_SHAPE, 1)
    got = world4[0]["ols"]
    ref = _jax_engine(prog, inputs, "X", ups)
    assert max(_rel(got, _views(ref)).values()) < SINGLE_TOL
    ree = _jax_reeval(prog, inputs, "X", ups)
    assert _rel(got, _views(ree), ["beta"])["beta"] < REEVAL_TOL


def test_ragged_views_stay_replicated(world4):
    """n % W != 0: every view is replicated, equal on every rank bit for
    bit, and matches the reference."""
    n = w.RAGGED_N
    ref = _jax_engine(jax_powers(k=w.POWERS_K, n=n, model="exp"),
                      w.powers_input(n), "A", w.updates(n, n, 5, seed=3))
    got = world4[0]["ragged"]
    assert all(v.shape[0] == n for v in got.values())
    assert max(_rel(got, _views(ref)).values()) < SINGLE_TOL
    for rank in (1, 2, 3):
        for k, v in got.items():
            assert np.array_equal(world4[rank]["ragged"][k], v), (rank, k)


def test_replicated_values_bit_identical_across_ranks(world4):
    """The factor blocks a firing keeps replicated (matrix powers' dV,
    OLS's dU_Z, dV_Z, dV_W) are the same bits on every rank, and every
    rank gathers the same whole views."""
    assert sorted(world4[0]["rep_blocks"]) == ["dV_P2", "dV_P4", "dV_P8"]
    assert sorted(world4[0]["ols_rep_blocks"]) == ["dU_Z", "dV_W", "dV_Z"]
    for key in ("rep_blocks", "ols_rep_blocks", "trigger", "engine",
                "planned", "ols"):
        for rank in (1, 2, 3):
            for k, v in world4[0][key].items():
                assert np.array_equal(world4[rank][key][k], v), (key, rank,
                                                                 k)


def test_guarded_engine_on_two_ranks(world4):
    """A guarded engine writes out of place on a two-rank sub-mesh and
    matches the unguarded one and the reference."""
    n = w.POWERS_N
    for rank in (0, 1):
        res = world4[rank]
        assert res["guarded_out_of_place"] and res["guarded_rollbacks"] == 0
        assert max(_rel(res["guarded"], res["unguarded"]).values()) < 1e-6
    assert "guarded" not in world4[2]
    ref = _jax_engine(jax_powers(k=w.POWERS_K, n=n, model="exp"),
                      w.powers_input(n), "A", w.updates(n, n, 8, seed=1))
    assert max(_rel(world4[0]["guarded"], _views(ref)).values()) < SINGLE_TOL


def test_guard_verdict_agrees_across_ranks(world4):
    """A non-finite store on rank 0's rows alone rolls the firing back on
    both ranks of the sub-mesh: the flag is or-ed over the mesh, so no
    rank commits what another rolled back."""
    for rank in (0, 1):
        assert world4[rank]["planted_rollbacks"] == 1
        assert world4[rank]["planted_unchanged"]


@pytest.mark.parametrize("case", ["cascade", "queued", "carrier",
                                  "rowlocal", "adaptive"])
def test_engine_paths_on_four_ranks(world4, case):
    """The engine's other paths on a four-rank mesh against the reference's
    single-device engine: the deferred cascade (depth 2, folds on the
    mesh), the update queue, a row-local carrier (widened to the dense
    path on a mesh) on matrix powers and on a program whose views the
    compiler proves row-local, and an adaptive planner bound with the
    mesh."""
    from repro.core.factored import RowLocalCarrier as JCarrier
    from repro.plan import AdaptivePlanner as JAdaptive
    from repro.plan import WorkloadDescriptor as JWorkload
    n = w.POWERS_N
    A, ups = w.powers_input(n), w.updates(n, n, 8, seed=1)
    prog = jax_powers(k=w.POWERS_K, n=n, model="exp")
    res = world4[0]
    if case == "cascade":
        ref = _jax_engine(prog, A, "A", ups, order=2, fold_window=4)
        ref.flush()
        assert res["cascade_folds"] == ref.stats.folds > 0
    elif case == "queued":
        ref = _jax_engine(prog, A, "A", ups, singles=0)
        assert res["queued_fired"] == 2
    elif case == "carrier":
        ref = _jax_engine(prog, A, "A", [])
        ref.apply_update("A", JCarrier(*w.carrier_parts(n), n))
        assert res["carrier_widened"] == 1
    elif case == "rowlocal":
        n, m, _ = w.CHAIN
        ref = jcore.IncrementalEngine(w.chain_program(jcore))
        ref.initialize(w.chain_inputs())
        ref.apply_update("X", JCarrier(*w.carrier_parts(n, m), n))
        assert ref.stats.rowlocal_firings == 1
        assert res["rowlocal_widened"] == 1
        assert res["rowlocal_firings"] == 0
    else:
        ref = _jax_engine(prog, A, "A", ups, plan=JAdaptive(
            JWorkload(batch_size=2), replan_every=2))
        assert res["adaptive_key"] == res["key"]
    assert max(_rel(res[case], _views(ref)).values()) < SINGLE_TOL
    for rank in (1, 2, 3):
        for k, v in res[case].items():
            assert np.array_equal(world4[rank][case][k], v), (rank, k)


def test_firing_moves_skinny_bytes(world4):
    """The paper's §6 claim as a byte count on four ranks: a rank-1 firing
    of matrix powers moves at most c·n·K·4 bytes, where each of the
    trigger's collectives moves one skinny block (at most K columns, K the
    widest factor) at most twice, and c counts its products and applies;
    one re-evaluation product moves the n² all-gather."""
    n, world = w.BYTES_N, 4
    eng = jcore.IncrementalEngine(jax_powers(k=w.POWERS_K, n=n, model="exp"),
                                  {"A": 1})
    trig = eng.compiled.triggers["A"]
    products = sum(1 for a in trig.assigns for node in _nodes(a.expr)
                   if type(node).__name__ == "MatMul")
    c = 2 * (products + len(trig.updates))
    K = max(a.expr.shape[1] for a in trig.assigns
            if isinstance(a.expr.shape[1], int))
    firing = world4[0]["firing_bytes"]
    reeval = world4[0]["reeval_bytes"]
    moved = firing["all_gather"] + firing["all_reduce"]
    assert 0 < moved <= c * n * K * 4
    assert reeval["all_gather"] >= n * n * 4 * (world - 1) / world
    assert moved * 10 < reeval["all_gather"]


def _nodes(e):
    stack = [e]
    while stack:
        x = stack.pop()
        yield x
        stack.extend(x.children)


def test_mesh_keys_and_local_meshes(world4):
    """mesh_cache_key is hashable and equal for equal meshes; the local
    and the elastic mesh take plan_mesh's shape."""
    res = world4[0]
    assert res["key_equal"]
    assert res["key"] == ((("rows", 4),), "rows", "cpu", (0, 1, 2, 3))
    assert res["local_mesh"] == res["plan_mesh"]
    assert res["elastic_mesh"] == res["plan_mesh"]


@pytest.mark.parametrize("label,n", [("sentinel", w.POWERS_N),
                                     ("sentinel_ragged", w.RAGGED_N)])
def test_drift_sentinel_on_four_ranks(world4, label, n):
    """The drift sentinel on the four-rank engine (row blocks at n = 64;
    at n = 66 every view replicated, probed whole): every rank reads the
    same drifts, bit for bit, at every probe, and they are the port's
    single-device sentinel's within 1e-5 (absolute; the residuals'
    squares summed over the ranks' rows in another order).  P4 shifted
    by 0.05 drifts P4 and P8 (whose statement reads P4) past the
    tolerance on every rank; the recovery re-evaluates both on the mesh
    in their layout, after which no view drifts and the views match the
    single device's recovered views and the reference's re-evaluation."""
    from repro.core import ReevalEngine as JReeval
    single = w.sentinel_drive(IncrementalEngine(
        matrix_powers(k=w.POWERS_K, n=n, model="exp"),
        guard=w.sentinel_guard(), device="cpu"), n)
    tol = 5e-3                  # SentinelConfig().tol
    first = world4[0][label]
    assert first["probes"] == single["probes"] == 2
    for rank in range(4):
        got = world4[rank][label]
        for key in ("stream", "injected", "after"):
            assert got[key] == first[key], (rank, key)
            assert set(got[key]) == set(single[key])
            for view, d in single[key].items():
                assert abs(got[key][view] - d) <= 1e-5, (rank, key, view)
        assert got["recovered"] == single["recovered"] == ["P4", "P8"]
        assert min(got["injected"][v] for v in ("P4", "P8")) > tol
        assert max(got["after"].values()) < tol
        rows = n // 4 if n % 4 == 0 else n
        assert got["local_rows"]["P4"] == got["local_rows"]["P8"] == rows
    assert max(_rel(first["views"], single["views"]).values()) < SINGLE_TOL
    ups = w.updates(n, n, 8, seed=1)
    ree = _jax_reeval(jax_powers(k=w.POWERS_K, n=n, model="exp"),
                      w.powers_input(n), "A", ups)
    assert max(_rel(first["views"], _views(ree)).values()) < REEVAL_TOL
