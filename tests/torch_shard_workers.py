"""Rank bodies of the port's multi-rank CPU tests
(``tests/test_torch_ivm_shard.py``).

Spawned processes import this module, not the test file, so they load
``torch`` and the port only.  Every rank builds the same inputs from the
same seeds (the helpers below, which the test also uses for its JAX
references), joins a gloo group through a file store, drives the sharded
engines, and puts ``(rank, results)`` on a queue: numpy arrays and
counters, whole views gathered on every rank.
"""

from __future__ import annotations

import contextlib
import traceback

import numpy as np

POWERS_N = 64
POWERS_K = 8
OLS_SHAPE = (96, 48)
RAGGED_N = 66        # 66 % 4 != 0: every view replicated
BYTES_N = 512        # the byte count's matrix powers
GUARD_RANKS = 2      # the guarded engine's sub-mesh
#: the drift sentinel's probes on the mesh engine (every 2nd firing) and
#: the drift injected into P4 after the stream
SENTINEL = dict(probe_every=2, n_probes=2, seed=5)
SENTINEL_SHIFT = 0.05


def powers_input(n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"A": ((0.5 / np.sqrt(n)) * rng.normal(size=(n, n))
                  ).astype(np.float32)}


def ols_inputs(m: int, n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"X": rng.normal(size=(m, n)).astype(np.float32),
            "Y": rng.normal(size=(m, 1)).astype(np.float32)}


def updates(n: int, m: int, count: int, seed: int, scale: float = 0.02):
    rng = np.random.default_rng(seed)
    return [((scale * rng.normal(size=(n, 1))).astype(np.float32),
             (scale * rng.normal(size=(m, 1))).astype(np.float32))
            for _ in range(count)]


def carrier_parts(n: int, m: int = None):
    """A row-local delta on rows 3 and 10 of an n×m input (square by
    default): (rows, block, V)."""
    rng = np.random.default_rng(11)
    return (np.array([3, 10], np.int32),
            (0.02 * rng.normal(size=(2, 1))).astype(np.float32),
            (0.02 * rng.normal(size=(m or n, 1))).astype(np.float32))


CHAIN = (64, 32, 16)   # the chain program's N, M, K


def chain_program(core):
    """Y1 = X·W1, Y2 = Y1·W2 over ``core`` (the port's or the JAX
    package's): every view row-local under a row-local ΔX."""
    n, m, k = CHAIN
    p = core.Program(name="chain")
    X = p.input("X", (core.dim("N"), core.dim("M")))
    W1 = p.input("W1", (core.dim("M"), core.dim("K")))
    W2 = p.input("W2", (core.dim("K"), core.dim("K")))
    Y1 = p.let("Y1", core.matmul(X, W1))
    p.let("Y2", core.matmul(Y1, W2))
    p.outputs = ["Y1", "Y2"]
    return p.bind_dims(N=n, M=m, K=k)


def chain_inputs() -> dict:
    n, m, k = CHAIN
    rng = np.random.default_rng(12)
    return {"X": rng.standard_normal((n, m)).astype(np.float32),
            "W1": rng.standard_normal((m, k)).astype(np.float32),
            "W2": rng.standard_normal((k, k)).astype(np.float32)}


def drive(eng, name: str, ups, singles: int = 3):
    """``singles`` single updates, then the rest in one batch."""
    for u, v in ups[:singles]:
        eng.apply_update(name, u, v)
    if ups[singles:]:
        eng.apply_updates(name, ups[singles:])
    return eng


@contextlib.contextmanager
def one_rank_mesh(tmp_dir):
    """A one-rank gloo world in this process, through a file store in
    ``tmp_dir`` (no port to collide under several test workers), and its
    ``("rows",)`` CPU mesh; the group is destroyed on exit."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_dir}/store",
                            world_size=1, rank=0)
    try:
        yield _mesh(1)
    finally:
        dist.destroy_process_group()


def spawn_world(world: int, tmp_dir, timeout: float = 300.0,
                target=None, extra=()) -> dict:
    """Run ``target(rank, world, store, queue, *extra)`` (default
    :func:`run_rank`) on ``world`` spawned ranks; their results by rank.
    Raises if a rank fails, or does not report within ``timeout`` seconds
    (the ranks are then terminated)."""
    import multiprocessing as mp
    import queue as queue_mod
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target or run_rank,
                         args=(r, world, f"{tmp_dir}/store", q) + tuple(extra))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, res = q.get(timeout=timeout)
            if isinstance(res, str):
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            results[rank] = res
    except queue_mod.Empty:
        raise RuntimeError(f"ranks {sorted(set(range(world)) - set(results))}"
                           f" did not report in {timeout} s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return results


def _mesh(world: int, device_type: str = "cpu"):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.arange(world),
                      mesh_dim_names=("rows",))


def _replicated_blocks(eng, name: str, up, mesh) -> dict:
    """The factor blocks one more firing of ``eng`` keeps replicated
    (``ivm_shard.firing_values``), as numpy arrays."""
    import torch
    from repro_torch.dist import ivm_shard
    u, v = (torch.from_numpy(x) for x in up)
    vals = ivm_shard.firing_values(eng.compiled.triggers[name], eng.program,
                                   eng.views, u, v, mesh)
    return {a: t.numpy().copy() for a, (kind, t) in vals.items()
            if kind == "Rep"}


def _scenarios(rank: int, world: int) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.apps.ols import build_ols_program
    from repro_torch.core import IncrementalEngine
    from repro_torch.core.iterative import matrix_powers
    from repro_torch.dist import ivm_shard
    from repro_torch.dist.fault_tolerance import plan_mesh
    from repro_torch.guard import GuardConfig
    from repro_torch.launch.mesh import make_elastic_mesh, make_local_mesh
    from repro_torch.plan import (TriggerCache, WorkloadDescriptor,
                                  mesh_cache_key)

    out: dict = {}
    mesh = _mesh(world)
    n = POWERS_N
    A = powers_input(n)
    ups = updates(n, n, 8, seed=1)

    # build_distributed_trigger against one single-device firing
    prog = matrix_powers(k=POWERS_K, n=n, model="exp")
    single = IncrementalEngine(prog, {"A": 1}, device="cpu")
    single.initialize(A)
    trig = single.compiled.triggers["A"]
    fn = ivm_shard.build_distributed_trigger(trig, single.program, mesh)
    views = ivm_shard.shard_views(single.views, mesh)
    u, v = (torch.from_numpy(x) for x in ups[0])
    views = fn(views, u, v)
    kinds = ivm_shard.view_kinds(single.program, single.binding, world)
    out["trigger"] = {k: x.numpy() for k, x in ivm_shard.gather_views(
        views, mesh, kinds).items()}
    out["trigger_applies"] = fn.lowrank_applies

    # the engine, single updates and a batch
    eng = IncrementalEngine(matrix_powers(k=POWERS_K, n=n, model="exp"),
                            mesh=mesh)
    eng.initialize(A)
    drive(eng, "A", ups)
    out["engine"] = eng.views_numpy()
    out["engine_fired"] = eng.stats.triggers_fired
    out["engine_local_rows"] = int(eng.views["P8"].shape[0])
    out["rep_blocks"] = _replicated_blocks(eng, "A", ups[0], mesh)

    # planned: every view re-evaluated in the firing; a second engine on
    # the same trigger cache builds nothing
    cache = TriggerCache()
    wl = WorkloadDescriptor(batch_size=100000)
    planned = []
    for _ in range(2):
        e = IncrementalEngine(matrix_powers(k=POWERS_K, n=n, model="exp"),
                              mesh=mesh, plan=wl, trigger_cache=cache)
        e.initialize(A)
        drive(e, "A", ups)
        planned.append((e.views_numpy(), e.stats.plan_reevals,
                        cache.stats()["misses"]))
    out["planned"] = planned[0][0]
    out["planned_second"] = planned[1][0]
    out["plan_reevals"] = planned[0][1]
    out["misses"] = (planned[0][2], planned[1][2])
    out["plan_mesh_key"] = e.plan.mesh_key

    # OLS: an inverse in the trigger (Sherman-Morrison) and in the plan
    m_rows, n_cols = OLS_SHAPE
    ols = IncrementalEngine(build_ols_program(m_rows, n_cols, 1), mesh=mesh)
    ols.initialize(ols_inputs(m_rows, n_cols))
    drive(ols, "X", updates(m_rows, n_cols, 6, seed=7))
    out["ols"] = ols.views_numpy()
    out["ols_rep_blocks"] = _replicated_blocks(
        ols, "X", updates(m_rows, n_cols, 1, seed=8)[0], mesh)

    # a ragged n: every view replicated, compared bit for bit over ranks
    rag = IncrementalEngine(matrix_powers(k=POWERS_K, n=RAGGED_N,
                                          model="exp"), mesh=mesh)
    rag.initialize(powers_input(RAGGED_N))
    drive(rag, "A", updates(RAGGED_N, RAGGED_N, 5, seed=3))
    out["ragged"] = {k: x.numpy().copy() for k, x in rag.views.items()}

    # distributed_reeval_matmul against A @ B
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(n, n)).astype(np.float32) for _ in range(2))
    loc = ivm_shard.shard_views({"a": a, "b": b}, mesh)
    prod = ivm_shard.distributed_reeval_matmul(mesh)(loc["a"], loc["b"])
    out["reeval_matmul"] = ivm_shard.gather_views(
        {"c": prod}, mesh, {"c": "R"})["c"].numpy()

    # the §6 claim as bytes: one rank-1 firing against one reeval product
    nb = BYTES_N
    big = IncrementalEngine(matrix_powers(k=POWERS_K, n=nb, model="exp"),
                            mesh=mesh)
    big.initialize(powers_input(nb, seed=5))
    (ub, vb), = updates(nb, nb, 1, seed=9)
    ivm_shard.reset_bytes()
    big.apply_update("A", ub, vb)
    out["firing_bytes"] = dict(ivm_shard.BYTES)
    loc = {k: big.views[k] for k in ("A", "P2")}
    ivm_shard.reset_bytes()
    ivm_shard.distributed_reeval_matmul(mesh)(loc["A"], loc["P2"])
    out["reeval_bytes"] = dict(ivm_shard.BYTES)

    # a guarded engine (out of place) on a two-rank sub-mesh against the
    # unguarded one; every rank of the world makes the sub-mesh
    sub = _mesh(GUARD_RANKS)
    if rank < GUARD_RANKS:
        pair = []
        for guard in (None, GuardConfig()):
            e = IncrementalEngine(matrix_powers(k=POWERS_K, n=n,
                                                model="exp"),
                                  mesh=sub, guard=guard)
            e.initialize(A)
            drive(e, "A", ups)
            pair.append(e)
        out["guarded_out_of_place"] = pair[1]._out_of_place
        out["guarded"], out["unguarded"] = (e.views_numpy()
                                            for e in pair[::-1])
        out["guarded_rollbacks"] = pair[1].guard.stats.rollbacks

        # a firing that stores a non-finite value on rank 0's rows only
        # (of P8, which no factor reads, so no collective carries the NaN
        # to rank 1) rolls back on both ranks: the verdict is or-ed over
        # the mesh
        e = pair[1]
        if rank == 0:
            e.views["P8"][0, 0] = float("nan")
        before = {k: x.clone() for k, x in e.views.items()}
        e.apply_update("A", *ups[0])
        e.guard.sync()
        out["planted_rollbacks"] = e.guard.stats.rollbacks
        out["planted_unchanged"] = all(
            torch.equal(e.views[k], x) if rank else
            bool(torch.isclose(e.views[k], x, equal_nan=True).all())
            for k, x in before.items())

    # the deferred cascade (depth 2), the update queue, a row-local
    # carrier (widened on a mesh) and an adaptive planner on the mesh
    casc = IncrementalEngine(matrix_powers(k=POWERS_K, n=n, model="exp"),
                             mesh=mesh, order=2, fold_window=4)
    casc.initialize(A)
    drive(casc, "A", ups)
    out["cascade"] = casc.views_numpy()
    out["cascade_folds"] = casc.stats.folds
    queued = IncrementalEngine(matrix_powers(k=POWERS_K, n=n, model="exp"),
                               mesh=mesh, flush_size=4)
    queued.initialize(A)
    for u, v in ups:
        queued.enqueue_update("A", u, v)
    queued.flush()
    out["queued"] = queued.views_numpy()
    out["queued_fired"] = queued.stats.triggers_fired
    from repro_torch.core.factored import RowLocalCarrier
    from repro_torch.plan import AdaptivePlanner
    rows, block, vrow = carrier_parts(n)
    carried = IncrementalEngine(matrix_powers(k=POWERS_K, n=n, model="exp"),
                                mesh=mesh)
    carried.initialize(A)
    carried.apply_update("A", RowLocalCarrier(rows, block, vrow, n))
    out["carrier"] = carried.views_numpy()
    out["carrier_widened"] = carried.stats.widened_carriers
    # a program whose views are row-local: the carrier widens all the
    # same, since a rank holds a row block and the row trigger indexes
    # whole views
    from repro_torch import core
    rowlocal = IncrementalEngine(chain_program(core), mesh=mesh)
    rowlocal.initialize(chain_inputs())
    rows, block, vrow = carrier_parts(CHAIN[0], CHAIN[1])
    rowlocal.apply_update("X", RowLocalCarrier(rows, block, vrow, CHAIN[0]))
    out["rowlocal"] = rowlocal.views_numpy()
    out["rowlocal_widened"] = rowlocal.stats.widened_carriers
    out["rowlocal_firings"] = rowlocal.stats.rowlocal_firings
    adaptive = IncrementalEngine(
        matrix_powers(k=POWERS_K, n=n, model="exp"), mesh=mesh,
        plan=AdaptivePlanner(WorkloadDescriptor(batch_size=2),
                             replan_every=2), trigger_cache=TriggerCache())
    adaptive.initialize(A)
    drive(adaptive, "A", ups)
    out["adaptive"] = adaptive.views_numpy()
    out["adaptive_key"] = adaptive.planner.plan.mesh_key

    # the drift sentinel on the mesh engine: every rank probes its rows,
    # an injected drift is found on every rank and healed on the mesh
    for label, size in (("sentinel", n), ("sentinel_ragged", RAGGED_N)):
        out[label] = sentinel_drive(
            IncrementalEngine(matrix_powers(k=POWERS_K, n=size, model="exp"),
                              mesh=mesh, guard=sentinel_guard()), size)

    # meshes: keys, the local and the elastic mesh against plan_mesh
    out["key_equal"] = (mesh_cache_key(mesh) == mesh_cache_key(_mesh(world))
                        and hash(mesh_cache_key(mesh)) == hash(
                            mesh_cache_key(_mesh(world))))
    out["key"] = mesh_cache_key(mesh, "rows")
    local = make_local_mesh(2, device_type="cpu")
    elastic = make_elastic_mesh(world, 2, device_type="cpu")
    out["local_mesh"] = (tuple(local.shape), tuple(local.mesh_dim_names))
    out["elastic_mesh"] = (tuple(elastic.shape),
                           tuple(elastic.mesh_dim_names))
    out["plan_mesh"] = plan_mesh(world, 2)
    dist.barrier()
    return out


def sentinel_guard():
    from repro_torch.guard import GuardConfig, SentinelConfig
    return GuardConfig(sentinel=SentinelConfig(**SENTINEL))


def sentinel_drive(eng, n: int) -> dict:
    """Matrix powers at ``n`` through a sentinel-guarded engine (on a mesh
    or one device): the stream of :func:`drive` (the sentinel probes at
    its cadence), then SENTINEL_SHIFT added to every entry of P4, a
    probe, the recovery of the views it finds drifted, and a probe
    after; the drifts, the recovered names, the views and their local
    shapes."""
    eng.initialize(powers_input(n))
    drive(eng, "A", updates(n, n, 8, seed=1))
    eng.guard.sync()
    sentinel = eng.guard.sentinel
    out = {"probes": sentinel.probes, "stream": dict(sentinel.last_drift)}
    eng.views["P4"].add_(SENTINEL_SHIFT)
    out["injected"] = sentinel.probe(eng)
    out["recovered"] = sentinel.recover(eng, sentinel.drifted_views())
    out["after"] = sentinel.probe(eng)
    out["views"] = eng.views_numpy()
    out["local_rows"] = {k: int(v.shape[0]) for k, v in eng.views.items()}
    return out


def run_rank(rank: int, world: int, store: str, queue) -> None:
    """One rank of the W-rank CPU world: join it through the file store
    ``store``, run every scenario, put ``(rank, results)`` (or
    ``(rank, traceback)``) on ``queue``, and leave the group."""
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        try:
            queue.put((rank, _scenarios(rank, world)))
        finally:
            dist.destroy_process_group()
    except BaseException:   # noqa: BLE001 — reported to the parent
        queue.put((rank, traceback.format_exc()))
        raise
