"""The port's ``dist/``: checkpoints and fault tolerance, held against the
JAX package's.

The counterparts of ``tests/test_checkpoint.py``, ``tests/
test_fault_tolerance.py`` (but the training driver's test, in
``tests/test_torch_launch_train.py``) and the checkpoint and supervisor
cases of ``tests/test_guard.py``; then parity: the same numpy tree saved
by both managers gives equal manifests, payloads and checksums, a
checkpoint of either package restores in the other bit for bit, leaf
paths are ``jax.tree_util.keystr``'s, and one fake-clock script drives
both controllers to the same phases and events.  Last, the hazards only
the port has: its train step updates the state in place, its params must
require grad, its rng is a ``torch.Generator``.
"""

import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.dist import checkpoint as jax_ckpt
from repro.dist import fault_tolerance as jax_ft
from repro.guard import ChaosConfig as JaxChaosConfig
from repro.models import build_model as jax_build
from repro.train import optimizer as jax_opt
from repro.train.train_step import TrainState as JaxTrainState
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import synth_batch
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import fault_tolerance as ft
from repro_torch.dist import (CheckpointCorruptError, CheckpointManager,
                              FaultToleranceConfig, FaultTolerantController,
                              TrainingSupervisor, plan_mesh)
from repro_torch.guard import ChaosConfig
from repro_torch.models import LM, params_from_numpy
from repro_torch.serve import ServeEngine
from repro_torch.train import (TrainState, init_train_state,
                               make_train_step, opt_state_from_numpy,
                               require_grad)


def _tree(rng, scale=1.0):
    return {
        "w1": torch.tensor(rng.normal(size=(64, 48)) * scale,
                           dtype=torch.float32),
        "nested": {"b": torch.tensor(rng.normal(size=(48,)),
                                     dtype=torch.float32)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(tree):
    return [x for _, x in ckpt._leaf_paths(tree)]


def _assert_same(a, b):
    """Equal trees, bit for bit: tensors (dtype too), arrays, generators'
    states."""
    pa, pb = ckpt._leaf_paths(a), ckpt._leaf_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), p
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), p
        else:
            np.testing.assert_array_equal(x, y, err_msg=p)


def _low_rank(rng, n, m, r, scale=1.0):
    u = rng.normal(size=(n, r)).astype(np.float32) * scale
    v = rng.normal(size=(m, r)).astype(np.float32)
    return torch.from_numpy(u @ v.T)


# -- tests/test_checkpoint.py ------------------------------------------------

def test_full_roundtrip(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    t = _tree(rng)
    mgr.save(10, t, blocking=True)
    _assert_same(t, mgr.restore(t))


def test_incremental_roundtrip_low_rank_delta(tmp_path, rng):
    """A genuinely low-rank change round-trips near-exactly through the
    factored incremental checkpoint."""
    mgr = CheckpointManager(str(tmp_path), async_save=False,
                            incremental_rank=4, full_every=100)
    t = _tree(rng)
    mgr.save(0, t, blocking=True)
    t2 = dict(t, w1=t["w1"] + _low_rank(rng, 64, 48, 2))
    path = mgr.save(1, t2, blocking=True)
    with open(path + ".json") as f:
        assert json.load(f)["kind"] == "incremental"
    assert any(k.startswith("lr_p::") for k in np.load(path + ".npz"))
    restored = mgr.restore(t2, step=1)
    torch.testing.assert_close(restored["w1"], t2["w1"], rtol=1e-4,
                               atol=1e-4)


def test_incremental_falls_back_on_high_rank_delta(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), async_save=False,
                            incremental_rank=2, full_every=100,
                            max_rel_err=0.05)
    t = _tree(rng)
    mgr.save(0, t, blocking=True)
    noise = torch.tensor(rng.normal(size=(64, 48)), dtype=torch.float32)
    t2 = dict(t, w1=t["w1"] + noise)
    path = mgr.save(1, t2, blocking=True)
    # full-rank noise cannot be sketched at rank 2 → raw fallback
    assert any(k.startswith("raw::") for k in np.load(path + ".npz"))
    assert torch.equal(mgr.restore(t2, step=1)["w1"], t2["w1"])


def test_chained_incrementals(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), async_save=False,
                            incremental_rank=4, full_every=4, keep=10)
    cur = _tree(rng)
    trees = [cur]
    mgr.save(0, cur, blocking=True)
    for step in range(1, 6):
        cur = dict(cur, w1=cur["w1"] + _low_rank(rng, 64, 48, 1, 0.1))
        mgr.save(step, cur, blocking=True)
        trees.append(cur)
    for step in (0, 2, 5):
        restored = mgr.restore(trees[step], step=step)
        torch.testing.assert_close(restored["w1"], trees[step]["w1"],
                                   rtol=1e-3, atol=1e-3)


def test_latest_step_and_gc(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), async_save=False, keep=2,
                            full_every=1)
    t = _tree(rng)
    for s in range(6):
        mgr.save(s, t, blocking=True)
    assert mgr.latest_step() == 5
    assert len(mgr.all_steps()) <= 2


@pytest.fixture
def gated_writer(monkeypatch):
    """Hold every writer-thread gather until the test opens the gate, so
    that what the caller does after ``save`` returns surely happens
    before the gather."""
    gate = threading.Event()
    to_host = ckpt._to_host

    def gated(leaf):
        assert gate.wait(30)
        return to_host(leaf)

    monkeypatch.setattr(ckpt, "_to_host", gated)
    return gate


def test_async_save_snapshot_isolation(tmp_path, rng, gated_writer):
    """The caller-thread staging owns its buffers: writing into the live
    tree in place right after save() returns (the port's train step does)
    cannot corrupt the checkpoint, though the gather happens later on the
    writer thread."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    tree = {"w": torch.from_numpy(w.copy()), "host": w.copy()}
    mgr.save(1, tree)
    tree["host"][:] = -1.0
    tree["w"].zero_()
    gated_writer.set()
    mgr.wait()
    restored = mgr.restore({"w": torch.zeros(64, 48),
                            "host": np.zeros((64, 48), np.float32)}, step=1)
    assert torch.equal(restored["w"], torch.from_numpy(w))
    np.testing.assert_array_equal(restored["host"], w)


def test_async_incremental_chain_encodes_on_writer_thread(tmp_path, rng):
    """Incremental encoding (which diffs against the previous
    reconstructed base) still chains correctly when every save is
    staged async."""
    mgr = CheckpointManager(str(tmp_path), async_save=True,
                            incremental_rank=4, full_every=100)
    t = _tree(rng)
    mgr.save(0, t)
    t2 = dict(t, w1=t["w1"] + _low_rank(rng, 64, 48, 2))
    path = mgr.save(1, t2)
    mgr.wait()
    with open(path + ".json") as f:
        assert json.load(f)["kind"] == "incremental"
    torch.testing.assert_close(mgr.restore(t2, step=1)["w1"], t2["w1"],
                               rtol=1e-4, atol=1e-4)
    mgr.close()


def _port_state(cfg, seed=0):
    model = LM(cfg, device="cpu")
    return model, init_train_state(model,
                                   torch.Generator().manual_seed(seed))


def test_train_state_roundtrip(tmp_path):
    """A whole TrainState (params, opt, the generator) through the
    manager, bit for bit, into a template from another seed."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    _, state = _port_state(cfg)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, state, blocking=True)
    _assert_same(state, mgr.restore(_port_state(cfg, seed=9)[1]))


# -- the checkpoint and supervisor cases of tests/test_guard.py -------------

def _ckpt_tree(step, rng):
    return {"w": torch.from_numpy((rng.standard_normal((32, 16)) * 0.1
                                   + step).astype(np.float32)),
            "b": torch.full((16,), float(step))}


def _flip_tail(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - 64)
        f.write(b"\xff" * 32)


def test_checkpoint_checksum_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False,
                            incremental_rank=4, full_every=10)
    rng = np.random.default_rng(0)
    trees = {s: _ckpt_tree(s, rng) for s in range(4)}
    for s in range(4):
        mgr.save(s, trees[s])
    # corrupt the newest payload's array bytes (the zip still opens)
    _flip_tail(os.path.join(str(tmp_path), "ckpt_00000003.npz"))
    restored = mgr.restore(trees[3])
    assert mgr.last_restored_step == 2
    torch.testing.assert_close(restored["w"], trees[2]["w"], rtol=0,
                               atol=2e-3)


def test_checkpoint_all_corrupt_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = _ckpt_tree(0, np.random.default_rng(0))
    mgr.save(0, tree)
    _flip_tail(os.path.join(str(tmp_path), "ckpt_00000000.npz"))
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(tree)


def test_chaos_corrupts_and_manager_falls_back(tmp_path):
    """The chaos corrupt-checkpoint hook and the checksum fallback, end
    to end through the manager's own write path."""
    chaos = ChaosConfig(seed=3, corrupt_checkpoint_p=1.0).monkey()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    rng = np.random.default_rng(0)
    trees = {s: _ckpt_tree(s, rng) for s in range(2)}
    mgr.save(0, trees[0])          # intact
    mgr._chaos = chaos
    mgr.save(1, trees[1])          # corrupted on write
    assert chaos.corruptions == 1
    restored = mgr.restore(trees[1])
    assert mgr.last_restored_step == 0
    assert torch.equal(restored["b"], trees[0]["b"])


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _chaos_supervised_run(pkg, tmp_path):
    """tests/test_guard.py's supervisor under chaos (a host killed mid-run,
    half the checkpoints corrupted), with ``pkg``'s manager, controller
    and chaos; → (restarts, restores, alive hosts, last step, corruptions,
    events)."""
    Manager, Controller, Config, Supervisor, Corrupt, Chaos, leaf = pkg
    clock = FakeClock()
    chaos = Chaos(seed=7, corrupt_checkpoint_p=0.5, kill_host_p=0.0).monkey()
    mgr = Manager(str(tmp_path), async_save=False, chaos=chaos)
    ctl = Controller(4, Config(heartbeat_timeout=5.0, min_hosts=1),
                     clock=clock, chaos=chaos)
    state = {"step": -1, "restores": 0}

    def step_fn(t):
        clock.advance(1.0)
        state["step"] = t
        if t == 9:
            chaos._killed.add(2)  # deterministic mid-step host kill
        return 0.1

    def restore_fn():
        state["restores"] += 1
        if mgr.latest_step() is None:
            return 0
        try:
            mgr.restore({"step": leaf(0)})
        except Corrupt:
            return 0  # every checkpoint corrupt: restart from scratch
        return mgr.last_restored_step

    restarts = Supervisor(ctl, save_every=4).run(
        30, step_fn, lambda t: mgr.save(t, {"step": leaf(t)}), restore_fn,
        reporting_fn=lambda t: range(4))
    return (restarts, state["restores"], ctl.alive_hosts(), state["step"],
            chaos.corruptions, ctl.events)


def test_supervisor_survives_host_kill_and_corrupt_checkpoint(tmp_path):
    """The reference's case, and the same faults, restarts and events as
    the reference's manager and controller under the same chaos seed."""
    got = _chaos_supervised_run(
        (CheckpointManager, FaultTolerantController, FaultToleranceConfig,
         TrainingSupervisor, CheckpointCorruptError, ChaosConfig,
         lambda t: torch.tensor([t], dtype=torch.int64)), tmp_path / "port")
    want = _chaos_supervised_run(
        (jax_ckpt.CheckpointManager, jax_ft.FaultTolerantController,
         jax_ft.FaultToleranceConfig, jax_ft.TrainingSupervisor,
         jax_ckpt.CheckpointCorruptError, JaxChaosConfig,
         lambda t: np.asarray([t], np.int64)), tmp_path / "jax")
    restarts, restores, alive, last, corruptions, _ = got
    assert restarts >= 1 and restores >= 1       # the kill forced a restart
    assert 2 not in alive
    assert last == 29                            # and the run still finished
    assert corruptions >= 1   # the restore path really saw corruption
    assert got == want


# -- tests/test_fault_tolerance.py, each script on both controllers ----------

def _heartbeat_failure(ctl, clock, trace):
    for _ in range(3):
        clock.advance(2.0)
        for h in range(8):
            ctl.heartbeat(h, 0.1)
        trace.append(ctl.tick())
    assert trace[-1].value == "running"
    clock.advance(11.0)               # host 3 goes silent
    for h in range(8):
        if h != 3:
            ctl.heartbeat(h, 0.1)
    trace.append(ctl.tick())
    assert trace[-1].value == "reshaping" and 3 not in ctl.alive_hosts()
    ctl.complete_reshape()
    trace.append(ctl.phase)
    assert trace[-1].value == "running"


def _straggler(ctl, clock, trace):
    for _ in range(6):
        clock.advance(1.0)
        for h in range(8):
            ctl.heartbeat(h, 1.0 if h != 5 else 2.5)
        trace.append(ctl.tick())
    assert 5 not in ctl.alive_hosts()
    assert any("straggler" in e for e in ctl.events)


def _min_hosts_halt(ctl, clock, trace):
    clock.advance(11.0)
    ctl.heartbeat(0, 0.1)
    trace.append(ctl.tick())
    assert trace[-1].value == "halted"


def _rejoin(ctl, clock, trace):
    clock.advance(11.0)
    for h in range(7):
        ctl.heartbeat(h, 0.1)
    trace.append(ctl.tick())
    ctl.complete_reshape()
    ctl.rejoin(7)
    trace.append(ctl.phase)
    assert trace[-1].value == "reshaping"


def _all_at_once(ctl, clock, trace):
    """Heartbeats, a silent host, a straggler, a rejoin, then a halt."""
    for i in range(12):
        clock.advance(1.5)
        for h in range(8):
            if h == 6 and 3 <= i < 9:
                continue                  # host 6 silent, evicted at i = 8
            ctl.heartbeat(h, 3.0 if h == 2 else 1.0)
        trace.append(ctl.tick())
        if ctl.phase.value == "reshaping":
            ctl.complete_reshape()
        if i == 10:
            ctl.rejoin(6)
            trace.append(ctl.phase)
    clock.advance(20.0)               # everyone but host 0 goes silent
    ctl.heartbeat(0, 1.0)
    trace.append(ctl.tick())
    assert trace[-1].value == "halted"
    assert any("straggler host 2" in e for e in ctl.events)
    assert any("failed host 6" in e for e in ctl.events)
    assert "rejoin host 6" in ctl.events


SCRIPTS = {"heartbeat_failure": (_heartbeat_failure, {}),
           "straggler": (_straggler, {"straggler_factor": 1.5,
                                      "straggler_patience": 3}),
           "min_hosts_halt": (_min_hosts_halt, {"min_hosts": 8}),
           "rejoin": (_rejoin, {}),
           "all_at_once": (_all_at_once, {"straggler_factor": 2.0,
                                          "straggler_patience": 2,
                                          "min_hosts": 3})}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_controller_script_matches_reference(script):
    """Each of the reference's controller cases (and one that takes every
    transition in turn) on both controllers under one fake clock: the
    reference's checks hold for the port, and both give the same phases,
    events and survivors."""
    fn, opts = SCRIPTS[script]
    runs = []
    for mod in (ft, jax_ft):
        clock, trace = FakeClock(), []
        ctl = mod.FaultTolerantController(
            8, mod.FaultToleranceConfig(heartbeat_timeout=10.0, **opts),
            clock=clock)
        fn(ctl, clock, trace)
        runs.append(([p.value for p in trace], ctl.phase.value,
                     ctl.events, ctl.alive_hosts()))
    assert runs[0] == runs[1]


PLANS = [(256, 16, None), (512, 16, 256), (240, 16, None), (250, 16, None),
         (8, 1, None), (1, 1, None), (0, 1, None), (16, 0, None),
         (768, 16, 256), (500, 16, 256), (512, 24, 256), (12, 4, 16)]


@pytest.mark.parametrize("n,model,pod", PLANS)
def test_plan_mesh_matches_reference(n, model, pod):
    """The reference's shapes (256 → 16 × 16, two pods, 240 after a host of
    16 died, 250 refused) and more: the same plan or the same refusal."""
    def plan(fn):
        try:
            return fn(n, model, multi_pod_size=pod)
        except ValueError as e:
            return ("ValueError", str(e))
    assert plan(plan_mesh) == plan(jax_ft.plan_mesh)
    if (n, model, pod) == (256, 16, None):
        assert plan_mesh(n, model) == ((16, 16), ("data", "model"))
    if (n, model, pod) == (240, 16, None):
        assert plan_mesh(n, model) == ((15, 16), ("data", "model"))
    if (n, model, pod) == (512, 16, 256):
        assert plan_mesh(n, model, pod) == ((2, 16, 16),
                                            ("pod", "data", "model"))


def _supervised(mod, total, save_every, dead_at, start_step=0):
    clock = FakeClock()
    ctl = mod.FaultTolerantController(
        8, mod.FaultToleranceConfig(heartbeat_timeout=10.0), clock=clock)
    seen, saved, dead = [], [], set()

    def step_fn(step):
        clock.advance(1.0)
        seen.append(step)
        if step == dead_at:
            dead.add(2)  # host 2 stops heartbeating mid-run
        return 0.1

    restarts = mod.TrainingSupervisor(ctl, save_every=save_every).run(
        total, step_fn, saved.append,
        lambda: saved[-1] if saved else 0,
        reporting_fn=lambda step: [h for h in range(8) if h not in dead],
        start_step=start_step)
    return restarts, seen, saved, ctl.alive_hosts(), ctl.events


def test_supervised_run_with_injected_failure():
    """The loop restarts from the last checkpoint when a host dies
    mid-run and finishes every step, as the reference's does."""
    got = _supervised(ft, 40, 5, 12)
    restarts, seen, _, alive, _ = got
    assert restarts == 1 and 2 not in alive and seen[-1] == 39
    assert got == _supervised(jax_ft, 40, 5, 12)


def test_supervisor_run_start_step():
    """A resumed run enters the loop at start_step, not 0."""
    got = _supervised(ft, 8, 0, None, start_step=5)
    assert got[1] == [5, 6, 7]
    assert got == _supervised(jax_ft, 8, 0, None, start_step=5)


# -- parity: format, cross-restore, paths ------------------------------------

def _parity_trees(rng):
    """A full save and an incremental chain on numpy leaves: w1 moves by a
    low-rank delta (lr), w2 by noise (raw), b is 1-D (raw), frozen and
    step stay (same)."""
    t0 = {"w1": rng.normal(size=(64, 48)).astype(np.float32),
          "w2": rng.normal(size=(40, 24)).astype(np.float32),
          "nested": {"b": rng.normal(size=(48,)).astype(np.float32),
                     "frozen": rng.normal(size=(32, 16)).astype(np.float32)},
          "step": np.asarray(7, np.int32)}
    trees = [t0]
    for _ in range(2):
        prev = trees[-1]
        trees.append({
            "w1": prev["w1"] + _low_rank(rng, 64, 48, 2).numpy(),
            "w2": prev["w2"] + rng.normal(size=(40, 24)).astype(np.float32),
            "nested": {"b": prev["nested"]["b"] + np.float32(0.5),
                       "frozen": prev["nested"]["frozen"].copy()},
            "step": prev["step"].copy()})
    return trees


def _read(path):
    with open(path + ".json") as f:
        man = json.load(f)
    with np.load(path + ".npz") as npz:
        return man, {k: npz[k] for k in npz.files}


def _assert_same_checkpoint(a, b):
    (man_a, data_a), (man_b, data_b) = _read(a), _read(b)
    assert man_a == man_b
    assert sorted(data_a) == sorted(data_b)
    for k in data_a:
        assert data_a[k].dtype == data_b[k].dtype, k
        np.testing.assert_array_equal(data_a[k], data_b[k], err_msg=k)


def test_format_matches_reference(tmp_path, rng):
    """The same numpy tree through a full checkpoint, then an incremental
    chain with lr, raw and same leaves: equal manifests (checksums
    included) and payload arrays."""
    opts = dict(async_save=False, incremental_rank=4, full_every=10)
    port = CheckpointManager(str(tmp_path / "port"), **opts)
    ref = jax_ckpt.CheckpointManager(str(tmp_path / "jax"), **opts)
    kinds = set()
    for step, tree in enumerate(_parity_trees(rng)):
        a = port.save(step, tree, blocking=True)
        b = ref.save(step, tree, blocking=True)
        _assert_same_checkpoint(a, b)
        kinds |= {v["kind"] for v in _read(a)[0]["leaves"].values()}
    assert kinds == {"full", "lr", "raw", "same"}


def _reduced_pair(dtype):
    """The reference's (params, opt) of a reduced danube in ``dtype``, and
    the port's copy of it on the CPU."""
    cfg = dataclasses.replace(jax_config("h2o-danube-1.8b").reduced(),
                              dtype=dtype)
    params = jax.jit(jax_build(cfg).init)(jax.random.PRNGKey(0))
    opt = jax_opt.adamw_init(params)
    # a state a step away from init: moments and step nonzero
    opt = opt._replace(step=jnp.asarray(3, jnp.int32),
                       m=jax.tree.map(lambda x: x + 0.25, opt.m),
                       v=jax.tree.map(lambda x: x + 0.5, opt.v))
    host = jax.tree.map(np.asarray, (params, opt))
    port = (require_grad(params_from_numpy(host[0], "cpu")),
            opt_state_from_numpy(host[1], "cpu"))
    return (params, opt), port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_restore_with_the_reference(tmp_path, dtype):
    """A reduced danube's (params, opt), bf16 params stored as f32: both
    packages write equal checkpoints of it, the reference's restores into
    the port and the port's into the reference, bit for bit."""
    jax_tree, port_tree = _reduced_pair(dtype)
    a = CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        4, port_tree, blocking=True)
    b = jax_ckpt.CheckpointManager(str(tmp_path / "jax"),
                                   async_save=False).save(4, jax_tree,
                                                          blocking=True)
    _assert_same_checkpoint(a, b)
    # the reference's checkpoint into a zeroed port template
    template = ckpt._map_tree(lambda _, x: torch.zeros_like(x).requires_grad_(
        x.requires_grad), port_tree)
    got = CheckpointManager(str(tmp_path / "jax"),
                            async_save=False).restore(template)
    _assert_same(got, port_tree)
    assert all(x.requires_grad for x in _leaves(got[0]))
    # the port's checkpoint into a zeroed reference template
    back = jax_ckpt.CheckpointManager(str(tmp_path / "port"),
                                      async_save=False).restore(
        jax.tree.map(jnp.zeros_like, jax_tree))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jax_tree)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_leaf_paths_are_keystr():
    """The port's leaf paths are ``jax.tree_util.keystr``'s, in its order,
    on a TrainState-shaped tree and on sequences and None leaves."""
    jax_tree, (params, opt) = _reduced_pair("float32")
    jstate = JaxTrainState(params=jax_tree[0], opt=jax_tree[1],
                           rng=jax.random.PRNGKey(0))
    state = TrainState(params=params, opt=opt, rng=torch.Generator())
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    want = [jax.tree_util.keystr(kp) for kp, _ in flat]
    assert [p for p, _ in ckpt._leaf_paths(state)] == want
    assert ".opt.step" in want and ".rng" in want
    odd = {"z": [1.0, (2.0, None)], "a": {"y": 3.0, "b": None}, "m": None}
    flat, _ = jax.tree_util.tree_flatten_with_path(odd)
    assert [p for p, _ in ckpt._leaf_paths(odd)] == \
        [jax.tree_util.keystr(kp) for kp, _ in flat]


# -- hazards of the port -----------------------------------------------------

def _small_train(seed=0):
    cfg = get_config("h2o-danube-1.8b").reduced()
    model, state = _port_state(cfg, seed)
    step = make_train_step(model, lr=1e-3, warmup=1, total_steps=10)
    batch = synth_batch(cfg, ShapeConfig("t", 32, 2, "train"), seed=1)
    return cfg, state, step, batch


def _clone(state):
    """An owned copy of a tree of tensors and generators."""
    def copy(_, x):
        if isinstance(x, torch.Generator):
            gen = torch.Generator(device=x.device)
            gen.set_state(x.get_state())
            return gen
        return x.detach().clone()
    return ckpt._map_tree(copy, state)


def test_async_save_then_in_place_step_restores_the_pre_step_state(
        tmp_path, gated_writer):
    """The train step writes params, master, m and v in place: a state
    saved asynchronously, then stepped before the writer gathers it,
    still restores as it was when saved."""
    cfg, state, step, batch = _small_train()
    state, _ = step(state, batch)
    before = _clone(state)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, state)
    state, _ = step(state, batch)
    assert not torch.equal(state.opt.m["blocks"]["mlp"]["w_out"],
                           before.opt.m["blocks"]["mlp"]["w_out"])
    gated_writer.set()
    restored = mgr.restore(_port_state(cfg, seed=5)[1])
    _assert_same(restored, before)
    mgr.close()


def test_restored_params_require_grad_and_take_a_step(tmp_path):
    """Restored params are leaves that require grad, so the next step
    runs on them; a step from the restored state equals a step from the
    saved one, bit for bit."""
    cfg, state, step, batch = _small_train()
    state, _ = step(state, batch)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state)
    restored = mgr.restore(_port_state(cfg, seed=5)[1])
    assert all(p.requires_grad and p.is_leaf for p in _leaves(
        restored.params))
    assert not any(x.requires_grad for x in _leaves(restored.opt))
    a, ma = step(state, batch)
    b, mb = step(restored, batch)
    assert torch.equal(ma["loss"], mb["loss"])
    _assert_same(b.params, a.params)
    _assert_same(b.opt, a.opt)


def test_generator_round_trips_its_draws(tmp_path):
    """The rng leaf is a generator's state: the restored generator, a new
    one on the template's device, draws what the saved one draws next."""
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, {"rng": gen, "x": torch.ones(3)})
    got = mgr.restore({"rng": torch.Generator(), "x": torch.zeros(3)})
    assert got["rng"] is not gen and got["rng"].device == gen.device
    with open(os.path.join(str(tmp_path), "ckpt_00000000.json")) as f:
        assert json.load(f)["leaves"]["['rng']"]["dtype"] == "uint8"
    assert torch.equal(torch.rand(7, generator=got["rng"]),
                       torch.rand(7, generator=gen))


def test_serve_engine_checkpoint_hooks(tmp_path):
    """save_checkpoint / restore_checkpoint: the params come back bit for
    bit, the cache, position and logit views are reset, and a greedy
    generation after the restore equals a fresh engine's on the saved
    weights."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    saved = _clone(params)
    eng = ServeEngine(model, params, batch_size=2, max_seq=32)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    eng.save_checkpoint(mgr, 1)
    prompts = np.random.default_rng(4).integers(
        1, cfg.vocab, (2, 12)).astype(np.int32)
    eng.generate(prompts, max_new=4)
    eng._logit_views["lm_head"] = object()     # a view of the old weights
    for leaf in _leaves(eng.params):
        leaf.add_(1.0)                          # weights moved after save
    assert eng.restore_checkpoint(mgr) is eng
    _assert_same(eng.params, saved)
    assert eng._pos == 0 and eng._logit_views == {}
    assert all(not x.any() for x in _leaves(eng.cache))
    fresh = ServeEngine(model, saved, batch_size=2, max_seq=32)
    np.testing.assert_array_equal(eng.generate(prompts, max_new=6),
                                  fresh.generate(prompts, max_new=6))
