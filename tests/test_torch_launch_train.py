"""The port's training driver, ``repro_torch.launch.train``, held against
the JAX package's ``repro.launch.train``.

The counterparts of ``tests/test_fault_tolerance.py::
test_train_driver_runs_supervisor`` and ``tests/test_system.py::
test_lm_train_checkpoint_restart_resume``; the training driver's losses
against the reference's from the same initial state, and the same
restarts, events and step sequence under the same injected failure; the
command line's resume; compression's Q₀ drawn from the run's seed.
"""

import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as jax_train
from repro.dist import fault_tolerance as jax_ft
from repro.train.train_step import init_train_state as jax_init_state
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import synth_batch
from repro_torch.dist import CheckpointManager
from repro_torch.dist import fault_tolerance as port_ft
from repro_torch.dist.checkpoint import _leaf_paths
from repro_torch.launch import train as train_mod
from repro_torch.models import LM, params_from_numpy
from repro_torch.train import (TrainState, adamw_init, init_train_state,
                               make_train_step, require_grad)

# tests/test_torch_train.py's tolerance of the port's losses against the
# reference's
TOL = dict(rtol=2e-4, atol=2e-4)


def _cut(mod):
    """tests/test_fault_tolerance.py's cut of custom-10m."""
    return dataclasses.replace(mod.custom_10m(), n_layers=1, d_model=32,
                               d_ff=64, vocab=128, n_heads=2, n_kv_heads=2,
                               head_dim=16)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _injecting(ft_mod, clock, steps_seen, after):
    """A two-host controller whose host 1's heartbeat expires once
    ``after`` steps have drawn their batches (the reference test's)."""
    fired = {"done": False}

    class InjectingController(ft_mod.FaultTolerantController):
        def tick(self):
            if len(steps_seen) == after and not fired["done"]:
                fired["done"] = True
                self._last_seen[1] -= 100.0  # heartbeat long expired
            return super().tick()

    return InjectingController(
        2, ft_mod.FaultToleranceConfig(heartbeat_timeout=3.0), clock=clock)


def _drive(mod, monkeypatch, tmp_path, after=None, init=None, **kw):
    """Run ``mod.train`` on the cut for six steps, recording the step of
    each batch drawn (a fake clock advanced by 0.1 s a batch); with
    ``after``, host 1 fails once that many batches were drawn.  → (result,
    steps seen)."""
    clock, seen = FakeClock(), []
    orig = mod.synth_batch

    def counting_synth(*a, **k):
        seen.append(k.get("step"))
        clock.t += 0.1
        return orig(*a, **k)

    monkeypatch.setattr(mod, "synth_batch", counting_synth)
    if init is not None:
        monkeypatch.setattr(mod, "init_train_state", init)
    if after is not None:
        kw["controller"] = _injecting(
            jax_ft if mod is jax_train else port_ft, clock,
            seen, after)
    if mod is train_mod:
        kw["device"] = "cpu"
    result = mod.train(_cut(mod), steps=6, batch=2, seq=8, **kw)
    return result, seen


def test_train_driver_runs_supervisor(tmp_path, monkeypatch):
    """The training driver drives the restart/eviction controller: an injected
    mid-run failure causes a checkpoint restore and the run still
    finishes every step."""
    result, seen = _drive(train_mod, monkeypatch, tmp_path, after=4,
                          ckpt_dir=str(tmp_path), save_every=2,
                          log_every=100)
    assert result["restarts"] == 1
    assert result["phase"] == "running"
    assert any("failed host 1" in e for e in result["ft_events"])
    # the run resumed from the last checkpoint and completed all steps
    assert max(seen) == 5


def _reference_start():
    """The reference's initial state of the cut (seed 0), and a patch of
    the port's ``init_train_state`` that returns it carried across."""
    cfg = _cut(jax_train)
    state = jax_init_state(jax_train.build_model(cfg),
                           jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.params)

    def init(model, generator):
        p = require_grad(params_from_numpy(params, model.device))
        return TrainState(params=p, opt=adamw_init(p), rng=generator)

    return init


def test_driver_losses_match_reference(tmp_path, monkeypatch):
    """Six steps of both drivers from the same initial state, a loss
    logged every step: equal within the train tests' tolerance."""
    init = _reference_start()
    port, _ = _drive(train_mod, monkeypatch, tmp_path, init=init,
                     log_every=1)
    want, _ = _drive(jax_train, monkeypatch, tmp_path, log_every=1)
    assert [h["step"] for h in port["history"]] == \
        [h["step"] for h in want["history"]] == list(range(1, 7))
    np.testing.assert_allclose([h["loss"] for h in port["history"]],
                               [h["loss"] for h in want["history"]], **TOL)
    assert port["restarts"] == want["restarts"] == 0


def test_driver_failure_matches_reference(tmp_path, monkeypatch):
    """An injected failure after the fourth step: both drivers restore
    the same checkpoint and give the same restarts, events, phase and
    step sequence, and losses within the tolerance."""
    init = _reference_start()
    kw = dict(after=4, save_every=2, log_every=1)
    port, port_seen = _drive(train_mod, monkeypatch, tmp_path, init=init,
                             ckpt_dir=str(tmp_path / "port"), **kw)
    want, want_seen = _drive(jax_train, monkeypatch, tmp_path,
                             ckpt_dir=str(tmp_path / "jax"), **kw)
    # steps 2 and 3 run again from the checkpoint of step 2
    assert port_seen == want_seen == [0, 1, 2, 3, 2, 3, 4, 5]
    for key in ("restarts", "ft_events", "phase"):
        assert port[key] == want[key], key
    assert port["restarts"] == 1
    np.testing.assert_allclose([h["loss"] for h in port["history"]],
                               [h["loss"] for h in want["history"]], **TOL)


def test_lm_train_checkpoint_restart_resume(tmp_path):
    """Train a reduced LM, checkpoint, 'crash', restore, and the resumed
    state equals the uninterrupted run's (determinism of data and step),
    bit for bit on the CPU."""
    cfg = get_config("starcoder2-7b").reduced()
    model = LM(cfg, device="cpu")
    step = make_train_step(model, lr=1e-3)
    shape = ShapeConfig("t", 64, 4, "train")

    def batch_at(t):
        return synth_batch(cfg, shape, seed=3, step=t)

    def fresh():
        return init_train_state(model, torch.Generator().manual_seed(0))

    s_a = fresh()
    for t in range(6):
        s_a, _ = step(s_a, batch_at(t))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    s_b = fresh()
    for t in range(3):
        s_b, _ = step(s_b, batch_at(t))
    mgr.save(3, s_b, blocking=True)
    s_b = mgr.restore(fresh())   # "crash + restore" into a new state
    for t in range(3, 6):
        s_b, _ = step(s_b, batch_at(t))
    for tree_a, tree_b in ((s_a.params, s_b.params), (s_a.opt, s_b.opt)):
        for (_, a), (_, b) in zip(_leaf_paths(tree_a),
                                  _leaf_paths(tree_b)):
            assert torch.equal(a, b)


def test_command_line_resumes_from_its_checkpoint(tmp_path):
    """``python -m repro_torch.launch.train ... --ckpt-dir D``, twice: the
    second run resumes from the step the first one finished."""
    args = ["--arch", "custom-10m", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--save-every", "2"]
    out = []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_mod.main(args)
        out.append(buf.getvalue())
    assert "resumed" not in out[0] and "[train] step     4" in out[0]
    assert "[train] resumed from step 4" in out[1]
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]


def test_compression_draws_q0_from_the_seed():
    """``--compression-rank`` draws Q₀ from the run's seed (the same on
    every rank of a mesh, which keeps its blocks: the multi-rank run is
    ``tests/test_torch_recurrent_shard.py``), so two runs of one seed
    train the same."""
    cfg = get_config("zamba2-1.2b").reduced()
    runs = [train_mod.train(cfg, steps=2, batch=2, seq=16,
                            compression_rank=2, log_every=1,
                            device="cpu")["history"] for _ in range(2)]
    assert [h["loss"] for h in runs[0]] == [h["loss"] for h in runs[1]]


def test_driver_runs_on_the_card_by_default():
    """Without ``device``, the training driver wants the card; with none, it
    raises and names ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_mod.train(_cut(train_mod), steps=1, batch=2, seq=8)
