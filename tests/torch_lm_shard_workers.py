"""Rank bodies of the port's sharded-model tests
(``tests/test_torch_lm_shard.py``).

Spawned processes import this module, not the test file, so they load
``torch`` and the port only.  The test writes the inputs (the reference's
params as numpy arrays, tokens, activations, gradients) to a pickle; every
rank reads it, joins a four-rank gloo group through a file store, runs
each scenario on the ``(2, 2)`` and ``(1, 4)`` meshes of that world (the
``"cache_seq"`` decodes and the vlm and audio families under
``"seq_sp"`` among them), and puts ``(rank, results)`` on a queue: numpy
arrays gathered whole and counters.  Then each rank leaves the group and runs the training
driver's ``--mesh local`` twice (a run and its resume), each through a
world of its own.
"""

from __future__ import annotations

import dataclasses
import pickle
import traceback

import numpy as np

WORLD = 4
DANUBE_TOKENS = (8, 64)
MOE_TOKENS = (4, 32)
CAP_ROWS = (4, 1100)     # T_local = 2200 on two data ranks: T·k > 4096
LAUNCH_ARGS = ["--arch", "custom-10m", "--batch", "4", "--seq", "64",
               "--save-every", "2", "--log-every", "1", "--device", "cpu"]
LAUNCH_STEPS = (4, 6)    # the first run's steps, then the resumed run's
RESTART_HOLD = 0.5       # seconds rank 0 holds back each checkpoint write


def danube_cfg(get_config):
    """Reduced h2o-danube-1.8b (f32, 4 heads, one KV head of 32)."""
    return get_config("h2o-danube-1.8b").reduced()


def qwen3_cfg(get_config, capacity_factor: float = 8.0):
    """Reduced qwen3-moe-235b-a22b (8 experts, top-2) at a capacity
    factor."""
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


def qwen2_cfg(get_config):
    """Reduced qwen2-moe-a2.7b with 6 experts: 6 % 4 != 0, so model = 4
    takes tensor parallelism inside every expert and the shared one."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=6))


#: the decodes under {"cache_seq": "model"}: (label, inputs, mesh, cache
#: length, prefill positions, last position): danube with a ring of 16
#: slots (RING_WINDOW; 4 a rank on (1, 4), 8 on (2, 2)), prefilled with
#: fewer positions than one rank's slots, decoded past one rank's slots
#: and past the wrap; qwen2-moe's full cache of 12 slots (3 a rank), its
#: KV heads split over the model axis and gathered for the write
RING_WINDOW = 16
#: the mesh ServeEngine's (B, prompt positions) and greedy tokens, and
#: the serving CLI's --mesh local run: (B, prompt positions, new tokens)
SERVE_PROMPT, SERVE_NEW = (4, 3), 20
SERVE_CLI = (4, 8, 8)
CACHE_SEQ_CASES = [("danube_14", "danube", "14", 64, 3, 24),
                   ("danube_22", "danube", "22", 64, 3, 24),
                   ("qwen2_14", "qwen2", "14", 12, 2, 12)]
CACHE_SEQ_RULES = {"cache_seq": "model"}


def cache_seq_cfg(get_config, key: str):
    """The config of a cache_seq decode: danube's with a window of
    RING_WINDOW (so its cache is a ring that wraps), qwen2-moe's."""
    if key == "danube":
        return dataclasses.replace(danube_cfg(get_config),
                                   sliding_window=RING_WINDOW)
    return qwen2_cfg(get_config)


#: the families whose loss has its own reduction on a mesh: the vlm's
#: prefix (text positions only) and the audio encoder's masked mean
FAMILIES = {"vlm": "paligemma-3b", "audio": "hubert-xlarge"}
FAMILY_BATCH = (4, 48)


def family_cfg(get_config, family: str):
    return get_config(FAMILIES[family]).reduced()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _layer(tree, i: int = 0):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _loss_and_grads(model, params, batch):
    """(global loss, gradients averaged over the data ranks) of local
    params, on the global ``batch``."""
    import torch
    from repro_torch.train.optimizer import leaves, unflatten
    from repro_torch.train.train_step import data_rows, mean_over_data
    loss, _ = model.loss(params, data_rows(batch))
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                materialize_grads=True)
    return float(loss), mean_over_data(unflatten(params, grads))


def _danube(inputs, mesh, ckpt_dir: str) -> dict:
    """The (2, 2) train step: loss and gathered gradients, the params
    after one step, after one step with 2 microbatches and remat, the
    bytes of a step; then a save of the stepped state."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import CheckpointManager
    from repro_torch.dist.sharding import (BYTES, gather_tree, reset_bytes,
                                           shard_tree, use_sharding)
    from repro_torch.models import LM, params_from_numpy
    from repro_torch.train import (TrainState, adamw_init, make_train_step,
                                   require_grad, train_state_specs)
    cfg = danube_cfg(get_config)
    model = LM(cfg, device="cpu")
    batch = {"tokens": inputs["danube"]["tokens"]}
    out = {}

    def fresh(specs):
        full = params_from_numpy(inputs["danube"]["params"], "cpu")
        return require_grad(shard_tree(full, specs))

    with use_sharding(mesh):
        specs = model.param_specs()
        params = fresh(specs)
        out["local_shapes"] = {k: tuple(v.shape) for k, v in
                               params["blocks"]["attn"].items()}
        out["loss"], grads = _loss_and_grads(model, params, batch)
        out["grads"] = _np(gather_tree(grads, specs))
        state = TrainState(params, adamw_init(params), torch.Generator())
        reset_bytes()
        state, metrics = make_train_step(model)(state, batch)
        out["bytes"] = dict(BYTES)
        out["step_loss"] = float(metrics["loss"])
        out["step_params"] = _np(gather_tree(state.params, specs))
        # the saved state, whole, for the elastic re-mesh
        mgr = CheckpointManager(ckpt_dir, async_save=False)
        mgr.save(1, state, blocking=True, specs=train_state_specs(model))
        out["saved_opt_m"] = _np(gather_tree(state.opt.m, specs))

        remat = LM(dataclasses.replace(cfg, remat="block"), device="cpu")
        out["remat_thread"] = _backward_in_a_thread(remat, fresh(specs),
                                                    batch)
        params = fresh(specs)
        state = TrainState(params, adamw_init(params), torch.Generator())
        state, metrics = make_train_step(remat, microbatches=2)(state, batch)
        out["micro_loss"] = float(metrics["loss"])
        out["micro_params"] = _np(gather_tree(state.params, specs))
    return out


def _backward_in_a_thread(model, params, batch) -> str:
    """The remat'd loss's gradients taken in a new thread (as autograd's
    device thread takes them on the card: without the caller's context
    variables) against the same in this thread: "equal", or the error."""
    import threading
    import torch
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.train_step import data_rows
    rows = data_rows(batch)
    box = {}

    def run():
        try:
            box["grads"] = torch.autograd.grad(loss, leaves(params))
        except BaseException as e:   # noqa: BLE001 — reported
            box["error"] = repr(e)

    loss, _ = model.loss(params, rows)
    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    if "error" in box:
        return box["error"]
    loss, _ = model.loss(params, rows)
    want = torch.autograd.grad(loss, leaves(params))
    same = all(torch.equal(a, b) for a, b in zip(box["grads"], want))
    return "equal" if same else "differ"


def _remesh(rank: int, inputs, ckpt_dir: str) -> dict:
    """The elastic re-mesh: plan_mesh(2, 2)'s (1, 2) sub-mesh over the
    first two ranks restores the (2, 2) run's checkpoint and steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import CheckpointManager
    from repro_torch.dist.fault_tolerance import plan_mesh
    from repro_torch.dist.sharding import gather_tree, use_sharding
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import LM
    from repro_torch.train import (init_train_state, make_train_step,
                                   train_state_specs)
    out = {"plan": plan_mesh(2, 2)}
    sub = make_elastic_mesh(2, 2, device_type="cpu")   # every rank makes it
    out["mesh"] = (tuple(sub.shape), tuple(sub.mesh_dim_names))
    if rank >= 2:
        return out
    cfg = danube_cfg(get_config)
    model = LM(cfg, device="cpu")
    with use_sharding(sub):
        fresh = init_train_state(model, torch.Generator().manual_seed(7))
        specs = train_state_specs(model)
        mgr = CheckpointManager(ckpt_dir, async_save=False)
        state = mgr.restore(fresh, step=1, specs=specs)
        out["restored_step"] = mgr.last_restored_step
        out["local_wq"] = tuple(state.params["blocks"]["attn"]["wq"].shape)
        out["params"] = _np(gather_tree(state.params, specs.params))
        out["opt_m"] = _np(gather_tree(state.opt.m, specs.params))
        out["opt_step"] = int(state.opt.step)
        _, metrics = make_train_step(model)(
            state, {"tokens": inputs["danube"]["tokens"]})
        out["loss"] = float(metrics["loss"])
    return out


def _restart(rank: int, mesh, tmp: str) -> dict:
    """The training driver on ``mesh`` under an injected failure: host 1
    falls silent at the tick right after the async save of step 2, while
    rank 0's write of it is held back RESTART_HOLD seconds; then the same
    run with no failure.  Per rank: the step each restore loaded and the
    restarts; on rank 0 both runs' final checkpoints, whole."""
    import time
    from repro_torch.configs import get_config
    from repro_torch.dist import CheckpointManager
    from repro_torch.dist.fault_tolerance import FaultTolerantController
    from repro_torch.launch import train as train_mod

    class FailAfterSave(FaultTolerantController):
        """Two hosts; host 1's heartbeat expires at the third tick, the
        one after step index 2 (the save of step 2 follows the second)."""

        def __init__(self):
            super().__init__(2)
            self.ticks = 0

        def tick(self):
            self.ticks += 1
            if self.ticks == 3:
                self._last_seen[1] -= 1e6
            return super().tick()

    restored = []
    restore, savez = CheckpointManager.restore, np.savez

    def recording(self, *a, **k):
        out = restore(self, *a, **k)
        restored.append(self.last_restored_step)
        return out

    def held(*a, **k):
        time.sleep(RESTART_HOLD)
        return savez(*a, **k)

    cfg = danube_cfg(get_config)
    out, final = {}, {}
    for label, ctl in (("failed", FailAfterSave()),
                       ("clean", FaultTolerantController(2))):
        ckpt = f"{tmp}/restart_{label}"
        CheckpointManager.restore = recording
        if rank == 0 and label == "failed":
            np.savez = held
        try:
            result = train_mod.train(cfg, steps=4, batch=4, seq=32,
                                     ckpt_dir=ckpt, save_every=2,
                                     log_every=100, mesh=mesh,
                                     controller=ctl)
        finally:
            CheckpointManager.restore, np.savez = restore, savez
        out[f"{label}_restarts"] = result["restarts"]
        if rank == 0:
            final[label] = CheckpointManager(
                ckpt, async_save=False)._reconstruct(4)
    out["restored"] = restored
    out.update(final)
    return out


def _moe(inputs, mesh, key: str, cfg, grads: bool) -> dict:
    """A MoE config on ``mesh``: the gathered logits of the forward, the
    layer-0 MoE block given the same input, and (``grads``) the loss and
    gathered gradients."""
    import torch
    from repro_torch.dist.sharding import (MODEL, current_ctx, gather,
                                           gather_tree, shard_tree,
                                           use_sharding)
    from repro_torch.models import LM, moe, params_from_numpy
    from repro_torch.train import require_grad
    from repro_torch.train.train_step import data_rows
    case = inputs[key]
    model = LM(cfg, device="cpu")
    out = {}
    with use_sharding(mesh):
        ctx = current_ctx()
        specs = model.param_specs()
        params = require_grad(shard_tree(
            params_from_numpy(case["params"], "cpu"), specs))
        out["local_w_in"] = tuple(params["blocks"]["moe"]["w_in"].shape)
        batch = {"tokens": case["tokens"]}
        with torch.no_grad():
            logits, _ = model.forward(params, data_rows(batch))
            out["logits"] = gather(gather(logits, -1, MODEL), 0,
                                   ctx.batch_axes).numpy()
            x = data_rows({"x": case["x"]})["x"]
            y = moe.moe_block(_layer(params["blocks"]["moe"]), cfg, x)
            out["block"] = gather(y, 0, ctx.batch_axes).numpy()
        if grads:
            out["loss"], g = _loss_and_grads(model, params, batch)
            out["grads"] = _np(gather_tree(g, specs))
    return out


def _family(inputs, mesh, family: str, rules=None) -> dict:
    """A vlm or audio reduced config on (2, 2) under ``rules``: the loss
    of the global batch and the gradients, averaged over the data ranks
    and gathered."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (gather_tree, shard_tree,
                                           use_sharding)
    from repro_torch.models import LM, params_from_numpy
    from repro_torch.train import require_grad
    case = inputs[family]
    model = LM(family_cfg(get_config, family), device="cpu")
    with use_sharding(mesh, rules):
        specs = model.param_specs()
        params = require_grad(shard_tree(
            params_from_numpy(case["params"], "cpu"), specs))
        loss, grads = _loss_and_grads(model, params, case["batch"])
        return {"loss": loss, "grads": _np(gather_tree(grads, specs))}


def _capacity(inputs, mesh) -> dict:
    """qwen3 at capacity factor 1.25 on (2, 2): the layer-0 block over
    each data shard's 2200 tokens, and the aux averaged over the
    shards."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (batch_mean, current_ctx, gather,
                                           shard_tree, use_sharding)
    from repro_torch.models import LM, moe, params_from_numpy
    from repro_torch.train.train_step import data_rows
    cfg = qwen3_cfg(get_config, 1.25)
    model = LM(cfg, device="cpu")
    with use_sharding(mesh), torch.no_grad():
        ctx = current_ctx()
        params = shard_tree(params_from_numpy(inputs["qwen3"]["params"],
                                              "cpu"), model.param_specs())
        x = data_rows({"x": inputs["qwen3"]["x_cap"]})["x"]
        y, aux = moe.moe_block(_layer(params["blocks"]["moe"]), cfg, x,
                               return_aux=True)
        return {"block": gather(y, 0, ctx.batch_axes).numpy(),
                "aux": float(batch_mean(aux)), "rank_aux": float(aux)}


def _decode(inputs, mesh, key: str, cfg, steps: int = 6) -> dict:
    """The first ``steps`` tokens of ``inputs[key]`` decoded one a step
    from an empty cache on ``mesh`` (each rank its data rows, its heads,
    experts and vocab shard), every step's logits gathered whole, against
    the single-device decode of the same params: the largest difference
    and the largest logit."""
    import torch
    from repro_torch.dist.sharding import (MODEL, current_ctx, gather,
                                           shard_tree, use_sharding)
    from repro_torch.models import LM, params_from_numpy
    from repro_torch.train.train_step import data_rows
    case = inputs[key]
    model = LM(cfg, device="cpu")
    whole = params_from_numpy(case["params"], "cpu")
    tokens = torch.as_tensor(case["tokens"][:, :steps])
    with torch.no_grad():
        cache = model.init_cache(tokens.shape[0], steps)
        want = [model.decode_step(whole, cache, tokens[:, i:i + 1], i)[0]
                for i in range(steps)]
        with use_sharding(mesh):
            ctx = current_ctx()
            params = shard_tree(whole, model.param_specs())
            rows = data_rows({"tokens": tokens})["tokens"]
            cache = model.init_cache(rows.shape[0], steps)
            got = []
            for i in range(steps):
                logits, cache = model.decode_step(params, cache,
                                                  rows[:, i:i + 1], i)
                got.append(gather(gather(logits, -1, MODEL), 0,
                                  ctx.batch_axes))
    return {"max_diff": max(float((g - w).abs().max())
                            for g, w in zip(got, want)),
            "max_logit": max(float(w.abs().max()) for w in want),
            "local_wq": tuple(params["blocks"]["attn"]["wq"].shape),
            "local_wk": tuple(params["blocks"]["attn"]["wk"].shape)}


def _cache_seq_decode(inputs, mesh, key: str, max_seq: int, prompt: int,
                      last: int) -> dict:
    """``inputs[key]``'s tokens under ``{"cache_seq": "model"}``: a batched
    prefill of the first ``prompt`` positions into the rank's block of
    the cache's slots, then one decode step a position up to ``last``;
    the prefill's last logits and each step's, gathered whole, the cache
    block's shape and spec, and one step's bytes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (BYTES, MODEL, current_ctx, gather,
                                           reset_bytes, shard_tree,
                                           use_sharding)
    from repro_torch.models import LM, params_from_numpy
    from repro_torch.train.train_step import data_rows
    cfg = cache_seq_cfg(get_config, key)
    model = LM(cfg, device="cpu")
    tokens = torch.as_tensor(inputs[key]["tokens"][:, :last])
    out = {"logits": []}
    with torch.no_grad(), use_sharding(mesh, CACHE_SEQ_RULES):
        ctx = current_ctx()
        params = shard_tree(params_from_numpy(inputs[key]["params"], "cpu"),
                            model.param_specs())
        specs = model.cache_specs(tokens.shape[0], max_seq)
        rows = data_rows({"t": tokens})["t"]

        def whole(x):
            return gather(gather(x, -1, MODEL), 0, ctx.batch_axes)

        logits, cache = model.prefill(params, {"tokens": rows[:, :prompt]},
                                      max_seq, specs=specs)
        out["logits"].append(whole(logits[:, -1]).numpy())
        for i in range(prompt, last):
            reset_bytes()
            logits, cache = model.decode_step(params, cache,
                                              rows[:, i:i + 1], i, specs)
            out["logits"].append(whole(logits[:, 0]).numpy())
            if i == prompt:
                out["step_bytes"] = dict(BYTES)
        out["cache_shape"] = tuple(cache["kv"]["k"].shape)
        out["cache_spec"] = tuple(specs["kv"]["k"])
    return out


def _serve(inputs, mesh) -> dict:
    """A ``ServeEngine`` made under ``{"cache_seq": "model"}`` on ``mesh``
    (the rank's params, its block of the ring's slots) generating
    SERVE_NEW greedy tokens from danube's first SERVE_PROMPT tokens,
    past the ring's wrap, called outside the placement (the engine
    installs its own); the single device's engine on the same params."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import shard_tree, use_sharding
    from repro_torch.models import LM, params_from_numpy
    from repro_torch.serve import ServeEngine
    model = LM(cache_seq_cfg(get_config, "danube"), device="cpu")
    whole = params_from_numpy(inputs["danube"]["params"], "cpu")
    b, s = SERVE_PROMPT
    prompts = inputs["danube"]["tokens"][:b, :s]
    with torch.no_grad():
        single = ServeEngine(model, whole, batch_size=b, max_seq=64)
        want = single.generate(prompts, max_new=SERVE_NEW)
        with use_sharding(mesh, CACHE_SEQ_RULES):
            eng = ServeEngine(model, shard_tree(whole, model.param_specs()),
                              batch_size=b, max_seq=64)
        got = eng.generate(prompts, max_new=SERVE_NEW)
    return {"got": got, "want": want,
            "cache_block": tuple(eng.cache["kv"]["k"].shape)}


def _psum(rank: int, inputs) -> dict:
    """compressed_psum over a 1-D ("data",) mesh of the four ranks: the
    same rank-1 gradient on every rank, then a different one on each."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.train import compressed_psum, init_compression
    case = inputs["psum"]
    mesh = DeviceMesh("cpu", torch.arange(WORLD), mesh_dim_names=("data",))
    same = {"w": torch.tensor(case["g_same"]),
            "b": torch.tensor(case["bias"] * (rank + 1))}
    state = init_compression(same, rank=2, min_dim=16,
                             generator=torch.Generator().manual_seed(5))
    got = compressed_psum(mesh, "data", same, state)
    diff = {"w": torch.tensor(case["g_ranks"][rank]), "b": same["b"]}
    got2 = compressed_psum(mesh, "data", diff, state)
    return {"same": got["w"].numpy(), "diff": got2["w"].numpy(),
            "bias": got2["b"].numpy(), "q0": state.q["w"].numpy()}


def _collectives(rank: int, mesh) -> dict:
    """The autograd collectives on the model axis of (1, 4), each with a
    gradient: copy (identity forward, summed gradients), reduce (summed
    forward, identity backward), gather (concatenated forward, the own
    slice of the gradient)."""
    import torch
    from repro_torch.dist import sharding
    out = {}
    with sharding.use_sharding(mesh):
        x = torch.full((3,), float(rank + 1), requires_grad=True)
        y = sharding.copy_to_model(x)
        (y * (rank + 1)).sum().backward()
        out["copy"] = (y.detach().numpy(), x.grad.numpy())
        x = torch.full((3,), float(rank + 1), requires_grad=True)
        y = sharding.reduce_from_model(x)
        (y * 2).sum().backward()
        out["reduce"] = (y.detach().numpy(), x.grad.numpy())
        x = torch.full((2, 1), float(rank + 1), requires_grad=True)
        y = sharding.gather_from_model(x, dim=-1)
        (y * torch.arange(4.0)).sum().backward()
        out["gather"] = (y.detach().numpy(), x.grad.numpy())
    return out


def _scenarios(rank: int, inputs, tmp: str) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_config
    grid = torch.arange(WORLD)
    mesh22 = DeviceMesh("cpu", grid.reshape(2, 2),
                        mesh_dim_names=("data", "model"))
    mesh14 = DeviceMesh("cpu", grid.reshape(1, 4),
                        mesh_dim_names=("data", "model"))
    out = {"danube": _danube(inputs, mesh22, f"{tmp}/ckpt"),
           "remesh": _remesh(rank, inputs, f"{tmp}/ckpt"),
           "restart": _restart(rank, mesh22, tmp)}
    for label, mesh in (("qwen3_14", mesh14), ("qwen3_22", mesh22)):
        out[label] = _moe(inputs, mesh, "qwen3", qwen3_cfg(get_config),
                          grads=label == "qwen3_14")
    out["capacity"] = _capacity(inputs, mesh22)
    for family in FAMILIES:
        out[family] = _family(inputs, mesh22, family)
    out["qwen2_14"] = _moe(inputs, mesh14, "qwen2", qwen2_cfg(get_config),
                           grads=True)
    out["decode_danube_22"] = _decode(inputs, mesh22, "danube",
                                      danube_cfg(get_config))
    out["decode_qwen2_14"] = _decode(inputs, mesh14, "qwen2",
                                     qwen2_cfg(get_config))
    out["psum"] = _psum(rank, inputs)
    out["collectives"] = _collectives(rank, mesh14)
    meshes = {"14": mesh14, "22": mesh22}
    for label, key, mesh, max_seq, prompt, last in CACHE_SEQ_CASES:
        out[f"cache_seq_{label}"] = _cache_seq_decode(
            inputs, meshes[mesh], key, max_seq, prompt, last)
    for family in FAMILIES:
        out[f"{family}_seq_sp"] = _family(inputs, mesh22, family,
                                          {"seq_sp": "model"})
    out["serve"] = _serve(inputs, mesh14)
    dist.barrier()
    return out


def serve_cli_args(device_args) -> list:
    """The serving CLI's arguments for reduced danube at SERVE_CLI."""
    b, prompt, new = SERVE_CLI
    return ["--arch", "h2o-danube-1.8b", "--reduced", "--device", "cpu",
            "--batch", str(b), "--prompt-len", str(prompt), "--max-new",
            str(new)] + device_args


def _launch(rank: int, tmp: str) -> list:
    """The training driver's ``--mesh local --model-parallel 2`` on the
    four ranks, a run of LAUNCH_STEPS[0] steps then its resume to
    LAUNCH_STEPS[1], each through a file store of its own; rank 0's
    histories."""
    import json
    from repro_torch.launch import train as train_mod
    runs = []
    for i, steps in enumerate(LAUNCH_STEPS):
        out = f"{tmp}/launch_{i}.json"
        train_mod.main(LAUNCH_ARGS + [
            "--steps", str(steps), "--ckpt-dir", f"{tmp}/launch_ckpt",
            "--mesh", "local", "--model-parallel", "2",
            "--init-method", f"file://{tmp}/launch_store_{i}",
            "--world-size", str(WORLD), "--rank", str(rank), "--out", out])
        if rank == 0:
            with open(out) as f:
                runs.append(json.load(f))
    return runs


def run_rank(rank: int, world: int, store: str, queue, inputs_path: str
             ) -> None:
    """One rank: the scenarios in one gloo world, then the driver's runs;
    ``(rank, results)`` (or ``(rank, traceback)``) on ``queue``."""
    import os
    import torch
    import torch.distributed as dist
    try:
        torch.set_num_threads(2)
        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)
        tmp = os.path.dirname(inputs_path)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        try:
            res = _scenarios(rank, inputs, tmp)
        finally:
            dist.destroy_process_group()
        res["launch"] = _launch(rank, tmp)
        from repro_torch.launch import serve as serve_mod
        res["serve_cli"] = serve_mod.main(serve_cli_args([
            "--mesh", "local", "--model-parallel", str(WORLD), "--rules",
            '{"cache_seq": "model"}', "--init-method",
            f"file://{tmp}/serve_store", "--world-size", str(WORLD),
            "--rank", str(rank)]))
        queue.put((rank, res))
    except BaseException:   # noqa: BLE001 — reported to the parent
        queue.put((rank, traceback.format_exc()))
        raise


def moe_inputs(cfg, seed: int) -> dict:
    """Tokens (MOE_TOKENS), the block's input x (MOE_TOKENS + (d,)) and a
    capacity input (CAP_ROWS + (d,)) shifted along one direction so that
    the router crowds some experts past their capacity."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    shift = rng.normal(size=d).astype(np.float32)
    return {"tokens": rng.integers(0, cfg.vocab, MOE_TOKENS, dtype=np.int32),
            "x": rng.normal(size=MOE_TOKENS + (d,)).astype(np.float32),
            "x_cap": (rng.normal(size=CAP_ROWS + (d,))
                      + 2.0 * shift).astype(np.float32)}
