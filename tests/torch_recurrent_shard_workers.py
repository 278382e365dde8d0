"""Rank bodies of the port's sharded recurrent-family tests
(``tests/test_torch_recurrent_shard.py``).

Spawned processes import this module, not the test file, so they load
``torch`` and the port only.  The test writes the inputs (the reference's
params as numpy arrays, tokens) to a pickle; every rank reads it, joins a
four-rank gloo group through a file store, runs each scenario on the
``(2, 2)`` and ``(1, 4)`` meshes of that world, and puts ``(rank,
results)`` on a queue: numpy arrays gathered whole and counters.  Then
each rank leaves the group and runs the training driver's ``--mesh
local`` for a hybrid with gradient compression, through a world of its
own.
"""

from __future__ import annotations

import pickle
import traceback

import numpy as np

WORLD = 4
ARCHS = {"hybrid": "zamba2-1.2b", "ssm": "xlstm-350m"}
MESHES = {"22": (2, 2), "14": (1, 4)}
LOSS_TOKENS = (4, 40)    # 40 > the reduced chunk of 32: two chunks
PROMPT, GREEDY = 8, 6    # decode: a token-by-token prefill, greedy steps
COMP_RANK, COMP_MIN_DIM, COMP_SEED = 4, 16, 5
LAUNCH_STEPS = 3
LAUNCH_ARGS = ["--arch", "zamba2-1.2b", "--reduced", "--batch", "4",
               "--seq", "32", "--log-every", "1", "--compression-rank", "2",
               "--device", "cpu"]
# leaves the reference initialises to constants, and the scale to draw
# them at (so that every path's gradient counts), as
# tests/test_torch_recurrent.py draws them
DRAWN = {"conv_b": 0.1, "dt_bias": 0.5, "a_log": 0.5, "d_skip": 0.5,
         "w_igate": 0.1, "b_igate": 1.0, "w_fgate": 0.1, "b_fgate": 1.0}


def draw(tree, rng):
    """The ``DRAWN`` leaves of a numpy param tree replaced by draws, in
    place."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            draw(leaf, rng)
        elif name in DRAWN:
            tree[name] = (rng.normal(size=leaf.shape)
                          * DRAWN[name]).astype(leaf.dtype)
    return tree


def family_cfg(get_config, family: str):
    return get_config(ARCHS[family]).reduced()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


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


def _train(inputs, mesh, family: str) -> dict:
    """The family's loss and gathered gradients on ``mesh``, with the
    local shapes of its head-aligned leaves."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (gather_tree, shard_tree,
                                           use_sharding)
    from repro_torch.models import LM, params_from_numpy
    from repro_torch.train import require_grad
    case = inputs[family]
    model = LM(family_cfg(get_config, family), device="cpu")
    with use_sharding(mesh):
        specs = model.param_specs()
        params = require_grad(shard_tree(
            params_from_numpy(case["params"], "cpu"), specs))
        loss, grads = _loss_and_grads(model, params,
                                      {"tokens": case["tokens"]})
        return {"loss": loss, "grads": _np(gather_tree(grads, specs)),
                "local_shapes": {k: tuple(v.shape)
                                 for k, v in _flat(params)}}


def _decode(inputs, mesh, family: str) -> dict:
    """A token-by-token prefill of PROMPT tokens, then GREEDY greedy
    steps, through ``LM.decode_step`` on ``mesh`` (the cache sharded by
    ``LM.cache_specs``): every step's logits gathered whole, the greedy
    tokens, the local cache shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (MODEL, current_ctx, gather,
                                           shard_tree, use_sharding)
    from repro_torch.models import LM, params_from_numpy
    from repro_torch.train.train_step import data_rows
    case = inputs[family]
    model = LM(family_cfg(get_config, family), device="cpu")
    prompt = torch.as_tensor(case["prompt"])
    b = prompt.shape[0]
    steps = PROMPT + GREEDY
    with torch.no_grad(), use_sharding(mesh):
        ctx = current_ctx()
        params = shard_tree(params_from_numpy(case["params"], "cpu"),
                            model.param_specs())
        cache = shard_tree(model.init_cache(b, steps),
                           model.cache_specs(b, steps))
        rows = data_rows({"t": prompt})["t"]
        logits, tokens = [], []
        token = rows[:, :1]
        for pos in range(steps - 1):
            out, cache = model.decode_step(params, cache, token, pos)
            whole = gather(gather(out, -1, MODEL), 0, ctx.batch_axes)
            logits.append(whole[:, 0].numpy())
            if pos + 1 < PROMPT:
                token = rows[:, pos + 1:pos + 2]
            else:
                nxt = whole[:, 0].argmax(dim=-1, keepdim=True)
                tokens.append(nxt[:, 0].numpy())
                token = data_rows({"t": nxt})["t"]
    return {"logits": np.stack(logits, axis=1),
            "tokens": np.stack(tokens, axis=1),
            "cache_shapes": {k: tuple(v.shape) for k, v in _flat(cache)}}


def _compression(inputs, mesh) -> dict:
    """Gradient compression on (2, 2) of zamba2's gathered-mean
    gradients, its state the rank's blocks of the whole state drawn from
    COMP_SEED: the decompressed gradients gathered whole, and the bytes
    its factor collectives put on the model axis."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import gather_tree, shard_tree
    from repro_torch.models import LM, params_from_numpy
    from repro_torch.train import grad_compression as gc
    from repro_torch.train import require_grad
    case = inputs["hybrid"]
    model = LM(family_cfg(get_config, "hybrid"), device="cpu")
    with sharding.use_sharding(mesh):
        specs = model.param_specs()
        params = require_grad(shard_tree(
            params_from_numpy(case["params"], "cpu"), specs))
        _, grads = _loss_and_grads(model, params, {"tokens": case["tokens"]})
        state = gc.init_compression(
            params, rank=COMP_RANK, min_dim=COMP_MIN_DIM,
            generator=torch.Generator().manual_seed(COMP_SEED), specs=specs)
        sharding.reset_bytes()
        compressed, _ = gc.compress_tree(grads, state, specs)
        nbytes = dict(sharding.BYTES)
        out = gc.decompress_tree(compressed)
        return {"grads": _np(gather_tree(grads, specs)),
                "decompressed": _np(gather_tree(out, specs)),
                "bytes": nbytes, "specs": {k: repr(v) for k, v in
                                           _flat(specs)}}


def _checkpoint(inputs, mesh22, mesh14, ckpt: str) -> dict:
    """One zamba2 train step on (2, 2), saved (gathered, rank 0 writes);
    restored onto (1, 4): both meshes' states gathered whole."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import CheckpointManager
    from repro_torch.dist.sharding import (gather_tree, shard_tree,
                                           use_sharding)
    from repro_torch.models import LM, params_from_numpy
    from repro_torch.train import (TrainState, adamw_init, init_train_state,
                                   make_train_step, require_grad,
                                   train_state_specs)
    case = inputs["hybrid"]
    model = LM(family_cfg(get_config, "hybrid"), device="cpu")
    out = {}
    with use_sharding(mesh22):
        specs = train_state_specs(model)
        params = require_grad(shard_tree(
            params_from_numpy(case["params"], "cpu"), specs.params))
        state = TrainState(params, adamw_init(params), torch.Generator())
        state, _ = make_train_step(model)(state, {"tokens": case["tokens"]})
        CheckpointManager(ckpt, async_save=False).save(
            1, state, blocking=True, specs=specs)
        out["saved"] = {"params": _np(gather_tree(state.params,
                                                  specs.params)),
                        "m": _np(gather_tree(state.opt.m, specs.params))}
    with use_sharding(mesh14):
        specs = train_state_specs(model)
        fresh = init_train_state(model, torch.Generator().manual_seed(9))
        back = CheckpointManager(ckpt, async_save=False).restore(
            fresh, step=1, specs=specs)
        out["restored"] = {"params": _np(gather_tree(back.params,
                                                     specs.params)),
                           "m": _np(gather_tree(back.opt.m, specs.params))}
        out["restored_step"] = int(back.opt.step)
        out["local_in_proj"] = tuple(
            back.params["mamba_groups"]["mixer"]["in_proj"].shape)
    return out


def _scenarios(rank: int, inputs, tmp: str) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    grid = torch.arange(WORLD)
    meshes = {k: DeviceMesh("cpu", grid.reshape(shape),
                            mesh_dim_names=("data", "model"))
              for k, shape in MESHES.items()}
    out = {}
    for family in ARCHS:
        for key, mesh in meshes.items():
            out[f"train_{family}_{key}"] = _train(inputs, mesh, family)
            out[f"decode_{family}_{key}"] = _decode(inputs, mesh, family)
    out["compression"] = _compression(inputs, meshes["22"])
    out["checkpoint"] = _checkpoint(inputs, meshes["22"], meshes["14"],
                                    f"{tmp}/ckpt")
    dist.barrier()
    return out


def _launch(rank: int, tmp: str) -> list:
    """``launch/train.py --mesh local --model-parallel 2`` for reduced
    zamba2 with ``--compression-rank 2`` on the four ranks, through a
    file store of its own; rank 0's history."""
    import json
    from repro_torch.launch import train as train_mod
    out = f"{tmp}/launch.json"
    train_mod.main(LAUNCH_ARGS + [
        "--steps", str(LAUNCH_STEPS), "--mesh", "local",
        "--model-parallel", "2", "--init-method",
        f"file://{tmp}/launch_store", "--world-size", str(WORLD),
        "--rank", str(rank), "--out", out])
    if rank != 0:
        return []
    with open(out) as f:
        return json.load(f)["history"]


def run_rank(rank: int, world: int, store: str, queue, inputs_path: str
             ) -> None:
    """One rank: the scenarios in one gloo world, then the driver's run;
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
        queue.put((rank, res))
    except BaseException:   # noqa: BLE001 — reported to the parent
        queue.put((rank, traceback.format_exc()))
        raise
