"""Rank bodies of the port's ``"fsdp"`` tests (``tests/test_torch_fsdp.py``).

Spawned processes import this module, not the test file, so they load
``torch`` and the port only.  The test writes the inputs (the
reference's params as numpy arrays and the batches) to a pickle; every
rank reads it, joins a four-rank gloo group through a file store, runs
each scenario under ``{"fsdp": "data"}`` on the ``(2, 2)`` and ``(4, 1)``
meshes of that world (and under ``{"fsdp": ("pod", "data")}`` on a
``(2, 2, 1)`` one), then the ``"seq_sp"`` cases (``SEQ_CASES``) on
``(2, 2)`` and ``(1, 4)``, and puts ``(rank, results)`` on a queue: numpy
arrays gathered whole, and counters.
"""

from __future__ import annotations

import dataclasses
import pickle
import traceback

WORLD = 4
RULES = {"fsdp": "data"}
POD_RULES = {"fsdp": ("pod", "data")}
#: a reduced config of every family whose params carry "fsdp" axes
FAMILIES = {"dense": "h2o-danube-1.8b", "moe": "qwen2-moe-a2.7b",
            "hybrid": "zamba2-1.2b", "ssm": "xlstm-350m"}
TOKENS = (8, 32)
#: the meshes of the world: (shape, axis names)
MESHES = {"22": ((2, 2), ("data", "model")),
          "41": ((4, 1), ("data", "model")),
          "14": ((1, 4), ("data", "model")),
          "pod": ((2, 2, 1), ("pod", "data", "model"))}
SEQ_RULES = {"seq_sp": "model"}
#: the seq_sp cases: (label, family, mesh, positions of the batch): the
#: dense and moe families on both meshes, the moe with its router loss on
#: (1, 4) (one data shard, so the single device's), 30 positions that
#: model = 4 does not divide (the sequence stays whole), and the hybrid,
#: whose backbone ignores the rule
SEQ_CASES = [("dense_22", "dense", "22", 32), ("dense_14", "dense", "14", 32),
             ("moe_22", "moe", "22", 32), ("moe_14", "moe", "14", 32),
             ("moe_aux_14", "moe_aux", "14", 32),
             ("dense_14_s30", "dense", "14", 30),
             ("hybrid_22", "hybrid", "22", 32)]
#: the clipped step: a clip so small that the clipped gradients sit below
#: AdamW's eps, where the update is linear in the clip scale (so a wrong
#: global norm moves it), at a learning rate that makes it visible
CLIP, CLIP_LR = 1e-6, 1e-2
COMP_RANK, COMP_MIN_DIM = 2, 64
DECODE_STEPS = 6


def family_cfg(get_config, family: str):
    """The family's reduced config; the MoE's without its router loss
    (each data shard's own by design, ``test_moe_capacity_per_data_shard``,
    so it would not equal the single device's) and with room for every
    pair."""
    if family == "moe_aux":
        cfg = get_config(FAMILIES["moe"]).reduced()
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    cfg = get_config(FAMILIES[family]).reduced()
    if family == "moe":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router_aux_loss=0.0, capacity_factor=8.0))
    return cfg


def seq_case(inputs, family: str, positions: int):
    """A seq_sp case's (params, batch): its family's (the moe's for
    ``moe_aux``), the batch cut to ``positions``."""
    case = inputs["moe" if family == "moe_aux" else family]
    return {"params": case["params"], "batch": {
        "tokens": case["batch"]["tokens"][:, :positions]}}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def _mesh(key: str):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = MESHES[key]
    return DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                      mesh_dim_names=names)


def _params(model, case, specs):
    from repro_torch.dist.sharding import shard_tree
    from repro_torch.models import params_from_numpy
    from repro_torch.train import require_grad
    return require_grad(shard_tree(params_from_numpy(case["params"], "cpu"),
                                   specs))


def _grads(inputs, family: str, mesh_key: str, rules, case=None) -> dict:
    """The family's loss and gradients (averaged over the data ranks and
    gathered whole) under ``rules``, the local shapes of its params, and
    the bytes by axis; ``case`` (params and batch) in place of the
    family's inputs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (BYTES, gather_tree, reset_bytes,
                                           use_sharding)
    from repro_torch.models import LM
    from repro_torch.train.optimizer import leaves, unflatten
    from repro_torch.train.train_step import data_rows, mean_over_data
    case = case or inputs[family]
    model = LM(family_cfg(get_config, family), device="cpu")
    with use_sharding(_mesh(mesh_key), rules):
        specs = model.param_specs()
        params = _params(model, case, specs)
        reset_bytes()
        loss, _ = model.loss(params, data_rows(case["batch"]))
        grads = torch.autograd.grad(loss, leaves(params),
                                    allow_unused=True, materialize_grads=True)
        grads = mean_over_data(unflatten(params, grads), specs)
        return {"loss": float(loss), "bytes": dict(BYTES),
                "local": _shapes(params),
                "grads": _np(gather_tree(grads, specs))}


def _step(inputs, mesh_key: str) -> dict:
    """One clipped train step of the dense family under ``{"fsdp":
    "data"}``: the gathered params after it, the global norm it clipped
    by, the step's bytes by axis, the optimizer state's local shapes."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (BYTES, gather_tree, reset_bytes,
                                           use_sharding)
    from repro_torch.models import LM
    from repro_torch.train import TrainState, adamw_init, make_train_step
    import torch
    case = inputs["dense"]
    model = LM(family_cfg(get_config, "dense"), device="cpu")
    with use_sharding(_mesh(mesh_key), RULES):
        specs = model.param_specs()
        params = _params(model, case, specs)
        state = TrainState(params, adamw_init(params), torch.Generator())
        step = make_train_step(model, lr=CLIP_LR, warmup=1, grad_clip=CLIP)
        reset_bytes()
        state, metrics = step(state, case["batch"])
        return {"loss": float(metrics["loss"]), "bytes": dict(BYTES),
                "grad_norm": float(metrics["grad_norm"]),
                "params": _np(gather_tree(state.params, specs)),
                "master_local": _shapes(state.opt.master)}


def _compression(inputs) -> dict:
    """A gradient-shaped tree (the dense family's params as stand-ins)
    compressed on (2, 2) under ``{"fsdp": "data"}``: leaves split over
    data on one dimension and model on the other, each as the single
    device compresses the whole leaf; Ĝ gathered whole, the specs, and
    the collectives' bytes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (BYTES, gather_tree, reset_bytes,
                                           shard_tree, use_sharding)
    from repro_torch.models import LM, params_from_numpy
    from repro_torch.train import (compress_tree, decompress_tree,
                                   init_compression)
    from repro_torch.train.optimizer import tree_map
    model = LM(family_cfg(get_config, "dense"), device="cpu")
    whole = params_from_numpy(inputs["dense"]["params"], "cpu")
    with use_sharding(_mesh("22"), RULES):
        specs = model.param_specs()
        local = shard_tree(whole, specs)
        state = init_compression(local, rank=COMP_RANK, min_dim=COMP_MIN_DIM,
                                 generator=torch.Generator().manual_seed(9),
                                 specs=specs)
        reset_bytes()
        compressed, _ = compress_tree(local, state, specs)
        out = {"bytes": dict(BYTES),
               "specs": tree_map(lambda s: tuple(s), specs)}
        out["g_hat"] = _np(gather_tree(decompress_tree(compressed), specs))
    return out


def _checkpoint(inputs, tmp: str) -> dict:
    """A step under ``{"fsdp": "data"}`` on (2, 2), saved (rank 0
    writes the gathered state); restored onto (2, 2) under the default
    rules (each rank's blocks against its blocks of the saved state,
    gathered before the save, bit for bit); that state saved again and
    restored under ``{"fsdp": "data"}``, against the fsdp blocks bit for
    bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import CheckpointManager
    from repro_torch.dist.sharding import (gather_tree, local_block,
                                           use_sharding)
    from repro_torch.models import LM
    from repro_torch.train import (TrainState, adamw_init,
                                   init_train_state, make_train_step,
                                   train_state_specs)
    from repro_torch.train.optimizer import leaves
    case = inputs["dense"]
    model = LM(family_cfg(get_config, "dense"), device="cpu")
    mesh = _mesh("22")
    mgr = CheckpointManager(f"{tmp}/fsdp_ckpt", async_save=False)
    with use_sharding(mesh, RULES):
        specs = train_state_specs(model)
        params = _params(model, case, specs.params)
        state = TrainState(params, adamw_init(params), torch.Generator())
        state, _ = make_train_step(model)(state, case["batch"])
        mgr.save(1, state, blocking=True, specs=specs)
        whole = {k: gather_tree(getattr(state.opt, k), specs.params)
                 for k in ("master", "m", "v")}
        whole["params"] = gather_tree(state.params, specs.params)
        fsdp_state = state

    def same(restored, specs) -> list:
        diff = []
        for key in ("params", "master", "m", "v"):
            got = (restored.params if key == "params"
                   else getattr(restored.opt, key))
            want = [local_block(x, s) for x, s in zip(
                leaves(whole[key]), leaves(specs.params))]
            diff += [f"{key}[{i}]" for i, (a, b) in enumerate(
                zip(leaves(got), want)) if not torch.equal(a, b)]
        return diff

    out = {}
    with use_sharding(mesh):
        specs = train_state_specs(model)
        fresh = init_train_state(model, torch.Generator().manual_seed(8))
        plain = mgr.restore(fresh, step=1, specs=specs)
        out["to_default"] = same(plain, specs)
        out["default_local"] = _shapes(plain.params)
        mgr.save(2, plain, blocking=True, specs=specs)
    with use_sharding(mesh, RULES):
        specs = train_state_specs(model)
        fresh = init_train_state(model, torch.Generator().manual_seed(8))
        back = mgr.restore(fresh, step=2, specs=specs)
        out["back_to_fsdp"] = same(back, specs) + [
            f"fsdp[{i}]" for i, (a, b) in enumerate(zip(
                leaves(back.params), leaves(fsdp_state.params)))
            if not torch.equal(a, b)]
        out["step"] = int(back.opt.step)
    out["whole"] = _np(whole["params"])
    return out


def _decode(inputs, mesh_key: str) -> dict:
    """DECODE_STEPS decode steps of the dense family from an empty cache
    under ``{"fsdp": "data"}`` (each block gathered a step), every step's
    logits gathered whole, against the single-device decode of the same
    params."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (MODEL, current_ctx, gather,
                                           shard_tree, use_sharding)
    from repro_torch.models import LM, params_from_numpy
    from repro_torch.train.train_step import data_rows
    case = inputs["dense"]
    model = LM(family_cfg(get_config, "dense"), device="cpu")
    whole = params_from_numpy(case["params"], "cpu")
    tokens = torch.as_tensor(case["batch"]["tokens"][:, :DECODE_STEPS])
    with torch.no_grad():
        cache = model.init_cache(tokens.shape[0], DECODE_STEPS)
        want = [model.decode_step(whole, cache, tokens[:, i:i + 1], i)[0]
                for i in range(DECODE_STEPS)]
        with use_sharding(_mesh(mesh_key), RULES):
            ctx = current_ctx()
            params = shard_tree(whole, model.param_specs())
            rows = data_rows({"tokens": tokens})["tokens"]
            cache = shard_tree(model.init_cache(tokens.shape[0],
                                                DECODE_STEPS),
                               model.cache_specs(tokens.shape[0],
                                                 DECODE_STEPS))
            got = []
            for i in range(DECODE_STEPS):
                logits, cache = model.decode_step(params, cache,
                                                  rows[:, i:i + 1], i)
                got.append(gather(gather(logits, -1, MODEL), 0,
                                  ctx.batch_axes))
    return {"max_diff": max(float((g - w).abs().max())
                            for g, w in zip(got, want)),
            "max_logit": max(float(w.abs().max()) for w in want),
            "greedy_equal": all(torch.equal(g.argmax(-1), w.argmax(-1))
                                for g, w in zip(got, want))}


def _gather_from_data(rank: int) -> dict:
    """gather_from_data of a rank's block along dim 1, on (2, 2) over
    "data" and on (2, 2, 1) over ("pod", "data"), each with a gradient:
    the forward against an explicit all-gather, the backward against an
    explicit sum of every rank's upstream gradient, sliced."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sharding
    out = {}
    for key, rules in (("22", RULES), ("pod", POD_RULES)):
        with sharding.use_sharding(_mesh(key), rules) as ctx:
            axes = ctx.fsdp_axes
            x = torch.arange(6.0).reshape(3, 2).add(10 * rank)
            x.requires_grad_(True)
            y = sharding.gather_from_data(x, 1, axes)
            w = torch.full(y.shape, float(rank + 1)) * torch.arange(
                float(y.shape[1]))
            (y * w).sum().backward()
            # explicit: every rank's block on the axes, in their order;
            # every rank's upstream gradient, summed
            group = torch.tensor([r for r in range(WORLD)
                                  if _peers(ctx, r, axes)])
            blocks = [torch.empty_like(x) for _ in range(WORLD)]
            dist.all_gather(blocks, x.detach())
            want_y = torch.cat([blocks[r] for r in group.tolist()], dim=1)
            ws = [torch.empty_like(w) for _ in range(WORLD)]
            dist.all_gather(ws, w)
            total = sum(ws[r] for r in group.tolist())
            lo = ctx.coord(axes) * x.shape[1]
            out[key] = {"y": y.detach().numpy(), "want_y": want_y.numpy(),
                        "grad": x.grad.numpy(),
                        "want_grad": total[:, lo:lo + x.shape[1]].numpy(),
                        "axes": axes}
    return out


def _peers(ctx, rank: int, axes) -> bool:
    """Whether world rank ``rank`` shares this rank's coordinates on every
    mesh axis outside ``axes`` (its blocks join this rank's gather), in
    the mesh's row-major rank order."""
    names, shape = ctx.mesh.mesh_dim_names, ctx.mesh.shape
    coords, r = {}, rank
    for name, size in reversed(list(zip(names, shape))):
        coords[name] = r % size
        r //= size
    return all(coords[a] == ctx.mesh.get_local_rank(a)
               for a in names if a not in axes)


def _scenarios(rank: int, inputs, tmp: str) -> dict:
    import torch.distributed as dist
    out = {}
    for family in FAMILIES:
        for key in ("22", "41"):
            out[f"grads_{family}_{key}"] = _grads(inputs, family, key, RULES)
    out["grads_dense_pod"] = _grads(inputs, "dense", "pod", POD_RULES)
    for key in ("22", "41"):
        out[f"step_{key}"] = _step(inputs, key)
    out["compression"] = _compression(inputs)
    out["checkpoint"] = _checkpoint(inputs, tmp)
    out["decode"] = _decode(inputs, "22")
    out["gather"] = _gather_from_data(rank)
    for label, family, key, positions in SEQ_CASES:
        case = seq_case(inputs, family, positions)
        out[f"seq_{label}"] = _grads(inputs, family, key, SEQ_RULES, case)
        out[f"seq_{label}"]["default_bytes"] = _grads(
            inputs, family, key, {}, case)["bytes"]
    out["seq_collectives"] = _seq_collectives(rank)
    dist.barrier()
    return out


def _seq_collectives(rank: int) -> dict:
    """The sequence collectives on (1, 4)'s model axis, each with a
    gradient: scatter_to_seq (the rank's block, the gradient gathered
    whole), gather_from_seq (the blocks in rank order; its gradient the
    sum of every rank's upstream gradient, the rank's block of it, or
    with ``summed=False`` the rank's block of its own), and
    reduce_scatter_to_seq (the sum's block, the gradient gathered)."""
    import torch
    from repro_torch.dist import sharding
    out = {}
    with sharding.use_sharding(_mesh("14")):
        w = torch.arange(8.0) * (rank + 1)
        x = torch.arange(8.0).reshape(1, 8).add(10 * rank)
        x.requires_grad_(True)
        y = sharding.scatter_to_seq(x, 1)
        (y * w[2 * rank:2 * rank + 2]).sum().backward()
        out["scatter"] = (y.detach().numpy(), x.grad.numpy())
        for summed in (True, False):
            x = torch.full((1, 2), float(rank + 1), requires_grad=True)
            y = sharding.gather_from_seq(x, 1, summed=summed)
            (y * w).sum().backward()
            out[f"gather_{summed}"] = (y.detach().numpy(), x.grad.numpy())
        x = torch.arange(8.0).reshape(1, 8).mul(rank + 1)
        x.requires_grad_(True)
        y = sharding.reduce_scatter_to_seq(x, 1)
        (y * w[2 * rank:2 * rank + 2]).sum().backward()
        out["reduce_scatter"] = (y.detach().numpy(), x.grad.numpy())
    return out


def run_rank(rank: int, world: int, store: str, queue, inputs_path: str
             ) -> None:
    """One rank: the scenarios in one gloo world; ``(rank, results)`` (or
    ``(rank, traceback)``) on ``queue``."""
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
        queue.put((rank, res))
    except BaseException:   # noqa: BLE001 — reported to the parent
        queue.put((rank, traceback.format_exc()))
        raise
