"""Train step factory: loss → gradients → (optional LINVIEW compression)
→ AdamW, with microbatch gradient accumulation; the counterpart of the
JAX package's ``train/train_step.py``.

The reference returns a pure function for ``jax.jit``; the port's step
runs eagerly on the model's device (the card unless the model was made
with ``device="cpu"``) and updates the state's tensors in place, with
the reference's values (:mod:`.optimizer`).

Under ``use_sharding`` (``dist.sharding``) the state is each rank's local
blocks (:func:`init_train_state` draws the whole state, as on one device,
and keeps the rank's blocks), the step takes its data rows of the global
batch, the gradients get one mean all-reduce over the batch axes (the
leaves the ``"fsdp"`` rule splits over them were summed there by their
gathers' reduce-scatters, and are only divided), the clip norm sums
each split leaf's squares over the axes that split it, and AdamW runs
on the local blocks: under ``"fsdp"`` the master weights and moments
are split over the data axes with the params.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..dist.sharding import (P, all_reduce, current_ctx, local_block,
                             shard_tree, spec_axes)
from ..models.model import LM
from . import grad_compression as gc
from .optimizer import (OptState, adamw_init, adamw_update, cosine_schedule,
                        leaves, tree_map, unflatten)

Tensor = torch.Tensor


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    rng: torch.Generator


def init_train_state(model: LM, generator: torch.Generator) -> TrainState:
    """Params drawn from ``generator`` (:meth:`LM.init`), made leaves that
    require grad, and their AdamW state.  Under ``use_sharding``: the
    whole params drawn as on one device, then this rank's blocks of them
    (:meth:`LM.param_specs`), so that a sharded run starts bit for bit
    from the single-device params."""
    params = model.init(generator)
    if current_ctx().mesh is not None:
        params = shard_tree(params, model.param_specs())
    return TrainState(params=require_grad(params), opt=adamw_init(params),
                      rng=generator)


def train_state_specs(model: LM) -> TrainState:
    """The placement of every leaf of a :class:`TrainState` on the active
    mesh: the params' specs for the params, master weights and moments
    (the reference's ``opt_state_axes``), replicated step and generator."""
    specs = model.param_specs()
    return TrainState(params=specs, opt=OptState(P(), specs, specs, specs),
                      rng=P())


def data_rows(batch: Dict, device=None) -> Dict:
    """This rank's rows of a global batch (its coordinate along the batch
    axes of the active mesh; every row without one), as tensors."""
    ctx = current_ctx()
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    parts = ctx.size(ctx.batch_axes)
    if parts == 1:
        return batch
    n = next(iter(batch.values())).shape[0]
    if n % parts:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{parts} data ranks")
    spec = P(ctx.batch_axes)
    return {k: local_block(v, spec, ctx) for k, v in batch.items()}


def mean_over_data(grads, specs=None):
    """The gradients' mean over the data ranks: each rank's gradient is
    its shard's term (:meth:`LM.loss`), so one all-reduce over the batch
    axes of each dtype's leaves flattened into one buffer, then the
    division by their ranks.  A leaf that ``specs`` (the gradients'
    placement, :meth:`LM.param_specs`) splits over batch axes (the
    ``"fsdp"`` rule's) was already summed over them by its gather's
    reduce-scatter: it is all-reduced over the other batch axes only, if
    any, and divided.  Without ``specs`` every leaf is all-reduced, which
    is wrong for such a leaf, so it raises where the rule splits one."""
    ctx = current_ctx()
    batch = ctx.batch_axes
    parts = ctx.size(batch)
    if parts == 1:
        return grads
    flat = leaves(grads)
    if specs is None:
        if set(ctx.fsdp_axes) & set(batch):
            raise ValueError("the fsdp rule splits gradients over the batch "
                             "axes: pass their specs")
        rest = [batch] * len(flat)
    else:
        rest = [tuple(a for a in batch if a not in spec_axes(spec))
                for spec in leaves(specs)]
    out = list(flat)
    groups = sorted({(str(g.dtype), r) for g, r in zip(flat, rest)})
    for dtype, axes in groups:
        idx = [i for i, g in enumerate(flat)
               if str(g.dtype) == dtype and rest[i] == axes]
        buf = torch.cat([flat[i].reshape(-1) for i in idx])
        all_reduce(buf, axes, ctx)
        buf /= parts
        for i, piece in zip(idx, buf.split([flat[i].numel() for i in idx])):
            out[i] = piece.view_as(flat[i])
    return unflatten(grads, out)


def require_grad(params):
    """``params`` with every leaf set to require grad (in place), so that
    the step can differentiate the loss by them."""
    tree_map(lambda p: p.requires_grad_(True), params)
    return params


def make_train_step(model: LM, *, lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, microbatches: int = 1,
                    compression: Optional[gc.CompressionState] = None,
                    weight_decay: float = 0.1,
                    grad_clip: float = 1.0) -> Callable:
    """→ ``train_step(state, batch) → (state, metrics)`` with metrics
    {"loss", "lr", "grad_norm"}.  ``batch`` is a dict of numpy arrays or
    tensors; with ``microbatches`` > 1 its leading dim is split into that
    many equal parts, their gradients summed in f32 zeros and scaled by 1
    / ``microbatches``, as the reference's scan does.  With
    ``compression`` every gradient leaf it covers is replaced by its
    rank-k approximation (the reference's state is not carried from step
    to step, and neither is it here).  The params' leaves must require
    grad (:func:`init_train_state`, :func:`require_grad`); the step
    updates them and the optimizer state in place.

    Under ``use_sharding`` (the state from :func:`init_train_state` in
    the same context) ``batch`` is the global batch: the step takes its
    data rows, and the loss it reports is the global batch's.
    ``compression`` then holds the rank's blocks
    (:func:`~.grad_compression.init_compression` with the specs) and
    compresses the averaged gradients, each leaf as the single device
    compresses the whole leaf (:func:`~.grad_compression.compress_tree`
    with the specs), as the reference's step does."""
    schedule = cosine_schedule(lr, warmup, total_steps)
    ctx = current_ctx()
    specs = model.param_specs() if ctx.mesh is not None else None

    def single_grads(params, batch) -> Tuple[Tensor, Any]:
        loss, _ = model.loss(params, batch)
        # a leaf the loss does not read (audio's token table) gets zeros,
        # as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), unflatten(params, grads)

    def accum_grads(params, batch) -> Tuple[Tensor, Any]:
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        n = next(iter(batch.values())).shape[0]
        if n % microbatches:
            raise ValueError(f"batch of {n} does not split into "
                             f"{microbatches} microbatches")
        split = {k: v.reshape((microbatches, n // microbatches)
                              + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        loss_sum = torch.zeros((), device=model.device)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        for i in range(microbatches):
            loss, grads = single_grads(params, {k: v[i]
                                                for k, v in split.items()})
            loss_sum += loss
            tree_map(lambda a, g: a.add_(g), acc, grads)
            del grads
        inv = 1.0 / microbatches
        return loss_sum * inv, tree_map(lambda g: g.mul_(inv), acc)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict[str, Tensor]]:
        if specs is not None:
            batch = data_rows(batch, model.device)
        if microbatches > 1:
            loss, grads = accum_grads(state.params, batch)
        else:
            loss, grads = single_grads(state.params, batch)
        grads = mean_over_data(grads, specs)
        if compression is not None:
            compressed, _ = gc.compress_tree(grads, compression, specs)
            grads = gc.decompress_tree(compressed)
        step_lr = schedule(state.opt.step + 1)
        params, opt, metrics = adamw_update(
            grads, state.opt, state.params, lr=step_lr,
            weight_decay=weight_decay, grad_clip=grad_clip, specs=specs)
        return (TrainState(params=params, opt=opt, rng=state.rng),
                {"loss": loss, "lr": step_lr, **metrics})

    return train_step
