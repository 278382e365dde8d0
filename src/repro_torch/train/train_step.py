"""Train step factory: loss → gradients → (optional LINVIEW compression)
→ AdamW, with microbatch gradient accumulation; the counterpart of the
JAX package's ``train/train_step.py``.

The reference returns a pure function for ``jax.jit``; the port's step
runs eagerly on the model's device (the card unless the model was made
with ``device="cpu"``) and updates the state's tensors in place, with
the reference's values (:mod:`.optimizer`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

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
    require grad, and their AdamW state."""
    params = model.init(generator)
    return TrainState(params=require_grad(params), opt=adamw_init(params),
                      rng=generator)


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
    updates them and the optimizer state in place."""
    schedule = cosine_schedule(lr, warmup, total_steps)

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
        if microbatches > 1:
            loss, grads = accum_grads(state.params, batch)
        else:
            loss, grads = single_grads(state.params, batch)
        if compression is not None:
            compressed, _ = gc.compress_tree(grads, compression)
            grads = gc.decompress_tree(compressed)
        step_lr = schedule(state.opt.step + 1)
        params, opt, metrics = adamw_update(
            grads, state.opt, state.params, lr=step_lr,
            weight_decay=weight_decay, grad_clip=grad_clip)
        return (TrainState(params=params, opt=opt, rng=state.rng),
                {"loss": loss, "lr": step_lr, **metrics})

    return train_step
