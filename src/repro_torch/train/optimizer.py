"""Optimizers (AdamW, momentum-SGD) with f32 master weights, the
counterparts of the JAX package's ``train/optimizer.py``.

Params live in the compute type (bf16 for the published configs); the
optimizer state carries f32 master weights and moments.  The reference's
updates are pure functions that return new trees; here
:func:`adamw_update` and :func:`sgdm_update` update the state's tensors
and the params IN PLACE (the port's convention: a 1.8B-parameter state
would otherwise be written anew every step) and return them, with the
reference's values.  :func:`opt_state_axes` gives the state the params'
logical axes, as the reference does; on a mesh the state holds the same
local blocks as the params, and :func:`global_norm` sums the split
leaves' squares over the axes that split them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..dist import sharding
from ..models.weights import params_from_numpy

Tensor = torch.Tensor


class OptState(NamedTuple):
    step: Tensor       # int32 scalar: updates taken
    master: Any        # f32 copies of the params
    m: Any             # first moment, f32
    v: Any             # second moment, f32


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a nested dict (and of the like-shaped
    ``rest``), in :func:`leaves`' order; None leaves stay None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if tree is None:
        return None
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The tensor leaves of a nested dict, in sorted-key order (the
    reference's ``jax.tree.leaves`` order); None leaves left out."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [] if tree is None else [tree]


def unflatten(like, flat):
    """The nested dict ``like`` with its leaves replaced, in
    :func:`leaves`' order, by the items of ``flat``."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def opt_state_from_numpy(state, device=None) -> OptState:
    """An :class:`OptState` from the reference's (``jax.tree.map(
    np.asarray, state)``: step, master, m, v), on ``device`` (``None``: the
    card)."""
    return OptState(*(params_from_numpy(x, device) for x in state))


def _f32_zeros(p: Tensor) -> Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params) -> OptState:
    """Step 0, f32 master copies (always new storage, also for an f32
    param, which the in-place update would otherwise alias) and zero
    moments."""
    first = leaves(params)[0]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params),
        m=tree_map(_f32_zeros, params), v=tree_map(_f32_zeros, params))


def global_norm(tree, specs=None) -> Tensor:
    """sqrt of the sum of every leaf's squares, in f32.  With ``specs``
    (the leaves' PartitionSpecs on the active mesh) the tree holds local
    blocks: each leaf's sum is added over the axes of size > 1 that its
    spec splits it over (the model axis, the ``"fsdp"`` rule's data
    axes, or both: the leaves split alike summed in one all-reduce), the
    replicated ones counted once, so every rank clips as one device
    would."""
    squares = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    ctx = sharding.current_ctx()
    if specs is None or ctx.mesh is None:
        return torch.sqrt(sum(squares))
    groups: Dict[Tuple[str, ...], list] = {}
    for q, axes in zip(squares, _split_axes(specs, ctx)):
        groups.setdefault(axes, []).append(q)
    whole = sum(groups.pop((), []))
    if not groups:
        return torch.sqrt(whole)
    part = sum(sharding.all_reduce(sum(qs).detach().clone(), axes, ctx)
               for axes, qs in sorted(groups.items()))
    return torch.sqrt(part + whole)


def _split_axes(specs, ctx) -> list:
    """The axes of size > 1 that each leaf's spec splits it over, in
    :func:`leaves`' order."""
    return [tuple(a for a in sharding.spec_axes(spec) if ctx.size(a) > 1)
            for spec in leaves(specs)]


def opt_state_axes(param_axes) -> Dict:
    """Logical axes of :class:`OptState` given the params': the master
    weights and moments take the params' own, as in the reference.  Under
    the ``"fsdp"`` rule they are split over the data axes with the params
    (ZeRO: each data rank keeps and updates its block of the state)."""
    return {"step": (), "master": param_axes, "m": param_axes,
            "v": param_axes}


@torch.no_grad()
def adamw_update(grads, state: OptState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0, specs=None
                 ) -> Tuple[Any, OptState, Dict[str, Tensor]]:
    """One AdamW step → (params, state, {"grad_norm"}): the gradients in
    f32, clipped to a global norm of ``grad_clip``, the moments and
    bias corrections in f32, decoupled weight decay on the master weights,
    the params their cast.  ``state.master``, ``state.m``, ``state.v`` and
    ``params`` are updated in place and returned (``state.step`` is a new
    tensor); the values are the reference's ``adamw_update``'s.  On a
    mesh every tensor is a local block and ``specs`` their placements
    (:func:`global_norm`)."""
    step = state.step + 1
    gnorm = global_norm(grads, specs)
    scale = None
    if grad_clip is not None:
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)

    def upd(g, m, v, w, p):
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * g * (1 - b2))
        mh = m / b1c
        vh = v / b2c
        w.sub_(lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * w))
        p.copy_(w)

    tree_map(upd, grads, state.m, state.v, state.master, params)
    return params, OptState(step, state.master, state.m, state.v), \
        {"grad_norm": gnorm}


def sgdm_init(params) -> Dict[str, Any]:
    first = leaves(params)[0]
    return {"step": torch.zeros((), dtype=torch.int32, device=first.device),
            "mom": tree_map(_f32_zeros, params)}


@torch.no_grad()
def sgdm_update(grads, state, params, *, lr, momentum: float = 0.9):
    """One momentum-SGD step → (params, state, {}): ``mom = momentum mom
    + g``, ``p -= lr mom`` in f32, cast back; ``state["mom"]`` and
    ``params`` in place."""
    def upd(b, g, p):
        b.mul_(momentum).add_(g.float())
        p.copy_(p.float() - lr * b)

    tree_map(upd, state["mom"], grads, params)
    return params, {"step": state["step"] + 1, "mom": state["mom"]}, {}


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step (an int tensor) → lr (f32 tensor): linear warm-up over
    ``warmup`` steps, then a half cosine to 0 at ``total``."""
    def lr(step: Tensor) -> Tensor:
        s = torch.as_tensor(step).float()
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr
