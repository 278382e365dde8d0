"""LINVIEW low-rank gradient compression: PowerSGD-shaped steps over a
gradient tree, the counterpart of the JAX package's
``train/grad_compression.py``.

The paper's "communicate only the low-rank factors" (§6, §4.2) applied to
each gradient-shaped matrix ``G`` (leading dims collapsed):

    P = G·Q₀;  P = orth(P);  Q = Gᵀ·P;   Ĝ = P·Qᵀ

with an error-feedback buffer ``E = G − Ĝ`` carried into the next step.
Leaves with fewer than two dims, or a side below ``min_dim``, pass through
raw.  The learning views' ring (:meth:`repro_torch.fivm.Ring.set_model`)
reuses :func:`compress_leaf`'s factors as an exact IVM delta when ``ΔB``
has rank ≤ k.  :func:`compressed_psum` all-reduces data-parallel
gradients by their factors, over one axis of a ``DeviceMesh``.

``init_compression`` takes an explicit ``torch.Generator``: the
reference seeds each leaf's Q₀ with ``hash(path)``, which changes from
process to process, so the tests hand Q₀ over from numpy
(:func:`compression_state_from_numpy`) rather than reproduce a draw.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from ..dist.sharding import ShardingCtx, all_reduce
from ..models.weights import params_from_numpy
from .optimizer import tree_map, unflatten


class CompressionState(NamedTuple):
    q: Any       # per-leaf right factors Q₀ (m, rank), None for raw leaves
    err: Any     # error-feedback buffers (n, m), None for raw leaves


def _matrix_shape(x) -> Tuple[int, int]:
    """Collapse leading dims: (a, b, …, z) → (a·b·…, z)."""
    return int(x.numel() // x.shape[-1]), int(x.shape[-1])


def _is_compressible(x: torch.Tensor, min_dim: int) -> bool:
    return x.dim() >= 2 and min(_matrix_shape(x)) >= min_dim


def init_compression(params, rank: int = 4, min_dim: int = 128,
                     generator: Optional[torch.Generator] = None
                     ) -> CompressionState:
    """Q₀ ~ N(0, 1) of shape (m, rank) for every compressible leaf, drawn
    from ``generator`` in :func:`~.optimizer.leaves` order, and zero
    error buffers; None for the other leaves."""
    def q_init(p):
        if not _is_compressible(p, min_dim):
            return None
        return torch.randn((_matrix_shape(p)[1], rank), generator=generator,
                           dtype=torch.float32, device=p.device)

    def e_init(p):
        return (torch.zeros(_matrix_shape(p), dtype=torch.float32,
                            device=p.device)
                if _is_compressible(p, min_dim) else None)

    return CompressionState(q=tree_map(q_init, params),
                            err=tree_map(e_init, params))


def compression_state_from_numpy(state, device=None) -> CompressionState:
    """A :class:`CompressionState` from the reference's (its leaves as
    numpy arrays, None where raw), on ``device`` (``None``: the card)."""
    q, err = state
    return CompressionState(q=params_from_numpy(q, device),
                            err=params_from_numpy(err, device))


def _orthonormalize(p: torch.Tensor) -> torch.Tensor:
    """Orthonormal columns by a reduced QR (k is tiny, cost O(nk²))."""
    q, _ = torch.linalg.qr(p)
    return q


def compress_leaf(g, q0: Optional[torch.Tensor], err):
    """One power-iteration step → ``(P, Q, new_err)``.  Non-matrix
    leaves (``q0`` is ``None``) pass through as ``(g, None, None)``.
    ``g``, ``q0`` and ``err`` may be numpy arrays or tensors; the
    factors come back as float32 tensors on ``g``'s device."""
    if q0 is None:
        return g, None, None
    g = torch.as_tensor(g)
    dev = g.device
    gm = g.reshape(_matrix_shape(g)).to(torch.float32) \
        + torch.as_tensor(err, dtype=torch.float32, device=dev)
    p = _orthonormalize(
        gm @ torch.as_tensor(q0, dtype=torch.float32, device=dev))
    q = gm.T @ p
    return p, q, gm - p @ q.T


def decompress_leaf(g_shape, dtype, p: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    return (p @ q.T).reshape(g_shape).to(dtype)


def compress_tree(grads, state: CompressionState):
    """→ ((grads, [("raw", g) | ("lowrank", (P, Q, shape, dtype))] in
    leaf order), new state)."""
    out: List = []

    def one(g, q0, err):
        if q0 is None:
            out.append(("raw", g))
            return None, None
        p, q, err = compress_leaf(g, q0, err)
        out.append(("lowrank", (p, q, g.shape, g.dtype)))
        return q, err

    new = tree_map(one, grads, state.q, state.err)
    return (grads, out), CompressionState(
        q=tree_map(lambda x: x[0], new), err=tree_map(lambda x: x[1], new))


def decompress_tree(compressed):
    """The gradient tree back: raw leaves as they were, low-rank leaves as
    ``P Qᵀ`` in their shape and type."""
    tree, out = compressed
    return unflatten(tree, [
        payload if kind == "raw" else decompress_leaf(
            payload[2], payload[3], payload[0], payload[1])
        for kind, payload in out])


def compression_ratio(compressed) -> float:
    """Communicated values: factored / raw."""
    _, out = compressed
    num = den = 0
    for kind, payload in out:
        if kind == "raw":
            num += payload.numel()
            den += payload.numel()
        else:
            p, q, shape, _ = payload
            num += p.numel() + q.numel()
            den += int(torch.Size(shape).numel())
    return num / max(den, 1)



def compressed_psum(mesh, axis: str, grads, state: CompressionState,
                    rank: int = 4):
    """All-reduce data-parallel gradients by all-reducing *factors*: the
    reference's two-round PowerSGD schedule on ``torch.distributed``
    collectives over the ``axis`` group of ``mesh``.

    Per matrix leaf, on every rank: ``P̄ = Σ_ranks G_r Q₀``, orthonormalise
    the reduced ``P̄``, ``Q̄ = mean_ranks G_rᵀ P̄``, ``Ĝ = P̄ Q̄ᵀ``: ``k(n +
    m)`` values on the wire instead of ``n·m``.  Leaves without a ``Q₀``
    (``state.q`` None) get a plain mean.  Every rank gets the same Ĝ.
    ``rank`` is implied by ``Q₀``'s columns; it is kept for the
    reference's signature."""
    ctx = ShardingCtx(mesh=mesh)
    world = ctx.size(axis)

    def one(g, q0):
        if q0 is None:
            return all_reduce(g.detach().clone(), axis, ctx) / world
        gm = g.reshape(_matrix_shape(g)).to(torch.float32)
        p_bar = all_reduce(gm @ q0.to(device=gm.device), axis, ctx)
        p_orth = _orthonormalize(p_bar)
        q_bar = all_reduce(gm.T @ p_orth, axis, ctx) / world
        return (p_orth @ q_bar.T).reshape(g.shape).to(g.dtype)

    return tree_map(one, grads, state.q)
