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

On a mesh (``specs``: the gradients' placement, :meth:`LM.param_specs`)
each rank holds local blocks, and a sketch of a block is not a block of
the sketch: every leaf is compressed as the single device compresses the
whole leaf.  Compressibility and Q₀ are decided on the whole leaf's
shape (:func:`init_compression`: a rank's Q₀ is its block of the whole
Q₀), and the products that span ranks are summed over the axes that
split them (the model axis, and under the ``"fsdp"`` rule the data
axes):

* a leaf split on its last dimension (the collapsed matrix's columns):
  ``P = Σ_r G_r Q₀_r`` (an all-reduce of n×k over the column axes; a
  packed leaf's replicated columns counted once), orthonormalised on
  every rank, ``Q_r = G_rᵀ P``;
* a leaf split on an earlier dimension (its collapsed rows interleave by
  layer): ``P_r = G_r Q₀``, all-gathered over the row axes into the whole
  P in global row order and orthonormalised on every rank, each rank
  keeping its rows, ``Q = Σ_r G_rᵀ P_r`` (an all-reduce of m×k);
* a leaf split on both (data on one, model on the other): P summed over
  the column axes, then gathered over the row axes, Q summed over the
  row axes;
* a replicated leaf compresses on its own.

``Ĝ_r = P_r Q_rᵀ``, and the error buffers have the local shape.
"""

from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from ..dist import sharding
from ..dist.sharding import (P, Packed, ShardingCtx, all_reduce,
                             current_ctx, gather, global_shape, local_block)
from ..models.weights import params_from_numpy
from .optimizer import tree_map, unflatten


class CompressionState(NamedTuple):
    q: Any       # per-leaf right factors Q₀ (m, rank), None for raw leaves
    err: Any     # error-feedback buffers (n, m), None for raw leaves


def _matrix_shape(x) -> Tuple[int, int]:
    """Collapse leading dims: (a, b, …, z) → (a·b·…, z).  ``x`` is a
    tensor or a shape."""
    shape = tuple(getattr(x, "shape", x))
    return int(math.prod(shape[:-1])), int(shape[-1])


def _is_compressible(x, min_dim: int) -> bool:
    shape = tuple(getattr(x, "shape", x))
    return len(shape) >= 2 and min(_matrix_shape(shape)) >= min_dim


def init_compression(params, rank: int = 4, min_dim: int = 128,
                     generator: Optional[torch.Generator] = None,
                     specs=None) -> CompressionState:
    """Q₀ ~ N(0, 1) of shape (m, rank) for every compressible leaf, drawn
    from ``generator`` in :func:`~.optimizer.leaves` order, and zero
    error buffers; None for the other leaves.  With ``specs`` (the
    params' placement on the active mesh) ``params`` are local blocks:
    compressibility and Q₀ are decided and drawn on each whole leaf, as
    the single device draws them, the rank keeps its block of Q₀, and the
    error buffers have the local shape."""
    whole = (tree_map(lambda p: p.shape, params) if specs is None else
             tree_map(lambda p, spec: global_shape(p.shape, spec), params,
                      specs))

    def q_init(p, shape):
        if not _is_compressible(shape, min_dim):
            return None
        return torch.randn((_matrix_shape(shape)[1], rank),
                           generator=generator, dtype=torch.float32,
                           device=p.device)

    def e_init(p, shape):
        return (torch.zeros(_matrix_shape(p), dtype=torch.float32,
                            device=p.device)
                if _is_compressible(shape, min_dim) else None)

    q = tree_map(q_init, params, whole)
    if specs is not None:
        q = tree_map(_q_block, q, specs, whole)
    return CompressionState(q=q, err=tree_map(e_init, params, whole))


def _last_entry(spec, ndim: int):
    """The placement of a leaf's last dimension (specs leave out trailing
    Nones)."""
    return spec[ndim - 1] if len(spec) == ndim else None


def _q_block(q: Optional[torch.Tensor], spec, shape
             ) -> Optional[torch.Tensor]:
    """The rank's rows of a whole leaf's Q₀: its block of the leaf's last
    dimension (Q₀'s rows), under the active mesh."""
    if q is None:
        return None
    return local_block(q, P(_last_entry(spec, len(shape))))


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


def compress_leaf_sharded(g: torch.Tensor, q0: Optional[torch.Tensor],
                          err, spec, ctx: Optional[ShardingCtx] = None):
    """:func:`compress_leaf` of a rank's block ``g`` of a leaf placed by
    ``spec`` on the active mesh: ``(P_r, Q_r, new_err)``, the rank's
    blocks of the whole leaf's factors (``P_r Q_rᵀ`` is its block of Ĝ).
    The leaf may be split on its last dimension (the collapsed matrix's
    columns), on one earlier dimension (its rows), or on both, each over
    its own axes (the model axis, the ``"fsdp"`` rule's data axes):
    ``P = G·Q₀`` summed over the column axes, orthonormalised from P
    gathered over the row axes, ``Q = Gᵀ·P`` summed over the row axes.
    Collectives over those axes (every rank on them calls it); a
    replicated leaf compresses on its own."""
    ctx = ctx or current_ctx()
    if q0 is None:
        return g, None, None
    split = [d for d, e in enumerate(spec) if e is not None]
    if not split:
        return compress_leaf(g, q0, err)
    last = g.dim() - 1
    rows = [d for d in split if d != last]
    col = spec[last] if last in split else None
    if len(rows) > 1 or (rows and isinstance(spec[rows[0]], Packed)):
        raise NotImplementedError(
            f"compression of a leaf placed {spec}: at most one earlier "
            "dimension split, a packed one last")
    gm = g.reshape(_matrix_shape(g)).to(torch.float32) + err
    q0 = q0.to(torch.float32)
    own = q0
    col_axes = sharding.spec_axes(P(col))
    if isinstance(col, Packed) and ctx.coord(col_axes):
        # a packed leaf's replicated columns counted on the first rank only
        own = q0 * torch.cat([
            torch.full((w // ctx.size(col_axes) if e else w,),
                       float(bool(e)), device=q0.device)
            for w, e in col])[:, None]
    p = gm @ own
    if col_axes:
        p = all_reduce(p, col_axes, ctx)
    if not rows:
        p = _orthonormalize(p)
        q = gm.T @ p
    else:
        # rows, which interleave by the leading dimensions: the whole P in
        # global row order, each rank keeping its rows
        dim, entry = rows[0], spec[rows[0]]
        row_axes = sharding.spec_axes(P(entry))
        k = q0.shape[1]
        whole = gather(p.reshape(*g.shape[:-1], k), dim, row_axes, ctx)
        p = local_block(_orthonormalize(whole.reshape(-1, k)).reshape(
            whole.shape), P(*([None] * dim), entry)).reshape(-1, k)
        q = all_reduce(gm.T @ p, row_axes, ctx)
    return p, q, gm - p @ q.T


def decompress_leaf(g_shape, dtype, p: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    return (p @ q.T).reshape(g_shape).to(dtype)


def compress_tree(grads, state: CompressionState, specs=None):
    """→ ((grads, [("raw", g) | ("lowrank", (P, Q, shape, dtype))] in
    leaf order), new state).  With ``specs`` (the gradients' placement on
    the active mesh) the leaves and the state are local blocks, each
    compressed as its whole leaf is (:func:`compress_leaf_sharded`)."""
    out: List = []

    def one(g, q0, err, *spec):
        if q0 is None:
            out.append(("raw", g))
            return None, None
        p, q, err = (compress_leaf_sharded(g, q0, err, spec[0]) if spec
                     else compress_leaf(g, q0, err))
        out.append(("lowrank", (p, q, g.shape, g.dtype)))
        return q, err

    rest = () if specs is None else (specs,)
    new = tree_map(one, grads, state.q, state.err, *rest)
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
