"""Public kernel ops, dispatched by the device of their tensors.

A CPU tensor takes the plain version in :mod:`.ref`; a meta tensor gets
outputs of the right shape and type and nothing else (the dry-run's
walk); any other tensor takes the CUDA kernel (:mod:`.rank_update`,
:mod:`.rank_update_rows`, :mod:`.dual_matmul`, :mod:`.flash_attention`,
:mod:`.flash_decode`, :mod:`.select_commit`), which launches or raises.
Each entry runs in :func:`~repro_torch.roofline.kernel_work.entry`:
under a walk (:mod:`repro_torch.roofline.op_walk`) it counts its own
FLOPs and bytes by formula and hides the ops inside, whichever branch
runs.  The update ops work in place on ``m`` and return it, except
:func:`rank_update_batched_out`, which returns a new tensor.  The CUDA
kernels mask ragged edges themselves and take row indices directly, so
no block picking, slab plan or ragged fallback is needed here.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import dual_matmul as _cuda_dual
from . import flash_attention as _cuda_fa
from . import flash_decode as _cuda_fd
from . import rank_update as _cuda
from . import rank_update_rows as _cuda_rows
from . import ref
from . import select_commit as _cuda_select
from ..roofline import kernel_work as work
from .rank_update_rows import RowSet


def _meta(x: torch.Tensor) -> bool:
    return x.device.type == "meta"


def rank_update(m: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """``m += u @ v.T`` in place — one rank-k view update."""
    with work.entry("rank_update", work.rank_update, m, u, v):
        if m.device.type == "cpu":
            return m.copy_(ref.rank_update(m, u, v))
        if _meta(m):
            return m
        return _cuda.rank_update(m, u, v)


def rank_update_batched(m: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """``m += Σ_t u[t] @ v[t].T`` in place — T coalesced trigger applies
    in one pass over ``m``.

    u: (T, n, k), v: (T, p, k).  2-D (n, k)/(p, k) factors are the T=1
    case (a view, not a copy).
    """
    if u.dim() == 2:
        u = u[None]
        v = v[None]
    with work.entry("rank_update_batched", work.rank_update, m, u, v):
        if m.device.type == "cpu":
            return m.copy_(ref.rank_update_batched(m, u, v))
        if _meta(m):
            return m
        return _cuda.rank_update_batched(m, u, v)


def rank_update_batched_out(m: torch.Tensor, u: torch.Tensor,
                            v: torch.Tensor,
                            nonfinite: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``m + Σ_t u[t] @ v[t].T`` in a new tensor, ``m`` untouched — the
    out-of-place apply of a guarded firing.  ``nonfinite`` (one int32 on
    m's device) is set to 1 when a value of the result is not finite and
    never cleared.  Factors as :func:`rank_update_batched`."""
    if u.dim() == 2:
        u = u[None]
        v = v[None]
    with work.entry("rank_update_batched_out", work.rank_update, m, u, v,
                    nonfinite):
        if m.device.type == "cpu":
            out, bad = ref.rank_update_batched_out(m, u, v)
            if nonfinite is not None:
                nonfinite.bitwise_or_(bad.to(torch.int32))
            return out
        if _meta(m):
            return torch.empty_like(m)
        return _cuda.rank_update_batched_out(m, u, v, nonfinite)


def select_commit(flags: torch.Tensor, old: torch.Tensor,
                  new: torch.Tensor) -> torch.Tensor:
    """``new`` := ``old`` in place when any of the int32 ``flags`` is
    nonzero, else ``new`` as it is: a guarded firing's commit or
    rollback, decided on the device without a host sync."""
    with work.entry("select_commit", work.select_commit, flags):
        if new.device.type == "cpu":
            return new.copy_(ref.select_commit(flags, old, new))
        if _meta(new):
            return new
        return _cuda_select.select_commit(flags, old, new)


def rank_update_rows(m: torch.Tensor, rows, block: torch.Tensor,
                     v: torch.Tensor, *, max_fraction: float = 0.25
                     ) -> torch.Tensor:
    """Row-local rank-k view update ``m[rows] += block @ v.T`` in place.

    ``rows`` (r,) are the affected rows (strictly increasing, as a host
    array or a :class:`RowSet`), ``block`` (r, k) the compact left
    factor, ``v`` (p, k).  Only the listed rows are read and written.
    Past ``max_fraction`` of the rows the row sweep buys nothing, so the
    block is scattered into a dense (n, k) factor and the dense
    :func:`rank_update` runs instead.
    """
    n = m.shape[0]
    rows = RowSet.of(rows, n)
    if len(rows) > max_fraction * n:
        u = torch.zeros((n, v.shape[1]), dtype=torch.float32,
                        device=m.device)
        u[rows.index(m.device)] = block
        return rank_update(m, u, v)
    with work.entry("rank_update_rows", work.rank_update_rows, m,
                    len(rows), block, v):
        if m.device.type == "cpu":
            return m.copy_(ref.rank_update_rows(m, rows.index(m.device),
                                                block, v))
        if _meta(m):
            return m
        return _cuda_rows.rank_update_rows(m, rows, block, v)


def dual_matmul(a: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(a @ u, a.T @ v)`` — one pass over ``a``."""
    with work.entry("dual_matmul", work.dual_matmul, a, u, v):
        if a.device.type == "cpu":
            return ref.dual_matmul(a, u, v)
        if _meta(a):
            return (a.new_empty((a.shape[0], u.shape[1])),
                    a.new_empty((a.shape[1], v.shape[1])))
        return _cuda_dual.dual_matmul(a, u, v)


def sherman_morrison_delta(w: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Sherman–Morrison factored delta (paper §4.1) on the
    dual-matmul kernel: one pass over W gives both W·u and Wᵀ·v."""
    u = u.reshape(-1, 1).contiguous()
    v = v.reshape(-1, 1).contiguous()
    wu, wtv = dual_matmul(w, u, v)
    denom = 1.0 + (v.T @ wu)[0, 0]
    return -wu / denom, wtv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """Softmax attention, q (B, S, H, hd) over k/v (B, S, KV, hd) with
    grouped-query heads, causal (with an optional bidirectional prefix of
    ``prefix_len`` positions) or full, optionally windowed: keep key kp
    for query qp iff ``kp <= qp`` or ``qp, kp < prefix_len`` (causal), and
    ``kp > qp - window``.

    Under grad mode with an operand that requires grad, the card runs the
    ``FlashAttention`` Function (the forward with LSE, then K1); so does
    meta (on the shapes) and, under a walk, the CPU (on the plain
    versions), so that a walked step counts the same entries everywhere.
    Otherwise the CPU differentiates the plain version, as before."""
    opts = dict(causal=causal, window=window, prefix_len=prefix_len)
    dev = q.device.type
    if dev in ("cpu", "meta") and torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)) and (
            dev == "meta" or work.op_walk.active() is not None):
        pair = (ref.flash_attention_lse, ref.flash_attention_bwd) \
            if dev == "cpu" else (_cuda_fa.meta_fwd_lse, _cuda_fa.meta_bwd)
        return _cuda_fa.FlashAttention.apply(q, k, v, causal, window,
                                             prefix_len, *pair)
    if dev not in ("cpu", "meta") and torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        return _cuda_fa.flash_attention(q, k, v, **opts)
    with work.entry("flash_attention", work.flash_attention, q, k, v,
                    **opts):
        if dev == "cpu":
            return ref.flash_attention(q, k, v, **opts)
        if dev == "meta":
            return torch.empty_like(q)
        return _cuda_fa.flash_attention(q, k, v, **opts)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor,
                 n_valid: Union[int, torch.Tensor]) -> torch.Tensor:
    """One decode step's attention: q (B, H, hd) over the first
    ``n_valid`` slots of the caches (B, L, KV, hd); ``n_valid`` an int or
    a one-element int32 tensor on q's device (read there)."""
    with work.entry("flash_decode", work.flash_decode, q, k_cache,
                    n_valid):
        if q.device.type == "cpu":
            return ref.flash_decode(q, k_cache, v_cache, n_valid)
        if _meta(q):
            return torch.empty_like(q)
        return _cuda_fd.flash_decode(q, k_cache, v_cache, n_valid)


def flash_decode_lse(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     n_valid: Union[int, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_decode` with its row statistics, for a rank's slots of
    a cache split over ranks: (out (B, H, hd) f32, unrounded; lse (B, H)
    f32, each query row's log-sum-exp).  ``n_valid`` may be a device
    tensor holding 0 (no valid slot: out 0, lse -inf)."""
    with work.entry("flash_decode_lse", work.flash_decode_lse, q, k_cache,
                    n_valid):
        if q.device.type == "cpu":
            return ref.flash_decode_lse(q, k_cache, v_cache, n_valid)
        if _meta(q):
            return (q.new_empty(q.shape, dtype=torch.float32),
                    q.new_empty(q.shape[:2], dtype=torch.float32))
        return _cuda_fd.flash_decode_lse(q, k_cache, v_cache, n_valid)
