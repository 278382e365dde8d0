"""Public kernel ops, dispatched by the device of their tensors.

A CPU tensor takes the plain version in :mod:`.ref`; any other tensor
takes the CUDA kernel (:mod:`.rank_update`, :mod:`.rank_update_rows`,
:mod:`.dual_matmul`, :mod:`.flash_attention`, :mod:`.flash_decode`), which
launches or raises.  The update ops work in
place on ``m`` and return it.  The CUDA kernels mask ragged edges
themselves and take row indices directly, so no block picking, slab plan
or ragged fallback is needed here.
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
from .rank_update_rows import RowSet


def rank_update(m: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """``m += u @ v.T`` in place — one rank-k view update."""
    if m.device.type == "cpu":
        return m.copy_(ref.rank_update(m, u, v))
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
    if m.device.type == "cpu":
        return m.copy_(ref.rank_update_batched(m, u, v))
    return _cuda.rank_update_batched(m, u, v)


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
    if m.device.type == "cpu":
        return m.copy_(ref.rank_update_rows(m, rows.index(m.device), block,
                                            v))
    return _cuda_rows.rank_update_rows(m, rows, block, v)


def dual_matmul(a: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(a @ u, a.T @ v)`` — one pass over ``a``."""
    if a.device.type == "cpu":
        return ref.dual_matmul(a, u, v)
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
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """Softmax attention, q (B, S, H, hd) over k/v (B, S, KV, hd) with
    grouped-query heads, causal and optionally windowed (keep key kp for
    query qp iff ``kp <= qp`` and ``kp > qp - window``)."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    return _cuda_fa.flash_attention(q, k, v, causal=causal, window=window)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor,
                 n_valid: Union[int, torch.Tensor]) -> torch.Tensor:
    """One decode step's attention: q (B, H, hd) over the first
    ``n_valid`` slots of the caches (B, L, KV, hd); ``n_valid`` an int or
    a one-element int32 tensor on q's device (read there)."""
    if q.device.type == "cpu":
        return ref.flash_decode(q, k_cache, v_cache, n_valid)
    return _cuda_fd.flash_decode(q, k_cache, v_cache, n_valid)
