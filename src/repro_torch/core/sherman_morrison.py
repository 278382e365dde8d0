"""Numeric Sherman–Morrison / Woodbury primitives (paper §4.1).

The runtime counterparts of the symbolic rule in
``factored.lowrank_inverse_woodbury``, for callers that maintain an
inverse by hand and for tests as oracles.  Plain torch on the tensors'
device; :func:`repro_torch.kernels.ops.sherman_morrison_delta` is the
same delta on the dual-matmul kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def sherman_morrison(w: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """New inverse of ``E + u vᵀ`` given ``w = E⁻¹`` — O(n²), no inversion.

    ``u``, ``v`` are (n,1) column vectors (or (n,) — reshaped).
    """
    u = u.reshape(-1, 1)
    v = v.reshape(-1, 1)
    wu = w @ u                       # n×1
    vtw = v.T @ w                    # 1×n
    denom = 1.0 + (vtw @ u)[0, 0]
    return w - (wu @ vtw) / denom


def sherman_morrison_delta(w: Tensor, u: Tensor, v: Tensor
                           ) -> Tuple[Tensor, Tensor]:
    """Factored delta of the inverse: Δ(E⁻¹) = p qᵀ (paper §4.1)."""
    u = u.reshape(-1, 1)
    v = v.reshape(-1, 1)
    wu = w @ u
    wtv = w.T @ v
    denom = 1.0 + (v.T @ wu)[0, 0]
    return -wu / denom, wtv


def woodbury(w: Tensor, p: Tensor, q: Tensor) -> Tensor:
    """New inverse of ``E + P Qᵀ`` for rank-k P,Q given ``w = E⁻¹``.

    (E + PQᵀ)⁻¹ = W − W P (I_k + Qᵀ W P)⁻¹ Qᵀ W — only a k×k inversion.
    """
    wp = w @ p                                               # n×k
    cap = torch.eye(p.shape[1], dtype=w.dtype, device=w.device) + q.T @ wp
    return w - wp @ torch.linalg.solve(cap, q.T @ w)


def woodbury_delta(w: Tensor, p: Tensor, q: Tensor) -> Tuple[Tensor, Tensor]:
    """Factored delta (L, R) with Δ(E⁻¹) = L Rᵀ, rank k."""
    wp = w @ p
    cap = torch.eye(p.shape[1], dtype=w.dtype, device=w.device) + q.T @ wp
    l = -wp @ torch.linalg.inv(cap)
    r = w.T @ q
    return l, r
