"""Plain PyTorch versions of the kernels (the ``ref.py`` contract).

They are what :mod:`repro_torch.kernels.ops` runs for CPU tensors and what
the CUDA kernels are held against on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rank_update(m: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels.rank_update: ``m + u @ v.T``."""
    return m + u @ v.T


def rank_update_batched(m: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels.rank_update_batched: ``m + Σ_t u[t] @
    v[t].T`` with u: (T, n, k), v: (T, p, k)."""
    return m + torch.einsum("tnk,tpk->np", u, v)


def rank_update_rows(m: torch.Tensor, rows: torch.Tensor, block: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels.rank_update_rows: ``m`` with
    ``block @ v.T`` added to the rows ``rows`` (an int64 index of distinct
    rows)."""
    out = m.clone()
    out[rows] += block @ v.T
    return out


def dual_matmul(a: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernels.dual_matmul: ``(a @ u, a.T @ v)``."""
    return a @ u, a.T @ v


def sherman_morrison_delta(w: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused Sherman–Morrison delta:
    Δ(E⁻¹) = L Rᵀ with ``L = −W u / (1 + vᵀ W u)``, ``R = Wᵀ v``
    (paper §4.1)."""
    u = u.reshape(-1, 1)
    v = v.reshape(-1, 1)
    wu = w @ u
    wtv = w.T @ v
    denom = 1.0 + (v.T @ wu)[0, 0]
    return -wu / denom, wtv
