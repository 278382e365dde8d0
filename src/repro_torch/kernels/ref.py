"""Plain PyTorch versions of the kernels (the ``ref.py`` contract).

They are what :mod:`repro_torch.kernels.ops` runs for CPU tensors and what
the CUDA kernels are held against on the card.
"""

from __future__ import annotations

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
