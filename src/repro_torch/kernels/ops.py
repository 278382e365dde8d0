"""Public rank-update ops, dispatched by the device of the view.

A CPU tensor takes the plain version in :mod:`.ref`; any other tensor
takes the CUDA kernel in :mod:`.rank_update`, which launches or raises.
Both update ``m`` in place and return it.  The CUDA kernel masks ragged
edges itself, so no block picking or ragged fallback is needed here.
"""

from __future__ import annotations

import torch

from . import rank_update as _cuda
from . import ref


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
