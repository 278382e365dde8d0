"""LINVIEW low-rank gradient compression: one PowerSGD-shaped step.

The paper's "communicate only the low-rank factors" (§6, §4.2) applied to
a gradient-shaped matrix ``G``:

    P = G·Q₀;  P = orth(P);  Q = Gᵀ·P;   Ĝ = P·Qᵀ

with an error-feedback buffer ``E = G − Ĝ`` carried into the next step.
Only :func:`compress_leaf` is here: the learning views' ring
(:meth:`repro_torch.fivm.Ring.set_model`) reuses its factors as an exact
IVM delta when ``ΔB`` has rank ≤ k.  The collective and optimizer paths
of the JAX package's module belong to the training substrate, not yet
ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _matrix_shape(x: torch.Tensor) -> Tuple[int, int]:
    """Collapse leading dims: (a, b, …, z) → (a·b·…, z)."""
    return int(x.numel() // x.shape[-1]), int(x.shape[-1])


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
