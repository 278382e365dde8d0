"""CUDA dual tall-skinny product ``(A·U, Aᵀ·V)`` with one read of A.

Binding for ``csrc/dual_matmul.cu``, built and loaded by
:mod:`.cuda_build` the first time the kernel is launched.  It replaces
``dual_matmul_pallas`` (``src/repro/kernels/dual_matmul.py:45``).

``P = A·U`` sums over every column panel of A.  The kernel writes each
panel's partial into a workspace that this wrapper allocates, and a
second pass adds the partials in a fixed order, so the result does not
change from run to run.  The entry launches on the current CUDA stream
and never falls back to a plain version.  ``LAUNCHES`` counts its
launches.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import cuda_build
from .rank_update import check_operands

LAUNCHES: Dict[str, int] = {"dual_matmul": 0}

PANEL = 32   # columns of A per block of the first pass (TILE in the source)

_SIGNATURES = {
    "dual_matmul_f32": [cuda_build.PTR] * 6 + [cuda_build.I32] * 3
    + [cuda_build.PTR],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def dual_matmul(a: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a @ u, a.T @ v)``; a (n, m), u (m, k), v (n, k), all float32,
    contiguous, on one CUDA device.  Returns new (n, k) and (m, k)
    tensors."""
    check_operands(a, inplace=False, u=u, v=v)
    if a.dim() != 2 or u.dim() != 2 or v.dim() != 2:
        raise ValueError(f"shapes a {tuple(a.shape)}, u {tuple(u.shape)}, "
                         f"v {tuple(v.shape)} are not 2-D")
    n, m = a.shape
    k = u.shape[1]
    if u.shape != (m, k) or v.shape != (n, k):
        raise ValueError(f"shapes a {(n, m)}, u {tuple(u.shape)}, v "
                         f"{tuple(v.shape)} are not (n,m), (m,k), (n,k)")
    panels = -(-m // PANEL)
    if max(n, m, k) >= 2 ** 31 or panels >= 2 ** 31:
        raise ValueError(f"a {(n, m)} or k = {k} is past the kernel's int32 "
                         "sizes")
    if n == 0 or m == 0 or k == 0:
        return (torch.zeros((n, k), dtype=torch.float32, device=a.device),
                torch.zeros((m, k), dtype=torch.float32, device=a.device))
    p = torch.empty((n, k), dtype=torch.float32, device=a.device)
    q = torch.empty((m, k), dtype=torch.float32, device=a.device)
    ws = torch.empty((panels, n, k), dtype=torch.float32, device=a.device)
    lib = cuda_build.library("dual_matmul", _SIGNATURES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.dual_matmul_f32(a.data_ptr(), u.data_ptr(), v.data_ptr(),
                                   p.data_ptr(), q.data_ptr(), ws.data_ptr(),
                                   n, m, k, stream)
    cuda_build.check_launch("dual_matmul_f32", code)
    LAUNCHES["dual_matmul"] += 1
    return p, q
