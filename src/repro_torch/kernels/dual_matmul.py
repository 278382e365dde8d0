"""CUDA dual tall-skinny product ``(A·U, Aᵀ·V)`` with one read of A.

Binding for ``csrc/dual_matmul.cu``, built and loaded by
:mod:`.cuda_build` the first time the kernel is launched.  It replaces
``dual_matmul_pallas`` (``src/repro/kernels/dual_matmul.py:45``).

The kernel streams A in tiles of a column strip by a row band.  Each
strip's partial of ``P = A·U`` and each band's partial of ``Q = Aᵀ·V`` go
to a workspace, and a second kernel adds them in a fixed order, so the
result does not change from run to run.  The workspace's size comes from
the library (for the shape and the card's SM count); this wrapper keeps one
buffer per device and stream, grown to the largest call, since a call
writes and reads its partials in its stream's order.  The entry launches on
the current CUDA stream and never falls back to a plain version.
``LAUNCHES`` counts its calls (one per call, whatever the kernels it
takes).  An operand that requires grad under grad mode raises: the kernel
has no backward yet.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import cuda_build
from .rank_update import check_operands

LAUNCHES: Dict[str, int] = {"dual_matmul": 0}

_SIGNATURES = {
    "dual_matmul_f32": [cuda_build.PTR] * 6 + [cuda_build.I32] * 3
    + [cuda_build.PTR],
    "dual_matmul_workspace": [cuda_build.I32] * 3
    + [ctypes.POINTER(ctypes.c_longlong)],
}

# floats of workspace by (n, m, k, device index), from the library's plan
_WORKSPACE: Dict[Tuple[int, int, int, int], int] = {}
# the workspace buffer of each (device index, stream)
_BUFFERS: Dict[Tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _workspace(lib, n: int, m: int, k: int, device: int) -> int:
    key = (n, m, k, device)
    floats = _WORKSPACE.get(key)
    if floats is None:
        out = ctypes.c_longlong()
        cuda_build.check_launch("dual_matmul_workspace",
                                lib.dual_matmul_workspace(n, m, k, out))
        floats = _WORKSPACE[key] = out.value
    return floats


def dual_matmul(a: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a @ u, a.T @ v)``; a (n, m), u (m, k), v (n, k), all float32,
    contiguous, on one CUDA device.  Returns new (n, k) and (m, k)
    tensors."""
    cuda_build.refuse_grad("dual_matmul", a, u, v)
    check_operands(a, inplace=False, u=u, v=v)
    if a.dim() != 2 or u.dim() != 2 or v.dim() != 2:
        raise ValueError(f"shapes a {tuple(a.shape)}, u {tuple(u.shape)}, "
                         f"v {tuple(v.shape)} are not 2-D")
    n, m = a.shape
    k = u.shape[1]
    if u.shape != (m, k) or v.shape != (n, k):
        raise ValueError(f"shapes a {(n, m)}, u {tuple(u.shape)}, v "
                         f"{tuple(v.shape)} are not (n,m), (m,k), (n,k)")
    if max(n, m, k) >= 2 ** 31:
        raise ValueError(f"a {(n, m)} or k = {k} is past the kernel's int32 "
                         "sizes")
    device = a.device
    if n == 0 or m == 0 or k == 0:
        return (torch.zeros((n, k), dtype=torch.float32, device=device),
                torch.zeros((m, k), dtype=torch.float32, device=device))
    lib = cuda_build.library("dual_matmul", _SIGNATURES)
    index = device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):   # the launch goes to a's card
            return _launch(lib, a, u, v, n, m, k, index)
    return _launch(lib, a, u, v, n, m, k, index)


def _launch(lib, a, u, v, n, m, k, index):
    stream = torch.cuda.current_stream(index).cuda_stream
    floats = _workspace(lib, n, m, k, index)
    ws = None   # no workspace where one block covers A
    if floats:
        ws = _BUFFERS.get((index, stream))
        if ws is None or ws.numel() < floats:
            ws = _BUFFERS[index, stream] = torch.empty(
                (floats,), dtype=torch.float32, device=a.device)
    p = torch.empty((n, k), dtype=torch.float32, device=a.device)
    q = torch.empty((m, k), dtype=torch.float32, device=a.device)
    code = lib.dual_matmul_f32(a.data_ptr(), u.data_ptr(), v.data_ptr(),
                               p.data_ptr(), q.data_ptr(),
                               ws.data_ptr() if floats else None, n, m, k,
                               stream)
    cuda_build.check_launch("dual_matmul_f32", code)
    cuda_build.count_launch(LAUNCHES, "dual_matmul")
    return p, q
