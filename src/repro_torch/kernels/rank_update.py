"""CUDA rank-k view update ``M += Σ_t U_t V_tᵀ`` (the trigger hot loop).

Binding for ``csrc/rank_update.cu``, built and loaded by
:mod:`.cuda_build` the first time a kernel is launched.

Entries and the TPU kernels they replace:

==========================  ==================================================
``rank_update_batched``     ``rank_update_batched_pallas``
                            (``src/repro/kernels/rank_update.py:84``)
``rank_update``             ``rank_update_pallas``
                            (``src/repro/kernels/rank_update.py:40``)
==========================  ==================================================

Both work in place on ``m``, launch on the current CUDA stream, allocate
nothing and never fall back to a plain version: anything the kernel does
not take raises.  ``LAUNCHES`` counts the launches of each entry; a run
that must prove it went through the kernels resets it with
:func:`reset_launches` and reads it afterwards.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import cuda_build

LAUNCHES: Dict[str, int] = {"rank_update": 0, "rank_update_batched": 0}

_SIGNATURES = {
    "rank_update_batched_f32": [cuda_build.PTR] * 3 + [cuda_build.I32] * 4
    + [cuda_build.PTR],
    "rank_update_f32": [cuda_build.PTR] * 3 + [cuda_build.I32] * 3
    + [cuda_build.PTR],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_MAX_GRID_Y = 65535 * 64   # rows: gridDim.y is at most 65535 tiles of 64


def check_operands(out: torch.Tensor, inplace: bool = True,
                   **ins: torch.Tensor) -> None:
    """``out`` and every input are contiguous float32 CUDA tensors on one
    device, and, where the kernel writes ``out`` in place, no input
    shares its storage (the kernel would read what it writes)."""
    for name, x in (("out", out), *ins.items()):
        if x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}; the CUDA kernel "
                             "takes CUDA tensors only")
        if x.device != out.device:
            raise ValueError(f"{name} is on {x.device}, out on {out.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes float32")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (shape "
                             f"{tuple(x.shape)}, strides {x.stride()})")
    ptr = out.untyped_storage().data_ptr()
    for name, x in ins.items() if inplace else ():
        if x.numel() and x.untyped_storage().data_ptr() == ptr:
            raise ValueError(f"{name} shares storage with the output; the "
                             "in-place kernel would read what it writes")


def _check(m: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> None:
    check_operands(m, u=u, v=v)
    if m.dim() != 2:
        raise ValueError(f"m must be 2-D, got shape {tuple(m.shape)}")
    n, p = m.shape
    if n > _MAX_GRID_Y or max((p, *u.shape, *v.shape)) >= 2 ** 31:
        raise ValueError(f"m {(n, p)} or u {tuple(u.shape)} is past the "
                         "kernel's grid or its int32 sizes")


def _launch(entry: str, cname: str, m: torch.Tensor, u: torch.Tensor,
            v: torch.Tensor, *sizes: int) -> torch.Tensor:
    """Launch C entry ``cname`` on m's current stream, raise on a refused
    launch, and count it under ``entry``."""
    lib = cuda_build.library("rank_update", _SIGNATURES)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        code = getattr(lib, cname)(m.data_ptr(), u.data_ptr(), v.data_ptr(),
                                   *sizes, stream)
    cuda_build.check_launch(cname, code)
    LAUNCHES[entry] += 1
    return m


def rank_update_batched(m: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """``m += Σ_t u[t] @ v[t].T`` in place; m (n, p), u (T, n, k),
    v (T, p, k), all float32, contiguous, on one CUDA device."""
    _check(m, u, v)
    n, p = m.shape
    if u.dim() != 3 or v.dim() != 3 or u.shape[0] != v.shape[0] \
            or u.shape[1] != n or v.shape[1] != p or u.shape[2] != v.shape[2]:
        raise ValueError(f"shapes m {tuple(m.shape)}, u {tuple(u.shape)}, "
                         f"v {tuple(v.shape)} are not (n,p), (T,n,k), (T,p,k)")
    t, _, k = u.shape
    if n == 0 or p == 0 or t * k == 0:
        return m
    return _launch("rank_update_batched", "rank_update_batched_f32", m, u, v,
                   n, p, t, k)


def rank_update(m: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """``m += u @ v.T`` in place; m (n, p), u (n, k), v (p, k), all
    float32, contiguous, on one CUDA device."""
    _check(m, u, v)
    n, p = m.shape
    if u.dim() != 2 or v.dim() != 2 or u.shape[0] != n or v.shape[0] != p \
            or u.shape[1] != v.shape[1]:
        raise ValueError(f"shapes m {tuple(m.shape)}, u {tuple(u.shape)}, "
                         f"v {tuple(v.shape)} are not (n,p), (n,k), (p,k)")
    k = u.shape[1]
    if n == 0 or p == 0 or k == 0:
        return m
    return _launch("rank_update", "rank_update_f32", m, u, v, n, p, k)
