"""CUDA rank-k view update ``M += Σ_t U_t V_tᵀ`` (the trigger hot loop).

Binding for ``csrc/rank_update.cu``, built and loaded by
:mod:`.cuda_build` the first time a kernel is launched.

Entries and the TPU kernels they replace:

===========================  =================================================
``rank_update_batched``      ``rank_update_batched_pallas``
                             (``src/repro/kernels/rank_update.py:84``)
``rank_update``              ``rank_update_pallas``
                             (``src/repro/kernels/rank_update.py:40``)
``rank_update_batched_out``  both, out of place (a guarded firing's applies)
===========================  =================================================

The first two work in place on ``m``; ``rank_update_batched_out`` leaves
``m`` alone and returns ``m + Σ_t u[t] v[t]ᵀ`` in a new tensor, bitwise
what the in-place entry would leave in ``m``, and sets a flag on the card
when a value it stores is not finite.  All launch on the current CUDA
stream and never fall back to a plain version: anything the kernel does
not take raises, and so does an operand that requires grad under grad mode
(the kernel has no backward yet).  ``LAUNCHES`` counts the launches of
each entry, ``RANKS`` the same launches by their inner dimension K = T·k,
``COLS`` by M's columns p, and ``SKINNY_RANKS`` by K those that took the
skinny tile (:func:`takes_skinny`); a run that must prove it went through
the kernels resets them with :func:`reset_launches` and reads them
afterwards.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import torch

from . import cuda_build

LAUNCHES: Dict[str, int] = {"rank_update": 0, "rank_update_batched": 0,
                            "rank_update_batched_out": 0}
RANKS: Dict[str, Counter] = {name: Counter() for name in LAUNCHES}
COLS: Dict[str, Counter] = {name: Counter() for name in LAUNCHES}
SKINNY_RANKS: Dict[str, Counter] = {name: Counter() for name in LAUNCHES}

_SIGNATURES = {
    "rank_update_batched_f32": [cuda_build.PTR] * 3 + [cuda_build.I32] * 4
    + [cuda_build.PTR],
    "rank_update_f32": [cuda_build.PTR] * 3 + [cuda_build.I32] * 3
    + [cuda_build.PTR],
    "rank_update_batched_out_f32": [cuda_build.PTR] * 5
    + [cuda_build.I32] * 4 + [cuda_build.PTR],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        RANKS[name].clear()
        COLS[name].clear()
        SKINNY_RANKS[name].clear()


# The tiles of csrc/rank_update.cu (its constexprs and those of
# rank_update_tiles.cuh; a test holds them equal): p < PSKINNY takes the
# skinny tile, whose persistent grid walks its row tiles (n up to
# SKINNY_ROWS short of int32); else K <= KSTREAM the streaming tile and
# above it the compute tile, whose row tiles of STREAM_ROWS and
# COMPUTE_ROWS rows lie on gridDim.y (at most 65535).
PSKINNY = 4
KSTREAM = 40
SKINNY_ROWS = 4096
STREAM_ROWS = 64
COMPUTE_ROWS = 128
_INT32_MAX = 2 ** 31 - 1


def takes_skinny(p: int) -> bool:
    """Whether a view of p columns takes the skinny tile."""
    return p < PSKINNY


def max_rows(p: int, kdim: int) -> int:
    """The most rows of M the tile that takes p columns and K = ``kdim``
    launches over."""
    if takes_skinny(p):
        return _INT32_MAX - SKINNY_ROWS
    return 65535 * (STREAM_ROWS if kdim <= KSTREAM else COMPUTE_ROWS)


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


def _check(entry: str, m: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           inplace: bool = True) -> None:
    cuda_build.refuse_grad(entry, m, u, v)
    check_operands(m, inplace, u=u, v=v)
    if m.dim() != 2:
        raise ValueError(f"m must be 2-D, got shape {tuple(m.shape)}")
    n, p = m.shape
    kdim = u.shape[0] * u.shape[2] if u.dim() == 3 else \
        u.shape[-1] if u.dim() else 0
    if n > max_rows(p, kdim) or max((p, *u.shape, *v.shape)) >= 2 ** 31:
        raise ValueError(f"m {(n, p)} or u {tuple(u.shape)} is past the "
                         "grid of the tile that takes it, or the kernel's "
                         "int32 sizes")


def _launch(entry: str, cname: str, m: torch.Tensor, rank: int,
            *args: int) -> None:
    """Launch C entry ``cname`` with ``args`` (pointers and sizes) and m's
    current stream, raise on a refused launch, and count it under
    ``entry``, its inner dimension ``rank`` and m's columns."""
    lib = cuda_build.library("rank_update", _SIGNATURES)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        code = getattr(lib, cname)(*args, stream)
    cuda_build.check_launch(cname, code)
    p = m.shape[1]
    cuda_build.count_launch(
        LAUNCHES, entry, RANKS, rank,
        extra=[(COLS, p)] + [(SKINNY_RANKS, rank)] * takes_skinny(p))


def _check_stack(m: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> None:
    n, p = m.shape
    if u.dim() != 3 or v.dim() != 3 or u.shape[0] != v.shape[0] \
            or u.shape[1] != n or v.shape[1] != p or u.shape[2] != v.shape[2]:
        raise ValueError(f"shapes m {tuple(m.shape)}, u {tuple(u.shape)}, "
                         f"v {tuple(v.shape)} are not (n,p), (T,n,k), (T,p,k)")


def rank_update_batched(m: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """``m += Σ_t u[t] @ v[t].T`` in place; m (n, p), u (T, n, k),
    v (T, p, k), all float32, contiguous, on one CUDA device."""
    _check("rank_update_batched", m, u, v)
    _check_stack(m, u, v)
    n, p = m.shape
    t, _, k = u.shape
    if n == 0 or p == 0 or t * k == 0:
        return m
    _launch("rank_update_batched", "rank_update_batched_f32", m, t * k,
            m.data_ptr(), u.data_ptr(), v.data_ptr(), n, p, t, k)
    return m


def rank_update_batched_out(m: torch.Tensor, u: torch.Tensor,
                            v: torch.Tensor,
                            nonfinite: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``m + Σ_t u[t] @ v[t].T`` in a new tensor, ``m`` untouched; shapes
    and types as :func:`rank_update_batched`.  ``nonfinite``, a one-element
    int32 tensor on m's device, is set to 1 (never cleared) when a value
    of the result is not finite; ``None`` skips the flag.  The factors
    may share storage with ``m``: it is only read."""
    _check("rank_update_batched_out", m, u, v, inplace=False)
    _check_stack(m, u, v)
    if nonfinite is not None and (
            nonfinite.device != m.device or nonfinite.dtype != torch.int32
            or nonfinite.numel() != 1):
        raise ValueError("nonfinite must be one int32 element on "
                         f"{m.device}, got {nonfinite.dtype} "
                         f"{tuple(nonfinite.shape)} on {nonfinite.device}")
    n, p = m.shape
    t, _, k = u.shape
    out = torch.empty_like(m)
    if n == 0 or p == 0:
        return out
    if t * k == 0:
        return out.copy_(m)
    _launch("rank_update_batched_out", "rank_update_batched_out_f32", m,
            t * k, m.data_ptr(), out.data_ptr(), u.data_ptr(), v.data_ptr(),
            0 if nonfinite is None else nonfinite.data_ptr(), n, p, t, k)
    return out


def rank_update(m: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """``m += u @ v.T`` in place; m (n, p), u (n, k), v (p, k), all
    float32, contiguous, on one CUDA device."""
    _check("rank_update", m, u, v)
    n, p = m.shape
    if u.dim() != 2 or v.dim() != 2 or u.shape[0] != n or v.shape[0] != p \
            or u.shape[1] != v.shape[1]:
        raise ValueError(f"shapes m {tuple(m.shape)}, u {tuple(u.shape)}, "
                         f"v {tuple(v.shape)} are not (n,p), (n,k), (p,k)")
    k = u.shape[1]
    if n == 0 or p == 0 or k == 0:
        return m
    _launch("rank_update", "rank_update_f32", m, k, m.data_ptr(),
            u.data_ptr(), v.data_ptr(), n, p, k)
    return m
