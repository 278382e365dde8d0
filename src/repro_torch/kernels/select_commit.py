"""CUDA select-commit of a guarded firing: ``new = old if any(flags)``.

Binding for ``csrc/select_commit.cu``, built and loaded by
:mod:`.cuda_build` the first time the kernel is launched.  It replaces no
Pallas kernel: the reference fuses ``jnp.where(ok, new, old)`` into its
jitted firing (``src/repro/guard/__init__.py:316``).  In the port a
transactional firing writes each view out of place, and this kernel is
its commit: it copies the pre-firing view over the firing's result only
when a flag on the card says the firing failed, so a clean firing moves
no bytes and the host never waits for the verdict.

The entry works in place on ``new``, launches on the current CUDA stream,
allocates nothing and never falls back to a plain version; an operand that
requires grad under grad mode raises (no backward yet).  ``LAUNCHES``
counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import cuda_build
from .rank_update import check_operands

LAUNCHES: Dict[str, int] = {"select_commit": 0}

_SIGNATURES = {
    "select_commit_f32": [cuda_build.PTR, cuda_build.I32, cuda_build.PTR,
                          cuda_build.PTR, ctypes.c_int64, cuda_build.PTR],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def select_commit(flags: torch.Tensor, old: torch.Tensor,
                  new: torch.Tensor) -> torch.Tensor:
    """``new`` := ``old`` when any int32 of ``flags`` is nonzero, else
    ``new`` unchanged; in place on ``new``, which is returned.  ``old``
    and ``new`` are float32 tensors of one shape, contiguous, on the
    device of ``flags``, in storage of their own."""
    cuda_build.refuse_grad("select_commit", old, new)
    check_operands(new, old=old)
    if old.shape != new.shape:
        raise ValueError(f"old {tuple(old.shape)} and new "
                         f"{tuple(new.shape)} differ in shape")
    if flags.device != new.device or flags.dtype != torch.int32 \
            or not flags.is_contiguous() or flags.numel() == 0:
        raise ValueError(f"flags must be contiguous int32 on {new.device}, "
                         f"got {flags.dtype} {tuple(flags.shape)} on "
                         f"{flags.device}")
    if new.numel() == 0:
        return new
    lib = cuda_build.library("select_commit", _SIGNATURES)
    with torch.cuda.device(new.device):
        stream = torch.cuda.current_stream(new.device).cuda_stream
        code = lib.select_commit_f32(flags.data_ptr(), flags.numel(),
                                     old.data_ptr(), new.data_ptr(),
                                     new.numel(), stream)
    cuda_build.check_launch("select_commit_f32", code)
    cuda_build.count_launch(LAUNCHES, "select_commit")
    return new
