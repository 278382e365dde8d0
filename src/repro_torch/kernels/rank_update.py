"""CUDA rank-k view update ``M += Σ_t U_t V_tᵀ`` (the trigger hot loop).

Binding for ``csrc/rank_update.cu``: the source is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface the first
time a kernel is launched, then loaded with :mod:`ctypes`.  The library
lands in ``_build/`` beside this file (ignored by git), named by a hash of
the source and flags, so an edited source is rebuilt and an unchanged one
is reused.

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

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

SOURCE = Path(__file__).parent / "csrc" / "rank_update.cu"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"rank_update": 0, "rank_update_batched": 0}

_lib: Optional[ctypes.CDLL] = None
BUILD_LOG = ""   # nvcc's output of the last build (ptxas register counts)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the rank-update kernel is built from "
                       f"{SOURCE} with the CUDA toolkit's compiler")


def build() -> float:
    """Compile (if needed) and load the kernel library; returns seconds."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"librank_update_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{BUILD_LOG}")
        os.replace(tmp, out)   # atomic: concurrent builders race safely
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rank_update_batched_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                                            i32, ptr]
    lib.rank_update_batched_f32.restype = i32
    lib.rank_update_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.rank_update_f32.restype = i32
    _lib = lib
    return time.perf_counter() - t0


_MAX_GRID_Y = 65535 * 64   # rows: gridDim.y is at most 65535 tiles of 64


def _check(m: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("m", m), ("u", u), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}; the CUDA kernel "
                             "takes CUDA tensors only")
        if x.device != m.device:
            raise ValueError(f"{name} is on {x.device}, m on {m.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes float32")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (shape "
                             f"{tuple(x.shape)}, strides {x.stride()})")
    if m.dim() != 2:
        raise ValueError(f"m must be 2-D, got shape {tuple(m.shape)}")
    n, p = m.shape
    if n > _MAX_GRID_Y or max((p, *u.shape, *v.shape)) >= 2 ** 31:
        raise ValueError(f"m {(n, p)} or u {tuple(u.shape)} is past the "
                         "kernel's grid or its int32 sizes")
    ms = m.untyped_storage().data_ptr()
    for name, x in (("u", u), ("v", v)):
        if x.numel() and x.untyped_storage().data_ptr() == ms:
            raise ValueError(f"{name} shares storage with m; the in-place "
                             "kernel would read what it writes")


def _launch(entry: str, cname: str, m: torch.Tensor, u: torch.Tensor,
            v: torch.Tensor, *sizes: int) -> torch.Tensor:
    """Launch C entry ``cname`` on m's current stream, raise on a refused
    launch, and count it under ``entry``."""
    build()
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        code = getattr(_lib, cname)(m.data_ptr(), u.data_ptr(), v.data_ptr(),
                                    *sizes, stream)
    if code != 0:
        raise RuntimeError(f"{cname} launch failed with cudaError {code}")
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
