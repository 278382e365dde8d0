"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, the first time one of its
kernels is launched (or all together by :func:`build_all`), and loaded
with :mod:`ctypes`.  Each library lands in ``_build/`` beside this file
(ignored by git), named by a hash of its source and the flags, so an
edited source (or shared ``csrc/*.cuh`` header) is rebuilt and an
unchanged one is reused.  Nothing is
built when a module is imported: :data:`LIBS` stays empty until a launch.

Threads may launch kernels side by side (the fleet's live workers): a
lock makes the first use of a source build and load it once, and
:func:`count_launch` keeps every binding's launch counts exact.

Each kernel writes its output through a raw pointer, so its result
carries no ``grad_fn``.  Flash attention alone has a backward (its
binding's autograd Function); every other binding calls
:func:`refuse_grad` first, which raises instead of letting a gradient
through a kernel come out as zero with no error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LIBS: Dict[str, ctypes.CDLL] = {}    # loaded libraries by source name
BUILD_LOGS: Dict[str, str] = {}      # nvcc's output (ptxas register counts)

PTR, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_LOAD_LOCK = threading.Lock()    # one build and one load per source
_COUNT_LOCK = threading.Lock()   # the bindings' launch counters


def sources() -> list:
    """Names of every CUDA source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError(f"nvcc not found: the kernels in {CSRC} are built "
                       "with the CUDA toolkit's compiler")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together; returns the seconds each build took (0 when the
    library already existed).  Raises if any build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        BUILD_LOGS[name] = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)   # atomic: concurrent builders race safely
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(
            f"{CSRC / n}.cu:\n{BUILD_LOGS[n]}" for n in failed))
    return seconds


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each C entry to its argument types; every entry
    returns the launch's ``cudaError_t`` as an int.  Safe from several
    threads: the first caller builds and loads, the others wait for it."""
    lib = LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            for entry, argtypes in signatures.items():
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes)
                fn.restype = I32
            LIBS[name] = lib
    return lib


def refuse_grad(entry: str, *operands,
                reason: str = "the CUDA kernel has no backward yet") -> None:
    """Raise when autograd would have to differentiate CUDA entry
    ``entry``: grad mode is on and an operand requires grad.  Called
    before any other check, so it holds on any device."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in operands):
        raise RuntimeError(
            f"{entry}: an operand requires grad, but {reason}, so its output "
            "would carry no gradient; call it under torch.no_grad() or on "
            "tensors that do not require grad")


def count_launch(launches: Dict[str, int], entry: str,
                 ranks: Optional[Dict[str, Counter]] = None,
                 rank: int = 0,
                 extra: Sequence[Tuple[Dict[str, Counter], int]] = ()
                 ) -> None:
    """Count one launch of ``entry`` in ``launches`` (and, with ``ranks``,
    one of inner dimension ``rank``; for each ``(counters, key)`` of
    ``extra``, one in ``counters[entry][key]``, as the launches by p);
    exact when threads launch at once."""
    with _COUNT_LOCK:
        launches[entry] += 1
        if ranks is not None:
            ranks[entry][rank] += 1
        for counters, key in extra:
            counters[entry][key] += 1


def check_launch(entry: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{entry} launch failed with cudaError {code}")
