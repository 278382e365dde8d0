"""Each kernel entry's work by its own formula: the FLOPs it must do and
the bytes it must move (each input read once, each output written once),
whatever runs it -- the CUDA kernel, its plain version or the shapes on
meta.  These are the formulas behind ``PERF.md`` §6's bound column.

:func:`entry` is the context a kernel entry runs in: under an active
walk (:mod:`.op_walk`) it counts the entry's formula and hides the aten
ops inside; otherwise it does nothing and evaluates no formula.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from . import op_walk
from .analysis import _wire_bytes

Work = Tuple[float, float]          # (flops, bytes)


_NO_WALK = contextlib.nullcontext()


def entry(name: str, formula: Callable[..., Work], *args, **kwargs):
    """The context a kernel entry's call runs in: under a walk, count
    ``formula(*args, **kwargs)`` (flops, bytes) under ``name`` and hide
    the ops inside; otherwise nothing (the formula is not evaluated)."""
    walk = op_walk.active()
    if walk is None:
        return _NO_WALK
    return walk.kernel(name, *formula(*args, **kwargs))


def collective(kind: str, axis: str, group_size: int,
               operand: torch.Tensor) -> int:
    """One ``all_reduce`` or ``all_gather`` of ``operand`` (a rank's
    block) over ``group_size`` ranks of mesh axis ``axis``: reported to
    the active walk, if any; returns the bytes a rank puts on the wire,
    ring counted."""
    nbytes = operand.numel() * operand.element_size()
    result = nbytes * group_size if kind == "all_gather" else nbytes
    kind = kind.replace("_", "-")
    walk = op_walk.active()
    if walk is not None:
        walk.collective(kind, axis, group_size, nbytes, result)
    return int(_wire_bytes(kind, result, nbytes, group_size))


def _nbytes(*tensors: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# -- the rank updates and the dual product ----------------------------------

def rank_update(m: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                flag: Optional[torch.Tensor] = None) -> Work:
    """M (n, p) plus Σ_t U[t] V[t]ᵀ, u (T, n, k) or (n, k), v likewise,
    in place or out of place: 2 n p T k FLOPs; M read once and written
    once (or its new copy written), the factors read, the non-finite
    flag written."""
    n, p = m.shape
    t = u.shape[0] if u.dim() == 3 else 1
    k = u.shape[-1]
    return 2.0 * n * p * t * k, 2.0 * _nbytes(m) + _nbytes(u, v, flag)


def rank_update_rows(m: torch.Tensor, rows: int, block: torch.Tensor,
                     v: torch.Tensor) -> Work:
    """M's ``rows`` listed rows plus block Vᵀ, block (r, k), v (p, k):
    2 r p k FLOPs; the rows read and written, block, V and the int32 row
    list read."""
    p, k = v.shape
    return (2.0 * rows * p * k,
            2.0 * rows * p * m.element_size() + _nbytes(block, v)
            + 4.0 * rows)


def dual_matmul(a: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> Work:
    """(A U, Aᵀ V), a (n, m), u (m, k), v (n, k): two products, 4 n m k
    FLOPs; A read once, both factors, both results written."""
    n, m = a.shape
    k = u.shape[1]
    return 4.0 * n * m * k, _nbytes(a, u, v) + (n + m) * k * a.element_size()


def select_commit(flags: torch.Tensor) -> Work:
    """The clean firing's commit: the flags read, nothing copied.  (A set
    flag copies ``old`` into ``new``; that needs the flags' values, which
    the walk does not read.)"""
    return 0.0, float(_nbytes(flags))


# -- attention ---------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def attention_pairs(s: int, causal: bool, window: Optional[int],
                    prefix_len: int = 0) -> int:
    """(query, key) pairs the mask keeps over S positions: key kp for
    query qp iff ``kp <= qp`` or both ``< prefix_len`` (causal), and
    ``kp > qp - window``."""
    qp = np.arange(s, dtype=np.int64)
    if causal:
        hi = np.where(qp < prefix_len, max(prefix_len - 1, 0), qp)
    else:
        hi = np.full_like(qp, s - 1)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros_like(qp)
    return int(np.maximum(0, np.minimum(hi, s - 1) - lo + 1).sum())


def _pairs(q: torch.Tensor, causal: bool, window: Optional[int],
           prefix_len: int) -> int:
    return attention_pairs(q.shape[1], bool(causal), window, prefix_len)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int], prefix_len: int,
                    lse: bool = False) -> Work:
    """Attention of q (B, S, H, hd) over k, v (B, S, KV, hd): Q Kᵀ and
    P V, 4 B H hd FLOPs a kept pair; q, k, v read, out (and the f32
    row log-sum-exp, (B, H, S)) written."""
    b, s, h, hd = q.shape
    flops = 4.0 * b * h * hd * _pairs(q, causal, window, prefix_len)
    return flops, 2.0 * _nbytes(q) + _nbytes(k, v) + (
        4.0 * b * h * s if lse else 0.0)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: Optional[int],
                        prefix_len: int) -> Work:
    """K1: S, dP, dQ, dK and dV, five products, 10 B H hd FLOPs a kept
    pair; q, k, v, out, dout and lse read, dq, dk, dv written."""
    b, s, h, hd = q.shape
    flops = 10.0 * b * h * hd * _pairs(q, causal, window, prefix_len)
    return flops, 4.0 * _nbytes(q) + 2.0 * _nbytes(k, v) + 4.0 * b * h * s


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 n_valid: Union[int, torch.Tensor]) -> Work:
    """One token's attention, q (B, H, hd) over ``n_valid`` slots of the
    caches (B, L, KV, hd): 4 B H hd FLOPs a slot; q and the valid slots
    of both caches read, out written.  A tensor ``n_valid`` counts every
    slot: the walk reads nothing back from the device."""
    b, h, hd = q.shape
    L, kvh = k_cache.shape[1], k_cache.shape[2]
    slots = int(n_valid) if isinstance(n_valid, int) else L
    return (4.0 * b * h * hd * slots,
            2.0 * _nbytes(q) + 2.0 * b * slots * kvh * hd
            * k_cache.element_size())


def flash_decode_lse(q: torch.Tensor, k_cache: torch.Tensor,
                     n_valid: Union[int, torch.Tensor]) -> Work:
    """:func:`flash_decode` over a rank's slots with the row statistics:
    the same FLOPs; q, the valid slots of both local caches read, out
    (f32) and lse (f32, B H) written."""
    b, h, hd = q.shape
    L, kvh = k_cache.shape[1], k_cache.shape[2]
    slots = int(n_valid) if isinstance(n_valid, int) else L
    return (4.0 * b * h * hd * slots,
            _nbytes(q) + 4.0 * b * h * (hd + 1)
            + 2.0 * b * slots * kvh * hd * k_cache.element_size())
