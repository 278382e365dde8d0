"""CUDA flash decoding: one query token per sequence over a KV cache.

Binding for ``csrc/flash_decode.cu``, built and loaded by
:mod:`.cuda_build` the first time the kernel is launched.  It replaces
``flash_decode_pallas`` (``src/repro/kernels/flash_decode.py:69``) and its
wrapper's ``acc / l`` (``src/repro/kernels/ops.py:214``), and computes the
reference model's decode attention: each group of H / KV query heads over
its KV head's first ``n_valid`` cache slots.

``n_valid`` is a Python int or an int32 tensor of one element on q's
device, which the kernel reads on the card (the reference's ``length``
array): nothing is read back to the host.  The launch depends only on the
cache's shape and the SM count (:func:`split_plan`), so a call has the
same arguments at every step and can be captured in a CUDA graph.  A
bf16 cache runs on the tensor cores, a block streaming whole cache rows of
up to :data:`BLOCK_KV_HEADS` heads; an f32 cache on the FMA pipes.  The
partial ``(acc, m, l)`` of the splits are merged in a fixed order by a
second launch; one call counts once in ``LAUNCHES``.  The entry launches
on the current CUDA stream, allocates its output and one workspace with
``torch.empty``, and never falls back to the plain version.
"""

from __future__ import annotations

import functools
import math
import operator
from typing import Dict, Tuple, Union

import torch

from . import cuda_build
from .flash_attention import check_attention_operands, check_heads

LAUNCHES: Dict[str, int] = {"flash_decode": 0}

TILE = 64           # cache slots the split plan counts in
MAX_GROUP = 16      # query heads per KV head
MAX_SPLITS = 64     # splits per (batch, block of KV heads)
#: KV heads one bf16 block covers at most (csrc's TC_HEADS): a block takes
#: gcd(KV, BLOCK_KV_HEADS) neighbouring heads; an f32 block takes one
BLOCK_KV_HEADS = 4
#: blocks an SM holds at once: the split plan fills the card once with them
BLOCKS_PER_SM = {torch.bfloat16: 1, torch.float32: 2}

_SIGNATURES = {"flash_decode_fwd": [cuda_build.PTR] * 6
               + [cuda_build.I32] * 8 + [cuda_build.F32, cuda_build.PTR]}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def split_plan(b: int, groups: int, L: int, sms: int,
               per_sm: int = 1) -> Tuple[int, int]:
    """(chunk, nsplit) for caches of ``L`` slots read by ``groups`` blocks
    a batch row (one per block of KV heads): ``nsplit`` splits of at most
    ``chunk`` slots (a multiple of :data:`TILE`) cover all L, and the
    ``b * groups * nsplit`` blocks fill ``sms`` SMs at most ``per_sm``
    times, so that the grid runs in one wave (at most :data:`MAX_SPLITS`
    splits).  The kernel divides the valid slots' tiles among the same
    ``nsplit`` splits on the card."""
    tiles = -(-L // TILE)
    want = max(1, per_sm * sms // (b * groups))
    chunk = -(-tiles // min(tiles, want, MAX_SPLITS)) * TILE
    return chunk, -(-L // chunk)


@functools.lru_cache(maxsize=64)
def _splits(device: torch.device, dtype: torch.dtype, b: int, kvh: int,
            L: int) -> int:
    """The kernel's nsplit for a cache of this type and shape on device."""
    heads = math.gcd(kvh, BLOCK_KV_HEADS) if dtype == torch.bfloat16 else 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return split_plan(b, kvh // heads, L, sms, BLOCKS_PER_SM[dtype])[1]


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor,
                 n_valid: Union[int, torch.Tensor]) -> torch.Tensor:
    """Attention of q (B, H, hd) over slots ``0 .. n_valid-1`` of the
    caches (B, L, KV, hd).  ``n_valid``: an int in [1, L], or an int32
    tensor of shape () or (1,) on q's device (read on the card, clamped to
    [0, L]).  Returns (B, H, hd) in q's type."""
    dtype = check_attention_operands(q=q, k_cache=k_cache, v_cache=v_cache)
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != q.shape[0] \
            or k_cache.shape[3] != q.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}"
                         f", v {tuple(v_cache.shape)} are not (B,H,hd), "
                         "(B,L,KV,hd)")
    b, h, hd = q.shape
    L, kvh = k_cache.shape[1], k_cache.shape[2]
    check_heads(h, kvh, hd)
    if h // kvh > MAX_GROUP:
        raise ValueError(f"{h // kvh} query heads per KV head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if b > 65535 or kvh > 65535:
        raise ValueError(f"batch {b} or KV heads {kvh} past the grid")
    if isinstance(n_valid, torch.Tensor):
        if n_valid.dtype != torch.int32 or n_valid.dim() > 1 \
                or n_valid.numel() != 1 or n_valid.device != q.device:
            raise ValueError(f"n_valid must be an int32 tensor of shape () "
                             f"or (1,) on {q.device}, not {n_valid.dtype} "
                             f"{tuple(n_valid.shape)} on {n_valid.device}")
        n_ptr, n_host = n_valid.data_ptr(), 0
    else:
        n_ptr, n_host = None, operator.index(n_valid)
        if not 1 <= n_host <= L:
            raise ValueError(f"n_valid {n_host} outside [1, {L}]")
    nsplit = _splits(q.device, dtype, b, kvh, L)
    out = torch.empty_like(q)
    ws = torch.empty(b * h * nsplit * (hd + 2), dtype=torch.float32,
                     device=q.device)
    lib = cuda_build.library("flash_decode", _SIGNATURES)
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), ws.data_ptr(), n_ptr, n_host, b, L, h, kvh, hd,
            nsplit, int(dtype == torch.bfloat16), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        code = lib.flash_decode_fwd(*args)
    cuda_build.check_launch("flash_decode_fwd", code)
    LAUNCHES["flash_decode"] += 1
    return out
