"""CUDA flash decoding: one query token per sequence over a KV cache.

Binding for ``csrc/flash_decode.cu``, built and loaded by
:mod:`.cuda_build` the first time the kernel is launched.  It replaces
``flash_decode_pallas`` (``src/repro/kernels/flash_decode.py:69``) and its
wrapper's ``acc / l`` (``src/repro/kernels/ops.py:214``), and computes the
reference model's decode attention: each group of H / KV query heads over
its KV head's first ``n_valid`` cache slots.

The cache is split across thread blocks (:func:`split_plan`) and the
partial ``(acc, m, l)`` of the splits are merged in a second launch, in a
fixed order.  One call is two launches and counts once in ``LAUNCHES``.
The entry launches on the current CUDA stream, allocates its output and
workspace with ``torch.empty`` and never falls back to the plain version.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import cuda_build
from .flash_attention import check_attention_operands, check_heads

LAUNCHES: Dict[str, int] = {"flash_decode": 0}

TILE = 64          # cache slots a block stages at a time
MAX_GROUP = 16     # query heads per KV head
BLOCKS_PER_SM = 4  # the split plan's target grid

_SIGNATURES = {"flash_decode_fwd": [cuda_build.PTR] * 6
               + [cuda_build.I32] * 9 + [cuda_build.F32, cuda_build.PTR]}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def split_plan(b: int, kvh: int, n_valid: int, sms: int) -> Tuple[int, int]:
    """(chunk, nsplit): splits of ``chunk`` slots (a multiple of
    :data:`TILE`), enough of them for ``b * kvh * nsplit`` blocks to cover
    ``sms`` SMs about :data:`BLOCKS_PER_SM` times, and every one holding at
    least one of the ``n_valid`` valid slots."""
    tiles = -(-n_valid // TILE)
    want = max(1, -(-BLOCKS_PER_SM * sms // (b * kvh)))
    chunk = -(-tiles // min(tiles, want)) * TILE
    return chunk, -(-n_valid // chunk)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Attention of q (B, H, hd) over slots ``0 .. n_valid-1`` of the
    caches (B, L, KV, hd).  Returns (B, H, hd) in q's type."""
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
    n_valid = int(n_valid)
    if not 1 <= n_valid <= L:
        raise ValueError(f"n_valid {n_valid} outside [1, {L}]")
    if b > 65535 or kvh > 65535:
        raise ValueError(f"batch {b} or KV heads {kvh} past the grid")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, nsplit = split_plan(b, kvh, n_valid, sms)
    out = torch.empty_like(q)
    acc = torch.empty(b * h * nsplit * hd, dtype=torch.float32,
                      device=q.device)
    ml = torch.empty(b * h * nsplit * 2, dtype=torch.float32,
                     device=q.device)
    lib = cuda_build.library("flash_decode", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_decode_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), acc.data_ptr(), ml.data_ptr(), b, L, h, kvh, hd,
            n_valid, chunk, nsplit, int(dtype == torch.bfloat16), hd ** -0.5,
            stream)
    cuda_build.check_launch("flash_decode_fwd", code)
    LAUNCHES["flash_decode"] += 1
    return out
