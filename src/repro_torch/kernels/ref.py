"""Plain PyTorch versions of the kernels (the ``ref.py`` contract).

They are what :mod:`repro_torch.kernels.ops` runs for CPU tensors and what
the CUDA kernels are held against on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def rank_update(m: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels.rank_update: ``m + u @ v.T``."""
    return m + u @ v.T


def rank_update_batched(m: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels.rank_update_batched: ``m + Σ_t u[t] @
    v[t].T`` with u: (T, n, k), v: (T, p, k)."""
    return m + torch.einsum("tnk,tpk->np", u, v)


def rank_update_rows(m: torch.Tensor, rows: torch.Tensor, block: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels.rank_update_rows: ``m`` with
    ``block @ v.T`` added to the rows ``rows`` (an int64 index of distinct
    rows)."""
    out = m.clone()
    out[rows] += block @ v.T
    return out


def dual_matmul(a: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernels.dual_matmul: ``(a @ u, a.T @ v)``."""
    return a @ u, a.T @ v


def sherman_morrison_delta(w: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused Sherman–Morrison delta:
    Δ(E⁻¹) = L Rᵀ with ``L = −W u / (1 + vᵀ W u)``, ``R = Wᵀ v``
    (paper §4.1)."""
    u = u.reshape(-1, 1)
    v = v.reshape(-1, 1)
    wu = w @ u
    wtv = w.T @ v
    denom = 1.0 + (v.T @ wu)[0, 0]
    return -wu / denom, wtv


def attention_keep(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                   window: Optional[int]) -> torch.Tensor:
    """(q, k) keep-mask: ``kp <= qp`` when causal, and ``kp > qp - window``
    when a window is given (the reference's ``_mask_block`` without the
    VLM prefix)."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    keep = kp <= qp if causal else torch.ones(
        (q_pos.numel(), k_pos.numel()), dtype=torch.bool, device=q_pos.device)
    if window is not None:
        keep = keep & (kp > qp - window)
    return keep


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    q_chunk: Optional[int] = None) -> torch.Tensor:
    """Plain version of kernels.flash_attention: softmax attention with
    f32 scores, softmax and products, output in q's dtype.

    q (B, S, H, hd), k/v (B, S, KV, hd) with H a multiple of KV: query
    head h reads KV head h // (H / KV).  Queries are taken ``q_chunk`` at
    a time (by default as many as keep one chunk's scores near 2**28
    values), so no (S x S) score matrix per head is ever whole.
    """
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    if q_chunk is None:
        q_chunk = max(1, min(s, 2 ** 28 // max(1, b * h * s)))
    # (B, KV, g, S, hd) queries against (B, KV, S, hd) keys: GQA by shape
    qf = q.float().reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)
    kt = k.float().permute(0, 2, 3, 1)            # (B, KV, hd, S)
    vf = v.float().permute(0, 2, 1, 3)            # (B, KV, S, hd)
    pos = torch.arange(s, device=q.device)
    out = torch.empty((b, kvh, g, s, hd), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, s, q_chunk):
        q1 = min(s, q0 + q_chunk)
        qc = qf[:, :, :, q0:q1].reshape(b, kvh, g * (q1 - q0), hd)
        scores = (qc @ kt).view(b, kvh, g, q1 - q0, s) * hd ** -0.5
        keep = attention_keep(pos[q0:q1], pos, causal=causal, window=window)
        scores = scores.masked_fill(~keep, float("-inf"))
        p = torch.softmax(scores, dim=-1).view(b, kvh, g * (q1 - q0), s)
        out[:, :, :, q0:q1] = (p @ vf).view(b, kvh, g, q1 - q0, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor,
                 n_valid: Union[int, torch.Tensor]) -> torch.Tensor:
    """Plain version of kernels.flash_decode: one query token per sequence
    over the first ``n_valid`` cache slots, f32 scores, softmax and
    products, output in q's dtype.

    q (B, H, hd), caches (B, L, KV, hd); each group of H / KV query heads
    shares its KV head.  ``n_valid`` is an int or a one-element int tensor
    on q's device; slots at or past it are masked (``arange(L) < n_valid``,
    as the reference's decode attention masks), not sliced, so nothing is
    read back to the host.
    """
    b, h, hd = q.shape
    L, kvh = k_cache.shape[1], k_cache.shape[2]
    qf = q.float().reshape(b, kvh, h // kvh, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float()) \
        * hd ** -0.5
    keep = torch.arange(L, device=q.device) < n_valid
    p = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)
