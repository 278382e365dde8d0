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


def rank_update_batched_out(m: torch.Tensor, u: torch.Tensor,
                            v: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernels.rank_update_batched_out: ``m + Σ_t u[t] @
    v[t].T`` in a new tensor, and a bool scalar that is True when a value
    of it is not finite (the kernel's flag)."""
    out = rank_update_batched(m, u, v)
    return out, ~torch.isfinite(out).all()


def select_commit(flags: torch.Tensor, old: torch.Tensor,
                  new: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels.select_commit: ``torch.where(ok, new,
    old)`` with ``ok`` true iff every flag is zero."""
    return torch.where(~flags.bool().any(), new, old)


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
                   window: Optional[int], prefix_len: int = 0
                   ) -> torch.Tensor:
    """(q, k) keep-mask, the reference's ``_mask_block``: when causal,
    ``kp <= qp``, or both inside the prefix (``qp < prefix_len`` and
    ``kp < prefix_len``: the VLM's bidirectional image prefix); then
    ``kp > qp - window`` when a window is given."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    if causal:
        keep = kp <= qp
        if prefix_len > 0:
            keep = keep | ((qp < prefix_len) & (kp < prefix_len))
    else:
        keep = torch.ones((q_pos.numel(), k_pos.numel()), dtype=torch.bool,
                          device=q_pos.device)
    if window is not None:
        keep = keep & (kp > qp - window)
    return keep


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    q_chunk: Optional[int] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """Plain version of kernels.flash_attention: softmax attention with
    f32 scores, softmax and products, output in q's dtype.

    q (B, S, H, hd), k/v (B, S, KV, hd) with H a multiple of KV: query
    head h reads KV head h // (H / KV).  Queries are taken ``q_chunk`` at
    a time (by default as many as keep one chunk's scores near 2**28
    values), so no (S x S) score matrix per head is ever whole.
    """
    return _attention(q, k, v, causal, window, q_chunk, prefix_len,
                      want_lse=False)[0]


def _chunk(b: int, h: int, s: int, q_chunk: Optional[int]) -> int:
    """Query rows a chunk: as many as keep one chunk's scores near 2**28
    values, unless given."""
    return q_chunk or max(1, min(s, 2 ** 28 // max(1, b * h * s)))


def _grouped(q: torch.Tensor, kvh: int, dtype) -> torch.Tensor:
    """(B, S, H, hd) → (B, KV, g, S, hd) in ``dtype``: query head h reads
    KV head h // g."""
    b, s, h, hd = q.shape
    return q.to(dtype).reshape(b, s, kvh, h // kvh, hd).permute(0, 2, 3, 1, 4)


def _ungrouped(x: torch.Tensor, dtype) -> torch.Tensor:
    """(B, KV, g, S, hd) → (B, S, H, hd) in ``dtype``, contiguous: the
    kernels' layout (a roofline walk of a step then counts the same
    copies after it on the CPU as on the card)."""
    b, kvh, g, s, hd = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, hd).to(
        dtype).contiguous()


def _masked_scores(qc, kt, q0, q1, s, causal, window, prefix_len):
    """A chunk's scaled scores (B, KV, g, q1 - q0, S), -inf where masked,
    and the chunk's keep-mask (q1 - q0, S)."""
    b, kvh, g, rows, hd = qc.shape
    scores = (qc.reshape(b, kvh, g * rows, hd) @ kt).view(
        b, kvh, g, rows, s) * hd ** -0.5
    pos = torch.arange(s, device=qc.device)
    keep = attention_keep(pos[q0:q1], pos, causal=causal, window=window,
                          prefix_len=prefix_len)
    return scores.masked_fill(~keep, float("-inf")), keep


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        q_chunk: Optional[int] = None, prefix_len: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernels.flash_attention_fwd_lse: (out in q's type,
    lse (B, H, S)), lse the log-sum-exp of each row's kept scaled scores
    (-inf for a row with none; it carries no gradient, so autograd keeps
    no more than :func:`flash_attention` needs).  Computed in f32, or in
    float64 for float64 operands (the tests' gradcheck)."""
    return _attention(q, k, v, causal, window, q_chunk, prefix_len,
                      want_lse=True)


def _attention(q, k, v, causal, window, q_chunk, prefix_len, want_lse):
    """:func:`flash_attention_lse`; without ``want_lse`` no log-sum-exp is
    taken and lse is None, so :func:`flash_attention` runs no more than
    the softmax and its products."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    q_chunk = _chunk(b, h, s, q_chunk)
    qf = _grouped(q, kvh, acc)
    kt = k.to(acc).permute(0, 2, 3, 1)             # (B, KV, hd, S)
    vf = v.to(acc).permute(0, 2, 1, 3)             # (B, KV, S, hd)
    out = torch.empty(qf.shape, dtype=acc, device=q.device)
    lse = torch.empty(qf.shape[:4], dtype=acc, device=q.device) \
        if want_lse else None
    for q0 in range(0, s, q_chunk):
        q1 = min(s, q0 + q_chunk)
        scores, _ = _masked_scores(qf[:, :, :, q0:q1], kt, q0, q1, s,
                                   causal, window, prefix_len)
        if want_lse:
            with torch.no_grad():
                lse[:, :, :, q0:q1] = torch.logsumexp(scores, dim=-1)
        p = torch.softmax(scores, dim=-1).flatten(2, 3)
        out[:, :, :, q0:q1] = (p @ vf).view(b, kvh, -1, q1 - q0, hd)
    return (_ungrouped(out, q.dtype),
            lse.reshape(b, h, s) if want_lse else None)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None,
                        q_chunk: Optional[int] = None, prefix_len: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernels.flash_attention_bwd: (dq, dk, dv) in the
    operands' types, the explicit formula the kernel computes, in f32 (or
    float64) and query chunks: P = exp(S scale - lse) on kept pairs (0
    elsewhere), delta = rowsum(dout * out), dS = P (dout Vᵀ - delta)
    scale, dq = dS K, dk = Σ_group dSᵀ Q, dv = Σ_group Pᵀ dout."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    q_chunk = _chunk(b, h, s, q_chunk)
    qf, of, dof = (_grouped(x, kvh, acc) for x in (q, out, dout))
    kf = k.to(acc).permute(0, 2, 1, 3)             # (B, KV, S, hd)
    vf = v.to(acc).permute(0, 2, 1, 3)
    kt = kf.transpose(-1, -2)
    lse = lse.to(acc).reshape(qf.shape[:4])
    delta = (dof * of).sum(-1)                     # (B, KV, g, S)
    dq = torch.empty(qf.shape, dtype=acc, device=q.device)
    dk = torch.zeros(kf.shape, dtype=acc, device=q.device)
    dv = torch.zeros(vf.shape, dtype=acc, device=q.device)
    for q0 in range(0, s, q_chunk):
        q1 = min(s, q0 + q_chunk)
        qc, doc = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
        scores, keep = _masked_scores(qc, kt, q0, q1, s, causal, window,
                                      prefix_len)
        p = torch.where(keep, torch.exp(scores - lse[:, :, :, q0:q1, None]),
                        0.0)
        dp = doc @ vf[:, :, None].transpose(-1, -2)
        ds = p * (dp - delta[:, :, :, q0:q1, None]) * hd ** -0.5
        dq[:, :, :, q0:q1] = ds @ kf[:, :, None]
        dk += torch.einsum("bkgqs,bkgqd->bksd", ds, qc)
        dv += torch.einsum("bkgqs,bkgqd->bksd", p, doc)
    return (_ungrouped(dq, q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


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


def flash_decode_lse(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     n_valid: Union[int, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernels.flash_decode_lse: :func:`flash_decode`'s
    attention with its row statistics, (out (B, H, hd) f32, lse (B, H)
    f32): f32 scores over the slots ``arange(L) < n_valid`` (masked, not
    sliced), out the softmax-weighted values unrounded and lse the
    natural-log log-sum-exp of each row's scaled scores.  A row with no
    valid slot (``n_valid`` 0, as on a rank that holds none of them)
    gives out 0 and lse -inf."""
    b, h, hd = q.shape
    L, kvh = k_cache.shape[1], k_cache.shape[2]
    qf = q.float().reshape(b, kvh, h // kvh, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float()) \
        * hd ** -0.5
    keep = torch.arange(L, device=q.device) < n_valid
    scores = scores.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)                 # -inf: none kept
    p = torch.exp(scores - torch.where(torch.isfinite(lse), lse,
                                       0.0)[..., None])
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, h, hd), lse.reshape(b, h)
