"""GQA attention: the full-sequence path (prefill, forward) on the flash
attention kernel and the cached one-token decode on the flash-decode
kernel (:mod:`repro_torch.kernels.ops`).

Masking: causal, or full, with an optional sliding window (h2o-danube).
The reference's prefix-LM mask (paligemma) waits for the vlm family.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels import ops
from . import layers

Tensor = torch.Tensor


def init_attention(cfg, dtype, generator, device) -> Dict[str, Tensor]:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads

    def w(shape, std):
        return layers.normal(shape, std, dtype, generator, device)

    p = {"wq": w((d, h * hd), d ** -0.5), "wk": w((d, kv * hd), d ** -0.5),
         "wv": w((d, kv * hd), d ** -0.5),
         "wo": w((h * hd, d), (h * hd) ** -0.5)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros(width, dtype=dtype, device=device)
    return p


def _project_qkv(params: Dict[str, Tensor], cfg, x: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """x (B, S, D) → q (B, S, H, hd), k and v (B, S, KV, hd)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    return (q.view(b, s, cfg.n_heads, hd), k.view(b, s, cfg.n_kv_heads, hd),
            v.view(b, s, cfg.n_kv_heads, hd))


def attention_block(params: Dict[str, Tensor], cfg, x: Tensor,
                    positions: Tensor, *, causal: bool = True,
                    prefix_len: int = 0, return_kv: bool = False):
    """Full-sequence attention (forward, prefill): x (B,S,D) → (B,S,D).

    ``return_kv=True`` also returns the rope'd (k, v), so a batched
    prefill fills the decode cache in the same pass.
    """
    if prefix_len > 0:
        raise NotImplementedError(
            "prefix-LM attention (the vlm family) is not ported yet: "
            "ROADMAP.md Queue 1 item 13")
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x)
    cos, sin = layers.rope_angles(positions, hd, cfg.rope_theta)
    q = layers.apply_rope(q, cos, sin)
    k = layers.apply_rope(k, cos, sin)
    out = ops.flash_attention(q, k, v, causal=causal,
                              window=cfg.sliding_window)
    out = out.reshape(x.shape[0], x.shape[1], -1) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out


# -- decode path (one token, KV cache) --------------------------------------------


def init_kv_cache(cfg, batch: int, max_seq: int, dtype, device
                  ) -> Dict[str, Tensor]:
    """Zeroed (B, L, KV, hd) caches; a sliding-window arch keeps a ring of
    ``min(max_seq, window)`` slots."""
    window = cfg.sliding_window
    cache_len = min(max_seq, window) if window else max_seq
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_slot(cfg, cache_len: int, pos: int) -> Tuple[int, int]:
    """(slot written at position ``pos``, valid slots after the write):
    a ring for sliding-window archs (``slot = pos % L``), the position
    itself otherwise."""
    if cfg.sliding_window is not None:
        return pos % cache_len, min(pos + 1, cache_len)
    if pos >= cache_len:
        raise ValueError(f"position {pos} past the cache's {cache_len} "
                         "slots; raise max_seq")
    return pos, pos + 1


def decode_attention(params: Dict[str, Tensor], cfg, x: Tensor,
                     cache: Dict[str, Tensor], slot: int, pos: Tensor,
                     n_valid: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode. x (B, 1, D); cache k/v (B, L, KV, hd); ``slot``
    the host int :func:`cache_slot` gives for this position; ``pos`` (1,)
    and ``n_valid`` () int tensors on x's device, made once per step by
    :meth:`LM.decode_step` (the reference traces both as scalars).

    Writes this token's rope'd k/v into its slot IN PLACE (the reference
    returns a new cache; here the one cache is updated, which saves a
    copy per step) and attends over the valid slots.  Returns
    (out (B, 1, D), cache).
    """
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x)
    cos, sin = layers.rope_angles(pos, hd, cfg.rope_theta)
    q = layers.apply_rope(q, cos, sin)
    k = layers.apply_rope(k, cos, sin)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    out = ops.flash_decode(q[:, 0].contiguous(), cache["k"], cache["v"],
                           n_valid)
    out = out.reshape(b, 1, cfg.n_heads * hd) @ params["wo"]
    return out, cache
