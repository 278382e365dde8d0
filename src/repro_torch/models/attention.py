"""GQA attention: the full-sequence path (prefill, forward) on the flash
attention kernel and the cached one-token decode on the flash-decode
kernel (:mod:`repro_torch.kernels.ops`).

Masking: causal, prefix-LM (paligemma: bidirectional over the image
prefix, causal after), or full (hubert), with an optional sliding window
(h2o-danube).  A decoded token attends every valid cache slot, as in the
reference.

Under a mesh both paths are tensor-parallel over the ``model`` axis:
``wq`` (and ``wk``/``wv`` when the KV heads divide) hold this rank's
heads' columns, the flash kernels run on the rank's ``H/m`` query heads,
and ``wo`` is row-parallel, followed by one reduce.  KV heads are never
cut: with fewer of them than model ranks they stay replicated
(``dist.sharding.aligned_spec``), and a rank's query heads take their KV
heads by global index (``head // group``).  The decode cache keeps every
KV head on every rank (the reference's placement).

Under the ``"seq_sp"`` rule (``seq=True``) the block's input is the
rank's positions of the sequence: it is gathered whole where the model
region starts (``gather_from_seq``, in place of ``copy_to_model``) and
``wo``'s partial outputs are reduce-scattered back to the rank's
positions (``reduce_scatter_to_seq``, in place of the reduce).  Under
the ``"cache_seq"`` rule the decode cache holds the rank's block of
slots with every KV head; each rank attends over its valid slots with
every query head (``flash_decode_lse``) and the partials merge by their
log-sum-exp over the rule's axes (``merge_decode_partials``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..dist.sharding import (MODEL, copy_to_model, current_ctx, gather,
                             gather_from_seq, merge_decode_partials,
                             params_to_model, reduce_from_model,
                             reduce_scatter_to_seq, seq_block, split_offset)
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


def axes_attention(cfg) -> Dict:
    p = {"wq": ("fsdp", "heads"), "wk": ("fsdp", "kv_heads"),
         "wv": ("fsdp", "kv_heads"), "wo": ("heads", "fsdp")}
    if cfg.qkv_bias:
        p["bq"] = ("heads",)
        p["bk"] = ("kv_heads",)
        p["bv"] = ("kv_heads",)
    return p


def head_units(cfg) -> Dict:
    """Per leaf of :func:`axes_attention`, the entries of each dimension
    that make one head (``head_dim`` along a flattened ``H·hd``), which
    a placement must not cut."""
    hd = cfg.resolved_head_dim
    p = {"wq": (1, hd), "wk": (1, hd), "wv": (1, hd), "wo": (hd, 1)}
    if cfg.qkv_bias:
        p.update(bq=(hd,), bk=(hd,), bv=(hd,))
    return p


def _project_qkv(params: Dict[str, Tensor], cfg, x: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """x (B, S, D) → q (B, S, H, hd), k and v (B, S, KV, hd), at the head
    counts of the params' columns (a rank's local heads on a mesh)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    return (q.view(b, s, -1, hd), k.view(b, s, -1, hd),
            v.view(b, s, -1, hd))


def _rank_kv(k: Tensor, v: Tensor, q_lo: int, heads: int, group: int
             ) -> Tuple[Tensor, Tensor]:
    """The KV heads that query heads ``q_lo .. q_lo + heads - 1`` read,
    from replicated (B, S, KV, hd) k and v: a slice when they form equal
    groups of those heads (the flash kernels' GQA), else each query
    head's KV head gathered by ``head // group`` (groups of one)."""
    kv_lo = q_lo // group
    kv_hi = (q_lo + heads - 1) // group + 1
    if kv_hi - kv_lo == 1 or (q_lo % group == 0 and heads % group == 0):
        return (k[:, :, kv_lo:kv_hi].contiguous(),
                v[:, :, kv_lo:kv_hi].contiguous())
    idx = torch.div(q_lo + torch.arange(heads, device=k.device), group,
                    rounding_mode="floor")
    return k[:, :, idx], v[:, :, idx]


def attention_block(params: Dict[str, Tensor], cfg, x: Tensor,
                    positions: Tensor, *, causal: bool = True,
                    prefix_len: int = 0, return_kv: bool = False,
                    seq: bool = False):
    """Full-sequence attention (forward, prefill): x (B,S,D) → (B,S,D).

    ``return_kv=True`` also returns the rope'd (k, v) of every KV head,
    so a batched prefill fills the decode cache in the same pass.
    ``prefix_len`` keys the first positions bidirectionally under the
    causal mask.

    On a mesh with the heads split (``wq`` narrower than ``H·hd``) the
    block runs this rank's heads and sums the partial outputs of ``wo``
    over the model axis; replicated ``wk``/``wv`` (and biases) then enter
    the model region too, since each rank reads only its heads' part of
    them.  ``return_kv`` gathers split k/v over the model axis.

    ``seq``: x (B, S/m, D) is the rank's positions (the ``"seq_sp"``
    rule), gathered whole on entry, and the output is the rank's
    positions: ``wo``'s partials reduce-scattered, or, where the heads
    are not split, the rank's slice of the whole output, the params then
    entering the model region (each rank's gradient is its positions'
    part).
    """
    hd = cfg.resolved_head_dim
    heads = params["wq"].shape[1] // hd
    split = heads != cfg.n_heads
    kv_whole = params["wk"].shape[1] == cfg.n_kv_heads * hd
    if split:
        _, q_lo = split_offset(heads, cfg.n_heads)
        x = gather_from_seq(x, 1) if seq else copy_to_model(x)
        if kv_whole:
            params = dict(params, **{
                name: copy_to_model(params[name])
                for name in ("wk", "wv", "bk", "bv") if name in params})
    elif seq:
        x = gather_from_seq(x, 1)
        params = params_to_model(params)
    q, k, v = _project_qkv(params, cfg, x)
    cos, sin = layers.rope_angles(positions, hd, cfg.rope_theta)
    q = layers.apply_rope(q, cos, sin)
    k = layers.apply_rope(k, cos, sin)
    kv = (k, v)
    if split and kv_whole:
        k, v = _rank_kv(k, v, q_lo, heads, cfg.n_heads // cfg.n_kv_heads)
    elif return_kv and not kv_whole:
        kv = (gather(k, 2, MODEL), gather(v, 2, MODEL))
    out = ops.flash_attention(q, k, v, causal=causal,
                              window=cfg.sliding_window,
                              prefix_len=prefix_len)
    out = out.reshape(x.shape[0], x.shape[1], -1) @ params["wo"]
    if split:
        out = reduce_scatter_to_seq(out, 1) if seq else reduce_from_model(out)
    elif seq:
        out = seq_block(out, 1)
    if return_kv:
        return out, kv
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


def axes_kv_cache(long_context: bool = False) -> Dict:
    """The reference's sequence-sharded cache axes (one spec for
    decode_32k and long_500k)."""
    return {"k": ("batch", "cache_seq", None, None),
            "v": ("batch", "cache_seq", None, None)}


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
                     n_valid: Tensor, seq: Tuple[str, ...] = ()
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode. x (B, 1, D); cache k/v (B, L, KV, hd); ``slot``
    the host int :func:`cache_slot` gives for this position; ``pos`` (1,)
    and ``n_valid`` () int tensors on x's device, made once per step by
    :meth:`LM.decode_step` (the reference traces both as scalars).

    Writes this token's rope'd k/v into its slot IN PLACE (the reference
    returns a new cache; here the one cache is updated, which saves a
    copy per step) and attends over the valid slots.  Returns
    (out (B, 1, D), cache).

    On a mesh with the heads split the step runs this rank's query heads
    and sums ``wo``'s partial outputs over the model axis, as
    :func:`attention_block` does.  The cache keeps every KV head (the
    reference's ``cache_axes`` split only its batch): replicated
    ``wk``/``wv`` write all of them and the rank's heads read theirs
    (:func:`_rank_kv`); split ones write and read the rank's own.

    ``seq``: the mesh axes the cache's slots split over (the
    ``"cache_seq"`` rule): see :func:`_decode_slots`.
    """
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    heads = params["wq"].shape[1] // hd
    split = heads != cfg.n_heads
    q, k, v = _project_qkv(params, cfg, x)
    cos, sin = layers.rope_angles(pos, hd, cfg.rope_theta)
    q = layers.apply_rope(q, cos, sin)
    k = layers.apply_rope(k, cos, sin)
    kc, vc = cache["k"], cache["v"]
    if seq:
        out = _decode_slots(q, k, v, kc, vc, cfg, slot, n_valid, seq)
        if split:
            _, q_lo = split_offset(heads, cfg.n_heads)
            out = out[:, q_lo:q_lo + heads]
        out = out.to(x.dtype).reshape(b, 1, heads * hd) @ params["wo"]
        return (reduce_from_model(out) if split else out), cache
    if k.shape[2] == cfg.n_kv_heads:
        kc[:, slot] = k[:, 0]
        vc[:, slot] = v[:, 0]
        if split:
            _, q_lo = split_offset(heads, cfg.n_heads)
            kc, vc = _rank_kv(kc, vc, q_lo, heads,
                              cfg.n_heads // cfg.n_kv_heads)
    else:
        _, kv_lo = split_offset(k.shape[2], cfg.n_kv_heads)
        own = slice(kv_lo, kv_lo + k.shape[2])
        kc[:, slot, own] = k[:, 0]
        vc[:, slot, own] = v[:, 0]
        kc, vc = kc[:, :, own].contiguous(), vc[:, :, own].contiguous()
    out = ops.flash_decode(q[:, 0].contiguous(), kc, vc, n_valid)
    out = out.reshape(b, 1, heads * hd) @ params["wo"]
    if split:
        out = reduce_from_model(out)
    return out, cache


def _decode_slots(q: Tensor, k: Tensor, v: Tensor, kc: Tensor, vc: Tensor,
                  cfg, slot: int, n_valid: Tensor, seq: Tuple[str, ...]
                  ) -> Tensor:
    """The decode step's attention of every query head over a cache whose
    slots split over the mesh axes ``seq``: this rank holds the slots
    ``[r L/n, (r+1) L/n)`` of each (B, L, KV, hd) cache, every KV head.
    The token's k/v (gathered over the model axis where ``wk``/``wv`` are
    split) go to the global ``slot`` on the rank that holds it; the
    rank's query heads are gathered to all H; each rank attends over its
    valid slots, ``clamp(n_valid - r L/n, 0, L/n)`` (read on the card,
    0 on a rank past them), and the ranks' partials merge by their
    log-sum-exp.  Returns (B, H, hd) f32, the same on every rank."""
    ctx = current_ctx()
    if k.shape[2] != cfg.n_kv_heads:
        k, v = gather(k, 2, MODEL), gather(v, 2, MODEL)
    if q.shape[2] != cfg.n_heads:
        q = gather(q, 2, MODEL)
    span = kc.shape[1]
    lo = ctx.coord(seq) * span
    if lo <= slot < lo + span:
        kc[:, slot - lo] = k[:, 0]
        vc[:, slot - lo] = v[:, 0]
    local = (n_valid - lo).clamp(0, span)
    out, lse = ops.flash_decode_lse(q[:, 0].contiguous(), kc, vc, local)
    return merge_decode_partials(out, lse, seq)
