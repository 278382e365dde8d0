"""Core layers: norms, embeddings, RoPE, MLPs, the frontend projector.

Pure functions over explicit param dicts, the counterparts of the JAX
package's ``models/layers.py`` with the same f32 cast points: the RMSNorm
and rope arithmetic runs in f32, activations in f32, and ``unembed`` gives
f32 logits.  Every ``init_*`` has the reference's ``axes_*``: the same
tree with logical-axis tuples (:mod:`repro_torch.dist.sharding`).

Under a mesh (``use_sharding``) the params are each rank's local blocks
and the layers read from their shapes what is split over the ``model``
axis: the embedding is vocab-parallel, the head leaves its logits
vocab-sharded, the MLP is column-parallel into ``ff`` and row-parallel
out of it, with one reduce after (a reduce-scatter over the sequence
under the ``"seq_sp"`` rule), and an RMSNorm over a split width sums its
squares over the ranks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.sharding import (copy_to_model, gather_from_seq,
                             params_to_model, reduce_from_model,
                             reduce_scatter_to_seq, split_offset,
                             sum_over_model)

Tensor = torch.Tensor

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def normal(shape, std: float, dtype, generator: torch.Generator,
           device) -> Tensor:
    """N(0, std²) drawn in f32 from ``generator``, cast to ``dtype``."""
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


# -- RMSNorm --------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, device) -> Dict[str, Tensor]:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def axes_rmsnorm() -> Dict:
    return {"scale": (None,)}


def rmsnorm(params: Dict[str, Tensor], x: Tensor, eps: float = 1e-6,
            width: Optional[int] = None) -> Tensor:
    """RMSNorm over the last dimension in f32.  An ``x`` narrower than
    ``width`` is this rank's slice of a width split over the model axis
    (with the scale's slice): the sum of squares is summed over the model
    ranks (:func:`~repro_torch.dist.sharding.sum_over_model`), then the
    slice is normalised."""
    xf = x.float()
    if width is None or x.shape[-1] == width:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    else:
        split_offset(x.shape[-1], width)                # checks the slice
        var = sum_over_model((xf * xf).sum(dim=-1, keepdim=True)) / width
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


# -- embedding / LM head --------------------------------------------------------


def init_embedding(vocab: int, d: int, dtype, generator, device
                   ) -> Dict[str, Tensor]:
    return {"table": normal((vocab, d), d ** -0.5, dtype, generator, device)}


def axes_embedding() -> Dict:
    return {"table": ("vocab", "fsdp")}


def embed(params: Dict[str, Tensor], tokens: Tensor,
          vocab: Optional[int] = None) -> Tensor:
    """The tokens' rows of the table.  A table of fewer than ``vocab``
    rows is this rank's vocab shard: ids outside it look up zeros, and
    the model ranks' rows are summed (exact: one of them is nonzero)."""
    table = params["table"]
    rows = table.shape[0]
    if vocab is None or rows == vocab:
        return F.embedding(tokens, table)
    _, lo = split_offset(rows, vocab)
    local = tokens - lo
    inside = (local >= 0) & (local < rows)
    out = F.embedding(local.clamp(0, rows - 1), table)
    return reduce_from_model(out * inside[..., None].to(out.dtype))


def unembed(params: Dict[str, Tensor], x: Tensor,
            vocab: Optional[int] = None) -> Tensor:
    """Logits (B, S, D) @ (V, D)ᵀ → (B, S, V) in f32: the products of the
    model's type are exact in f32, so this is the reference's
    ``preferred_element_type=f32``.  A vocab shard of the table gives
    this rank's vocab shard of the logits (the input enters the model
    region: its gradient is summed over the shards)."""
    table = params["table"]
    if vocab is not None and table.shape[0] != vocab:
        split_offset(table.shape[0], vocab)             # checks the block
        x = copy_to_model(x)
    return x.float() @ table.float().T


# -- rotary position embedding ------------------------------------------------------


def rope_angles(positions: Tensor, head_dim: int, theta: float
                ) -> Tuple[Tensor, Tensor]:
    """positions (...,) → (cos, sin) of shape (..., head_dim // 2), f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x (B, S, H, hd); cos/sin (B, S, hd//2) or (S, hd//2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# -- MLP (SwiGLU / plain GeLU) ---------------------------------------------------------


def init_mlp(d: int, d_ff: int, gated: bool, dtype, generator, device
             ) -> Dict[str, Tensor]:
    p = {"w_in": normal((d, d_ff), d ** -0.5, dtype, generator, device),
         "w_out": normal((d_ff, d), d_ff ** -0.5, dtype, generator, device)}
    if gated:
        p["w_gate"] = normal((d, d_ff), d ** -0.5, dtype, generator, device)
    return p


def axes_mlp(gated: bool) -> Dict:
    p = {"w_in": ("fsdp", "ff"), "w_out": ("ff", "fsdp")}
    if gated:
        p["w_gate"] = ("fsdp", "ff")
    return p


def mlp(params: Dict[str, Tensor], x: Tensor, gated: bool,
        d_ff: Optional[int] = None, seq: bool = False) -> Tensor:
    """SwiGLU (``gated``) or GeLU MLP.  With ``w_in`` narrower than
    ``d_ff`` (this rank's ``ff`` columns) it runs tensor-parallel: the
    input enters the model region, and the partial outputs of the
    row-parallel ``w_out`` are summed.

    ``seq``: x (B, S/m, D) is the rank's positions (the ``"seq_sp"``
    rule).  Split, the sequence is gathered whole on entry and the
    partial outputs reduce-scattered back to the rank's positions; whole,
    the MLP runs on the rank's positions, its params entering the model
    region (each rank's gradient is its positions' part)."""
    split = d_ff is not None and params["w_in"].shape[1] != d_ff
    if split:
        split_offset(params["w_in"].shape[1], d_ff)     # checks the block
        x = gather_from_seq(x, 1) if seq else copy_to_model(x)
    elif seq:
        params = params_to_model(params)
    h = x @ params["w_in"]
    if gated:
        g = x @ params["w_gate"]
        h = F.silu(g.float()).to(h.dtype) * h
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    out = h @ params["w_out"]
    if not split:
        return out
    return reduce_scatter_to_seq(out, 1) if seq else reduce_from_model(out)


# -- linear frontend projector (VLM patch / audio frame stubs) ------------------


def init_frontend_proj(in_dim: int, d: int, dtype, generator, device
                       ) -> Dict[str, Tensor]:
    return {"w": normal((in_dim, d), in_dim ** -0.5, dtype, generator,
                        device),
            "b": torch.zeros(d, dtype=dtype, device=device)}


def axes_frontend_proj() -> Dict:
    return {"w": (None, "fsdp"), "b": (None,)}


def frontend_proj(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    """x (B, S, in_dim) in the params' type → (B, S, D): ``x @ w + b``."""
    return x @ params["w"] + params["b"].to(x.dtype)
