"""Mamba2 (SSD) block: the chunked scan for full sequences, the recurrent
step for decode.

The counterpart of the JAX package's ``models/ssm.py``, with its cast
points: projections and the causal conv in the model's type, SiLU in f32
and cast back, the SSD scan in f32, returned in the input's type.  The
inter-chunk recurrence ``S_c = a_c·S_{c-1} + X_c`` (LINVIEW's general
iterative form T_{i+1} = A·T_i + B with a scalar A per head) runs as a
Python loop over the chunks; the intra-chunk work is batched einsums over
(chunk × chunk) tiles.  No Pallas kernel backs this module, so no CUDA
kernel does either.

Single B/C group (the zamba2 config): the heads share B and C.
``F.softplus`` returns its input above its threshold of 20, where the
exact log1p(exp(x)) of ``jax.nn.softplus`` differs by < e^-20.

Under a mesh the block is tensor-parallel over whole Mamba2 heads
(:func:`placement_mamba2`): a rank's ``in_proj`` block packs its heads'
z and x columns, the B and C columns (replicated: every rank computes
them) and its heads' dt columns; ``conv_w`` packs x|B|C the same way;
the norm is the split-width RMSNorm and ``out_proj`` is row-split, with
one reduce after.  ``dt_bias``, ``a_log`` and ``d_skip`` stay replicated
and each rank reads its heads' entries.  The parts read in part (the B
and C columns, the head-sliced leaves) enter the model region, so their
gradient is summed over the ranks.  When the heads do not divide the
model axis, the block is replicated and recomputed on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.sharding import (Packed, copy_to_model, reduce_from_model,
                             split_offset)
from . import layers

Tensor = torch.Tensor


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.headdim
    return d_inner, n_heads, s.headdim, s.state


def init_mamba2(cfg, dtype, generator, device) -> Dict[str, Tensor]:
    """Random params at the reference's scales: N(0, 1/fan_in)
    projections, N(0, 0.01) conv taps, zero biases, A = -exp(0) = -1, unit
    skip; ``dt_bias``, ``a_log`` and ``d_skip`` in f32."""
    d = cfg.d_model
    d_inner, h, _, n = _dims(cfg)
    k = cfg.ssm.conv_kernel
    proj_out = 2 * d_inner + 2 * n + h      # z, x, B, C, dt
    f32 = torch.float32

    def w(shape, std):
        return layers.normal(shape, std, dtype, generator, device)

    return {
        "in_proj": w((d, proj_out), d ** -0.5),
        "conv_w": w((k, d_inner + 2 * n), 0.1),
        "conv_b": torch.zeros(d_inner + 2 * n, dtype=dtype, device=device),
        "dt_bias": torch.zeros(h, dtype=f32, device=device),
        "a_log": torch.zeros(h, dtype=f32, device=device),
        "d_skip": torch.ones(h, dtype=f32, device=device),
        "norm": layers.init_rmsnorm(d_inner, dtype, device),
        "out_proj": w((d_inner, d), d_inner ** -0.5),
    }


def _local_dims(params: Dict[str, Tensor], cfg) -> Tuple[int, int, int]:
    """(d_inner, heads, first head) of the block ``params`` holds: the
    whole block, or a rank's heads under a mesh (``out_proj``'s rows)."""
    _, h, p, _ = _dims(cfg)
    heads = params["out_proj"].shape[0] // p
    return heads * p, heads, split_offset(heads, h)[1]


def _region(params: Dict[str, Tensor], cfg, x: Tensor
            ) -> Tuple[Dict[str, Tensor], Tensor, bool]:
    """(params, x, split) for the block's body: with the heads split, x
    and the parts each rank reads in part enter the model region — the B
    and C columns of ``in_proj``, ``conv_w`` and ``conv_b`` and the
    head-sliced ``dt_bias``, ``a_log``, ``d_skip``."""
    d_inner, _, _, n = _dims(cfg)
    dl, heads, lo = _local_dims(params, cfg)
    if dl == d_inner:
        return params, x, False
    entered = {name: copy_to_model(params[name])[lo:lo + heads]
               for name in ("dt_bias", "a_log", "d_skip")}
    # B and C follow z and x in in_proj's block, x in conv_w's and conv_b's
    entered["in_proj"] = copy_to_model(params["in_proj"],
                                       cols=(2 * dl, 2 * dl + 2 * n))
    for name in ("conv_w", "conv_b"):
        entered[name] = copy_to_model(params[name], cols=(dl, dl + 2 * n))
    return dict(params, **entered), copy_to_model(x), True


def _split_proj(cfg, proj: Tensor, d_inner: int
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """in_proj's output → (z, x|B|C for the conv, dt), at ``d_inner``
    (a rank's width under a mesh)."""
    n = _dims(cfg)[3]
    return (proj[..., :d_inner], proj[..., d_inner:2 * d_inner + 2 * n],
            proj[..., 2 * d_inner + 2 * n:])


def _project(params: Dict[str, Tensor], cfg, x: Tensor, d_inner: int
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """x (B, S, D) through in_proj → (z, x|B|C, dt), each (B, S, ·)."""
    return _split_proj(cfg, x @ params["in_proj"], d_inner)


def _output(params: Dict[str, Tensor], cfg, y: Tensor, z: Tensor,
            split: bool) -> Tensor:
    """The scan's y (B, S, d_inner) gated by SiLU(z) in f32, RMSNorm,
    out_proj → (B, S, D); ``split``: y is a rank's heads, normalised over
    the whole width, and out_proj's partial outputs are summed."""
    y = y * F.silu(z.float()).to(y.dtype)
    y = layers.rmsnorm(params["norm"], y, cfg.norm_eps,
                       width=_dims(cfg)[0])
    y = y @ params["out_proj"]
    return reduce_from_model(y) if split else y


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (K, C), then SiLU
    in f32, cast back to the input's type."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return F.silu((out + b[None, None, :]).float()).to(xbc.dtype)


def chunked_ssd(x: Tensor, dt: Tensor, a_log: Tensor, bmat: Tensor,
                cmat: Tensor, chunk: int, init_state: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """SSD scan.  x (B, S, H, P); dt (B, S, H); bmat / cmat (B, S, N).

    Returns (y (B, S, H, P) in x's type, final state (B, H, N, P) f32).
    A length that is not a multiple of ``chunk`` runs one short chunk when
    it is shorter, else pads with zeros (dt = 0 there: no effect).
    """
    bsz, s_orig, h, p = x.shape
    n = bmat.shape[-1]
    f32 = torch.float32
    chunk = min(chunk, s_orig) if s_orig % chunk else chunk
    pad = (-s_orig) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // chunk

    la = (-torch.exp(a_log)[None, None, :] * dt).to(f32)     # log a (B,S,H)
    xc = x.reshape(bsz, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, chunk, h).to(f32)
    bc = bmat.reshape(bsz, nc, chunk, n).to(f32)
    cc = cmat.reshape(bsz, nc, chunk, n).to(f32)
    cum = la.reshape(bsz, nc, chunk, h).cumsum(dim=2)        # (B,nc,L,H)
    la_end = cum[:, :, -1, :]                                # (B,nc,H)

    # intra-chunk: scores[b,c,t,u,h] = (C_t·B_u)·exp(LA_t − LA_u)·dt_u,
    # u ≤ t.  Above the diagonal LA_t − LA_u > 0 and exp may reach inf:
    # select -inf there before the exp, never multiply inf by a 0/1 mask
    # (inf·0 is NaN) nor select it away after the exp (its gradient,
    # 0·inf, is NaN: the reference's jnp.where(tri, exp(decay), 0) gives
    # NaN gradients wherever the decay overflows).
    g = torch.einsum("bctn,bcun->bctu", cc, bc)              # (B,nc,L,L)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,t,u,H)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    w = torch.where(tri[None, None, :, :, None], decay, float("-inf")).exp()
    del decay
    scores = g[..., None] * w * dtc[:, :, None, :, :]
    del w
    y = torch.einsum("bctuh,bcuhp->bcthp", scores, xc)
    del scores

    # each chunk's contribution to the state: Sc[b,c,h,n,p]
    wend = torch.exp(la_end[:, :, None, :] - cum) * dtc      # (B,nc,L,H)
    s_chunk = torch.einsum("bcuh,bcun,bcuhp->bchnp", wend, bc, xc)

    # inter-chunk scan S ← exp(la_end)·S + Sc; chunk c reads the state
    # before its own update
    state = (torch.zeros(bsz, h, n, p, dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    s_prev = []
    for c in range(nc):
        s_prev.append(state)
        state = torch.exp(la_end[:, c])[:, :, None, None] * state \
            + s_chunk[:, c]
    s_prev = torch.stack(s_prev, dim=1)                      # (B,nc,H,N,P)

    # inter-chunk outputs: y_inter[t] = exp(LA_t)·(C_t · S_prev)
    y_inter = torch.einsum("bctn,bchnp->bcthp", cc, s_prev) \
        * torch.exp(cum)[..., None]
    y = (y + y_inter).reshape(bsz, s, h, p)[:, :s_orig]
    return y.to(x.dtype), state


def mamba2_block(params: Dict[str, Tensor], cfg, x: Tensor) -> Tensor:
    """Full-sequence Mamba2 mixer: x (B, S, D) → (B, S, D)."""
    b, s, _ = x.shape
    _, _, p, n = _dims(cfg)
    d_inner, h, _ = _local_dims(params, cfg)
    params, x, split = _region(params, cfg, x)
    z, xbc, dt_raw = _project(params, cfg, x, d_inner)
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs = xbc[..., :d_inner].reshape(b, s, h, p)
    bmat = xbc[..., d_inner:d_inner + n]
    cmat = xbc[..., d_inner + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    y, _ = chunked_ssd(xs, dt, params["a_log"], bmat, cmat, cfg.ssm.chunk)
    y = y + (params["d_skip"][None, None, :, None] * xs.float()).to(y.dtype)
    return _output(params, cfg, y.reshape(b, s, d_inner), z, split)


# -- decode (recurrent, O(1) per token) -------------------------------------------


def axes_mamba2(cfg) -> Dict:
    """The reference's logical axes of :func:`init_mamba2`'s leaves."""
    return {"in_proj": ("fsdp", "ff"), "conv_w": (None, "ff"),
            "conv_b": ("ff",), "dt_bias": (None,), "a_log": (None,),
            "d_skip": (None,), "norm": layers.axes_rmsnorm(),
            "out_proj": ("ff", "fsdp")}


def placement_mamba2(cfg) -> Tuple[Dict, Dict]:
    """The port's placement of :func:`init_mamba2`'s leaves: (logical
    axes, units: the entries of a dimension that make one head).  z, x
    and dt split by whole heads and B and C stay whole, one part each of
    the packed ``in_proj`` and ``conv_w`` (:class:`Packed`); the norm
    splits with the heads.  The reference's ``"ff"`` cuts ``in_proj``
    contiguously and replicates the norm."""
    d_inner, h, p, n = _dims(cfg)
    proj = Packed((d_inner, "ff"), (d_inner, "ff"), (2 * n, None), (h, "ff"))
    xbc = Packed((d_inner, "ff"), (2 * n, None))
    axes = {"in_proj": ("fsdp", proj), "conv_w": (None, xbc),
            "conv_b": (xbc,), "dt_bias": (None,), "a_log": (None,),
            "d_skip": (None,), "norm": {"scale": ("ff",)},
            "out_proj": ("ff", "fsdp")}
    units = {"in_proj": (1, (p, p, 1, 1)), "conv_w": (1, (p, 1)),
             "conv_b": ((p, 1),), "dt_bias": (1,), "a_log": (1,),
             "d_skip": (1,), "norm": {"scale": (p,)}, "out_proj": (p, 1)}
    return axes, units


def axes_mamba2_state() -> Dict:
    return {"conv": ("batch", None, "ff"),
            "ssm": ("batch", None, None, None)}


def placement_mamba2_state(cfg) -> Tuple[Dict, Dict]:
    """The port's placement of the decode state: the conv window packs
    x|B|C as ``conv_w`` does, and the SSM state holds the rank's heads
    (the reference replicates it)."""
    d_inner, _, p, n = _dims(cfg)
    axes = {"conv": ("batch", None, Packed((d_inner, "ff"), (2 * n, None))),
            "ssm": ("batch", "ff", None, None)}
    units = {"conv": (1, 1, (p, 1)), "ssm": (1, 1, 1, 1)}
    return axes, units


def init_mamba2_state(cfg, batch: int, dtype, device) -> Dict[str, Tensor]:
    """Zeroed {"conv": (B, K-1, C) in the model's type, "ssm": (B, H, N,
    P) f32}."""
    d_inner, h, p, n = _dims(cfg)
    k = cfg.ssm.conv_kernel
    return {"conv": torch.zeros(batch, k - 1, d_inner + 2 * n, dtype=dtype,
                                device=device),
            "ssm": torch.zeros(batch, h, n, p, dtype=torch.float32,
                               device=device)}


def mamba2_decode_step(params: Dict[str, Tensor], cfg, x: Tensor,
                       state: Dict[str, Tensor]
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One token: x (B, 1, D) → (B, 1, D) in O(d_inner·N).  Updates
    ``state``'s conv window and SSM state IN PLACE (the reference returns
    new ones), so a stacked cache keeps its storage from step to step.
    Returns (out, state).  Under a mesh the state holds the rank's heads
    (:func:`placement_mamba2_state`)."""
    d_inner = _local_dims(params, cfg)[0]
    params, x, split = _region(params, cfg, x)
    z, xbc, dt_raw = _project(params, cfg, x, d_inner)
    y = _state_step(params, cfg, xbc, dt_raw, state)
    return _output(params, cfg, y.to(x.dtype), z, split), state


def _state_step(params: Dict[str, Tensor], cfg, xbc: Tensor,
                dt_raw: Tensor, state: Dict[str, Tensor]) -> Tensor:
    """The conv ring and the SSM state's update for one token, in place:
    xbc (B, 1, C) and dt_raw (B, 1, H) → y (B, 1, d_inner) f32, the skip
    term included."""
    b = xbc.shape[0]
    _, _, p, n = _dims(cfg)
    d_inner, h, _ = _local_dims(params, cfg)
    # conv ring: window = [conv_state, xbc_t]
    win = torch.cat([state["conv"], xbc], dim=1)             # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", win, params["conv_w"]) \
        + params["conv_b"]
    conv_out = F.silu(conv_out.float()).to(xbc.dtype)
    state["conv"].copy_(win[:, 1:])

    xs = conv_out[:, :d_inner].reshape(b, h, p).float()
    bvec = conv_out[:, d_inner:d_inner + n].float()
    cvec = conv_out[:, d_inner + n:].float()
    dt = F.softplus(dt_raw[:, 0, :].float() + params["dt_bias"][None, :])
    a = torch.exp(-torch.exp(params["a_log"])[None, :] * dt)  # (B,H)

    s_new = a[:, :, None, None] * state["ssm"] + torch.einsum(
        "bh,bn,bhp->bhnp", dt, bvec, xs)
    state["ssm"].copy_(s_new)
    y = torch.einsum("bn,bhnp->bhp", cvec, s_new)
    y = y + params["d_skip"][None, :, None] * xs
    return y.reshape(b, 1, d_inner)
