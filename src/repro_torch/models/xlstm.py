"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The counterpart of the JAX package's ``models/xlstm.py``.  The mLSTM
memory update ``C_t = f_t·C_{t-1} + i_t·v_t k_tᵀ`` is a rank-1 factored
update of a matrix view (LINVIEW §4.2); the decode step applies it
literally, in place.  Full sequences run the chunkwise form with exact
log-space stabilisation: the carry (S̃, ñ, m̄) holds the true state
S = S̃·exp(m̄), and every weight inside a chunk is exponentiated relative
to a per-query running max.  The sLSTM mixes h_{t-1} into its gates, so
it runs as a Python loop over time.  Plain torch: no Pallas kernel backs
this module.  The log forget gates are -softplus(-x), as the reference
writes them; ``F.softplus`` returns its input above its threshold of 20,
where the exact log1p(exp(x)) of ``jax.nn.softplus`` differs by < e^-20.

Under a mesh the mLSTM is tensor-parallel over whole heads
(:func:`placement_mlstm`): ``up_l``, ``up_r``, the conv, the headwise
q/k/v, the norm (the split-width RMSNorm) and ``down`` (row-split, one
reduce after) hold the rank's heads.  The gates read every head's
channels, so each rank multiplies its channels by its rows of
``w_igate`` / ``w_fgate`` for all heads, the (B, S, H) partials are
summed over the ranks (``sum_over_model``, whose backward sums too: each
rank reads only its heads), and each rank takes its heads.  The sLSTM
cell mixes heads in its gates (``_slstm_cell``), so it and its gate
weights stay replicated and every rank runs the recurrence; its up/down
projection runs as a tensor-parallel MLP on ``"ff"`` when ``d_up``
divides the model axis.  Heads that do not divide the model axis leave
the whole block replicated, recomputed on every rank.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..dist.sharding import (copy_to_model, reduce_from_model, split_offset,
                             sum_over_model)
from . import layers

Tensor = torch.Tensor

NEG = -1e30


def _mlstm_dims(cfg):
    d_inner = int(cfg.xlstm.proj_factor * cfg.d_model)
    h = cfg.n_heads
    return d_inner, h, d_inner // h


# -- mLSTM ----------------------------------------------------------------------------


def init_mlstm(cfg, dtype, generator, device) -> Dict[str, Tensor]:
    """Random params at the reference's scales; the gate weights and
    biases in f32 (input gate bias -3, forget gate bias +3)."""
    d = cfg.d_model
    d_inner, h, hd = _mlstm_dims(cfg)
    k = cfg.xlstm.conv_kernel
    f32 = torch.float32

    def w(shape, std):
        return layers.normal(shape, std, dtype, generator, device)

    return {
        "up_l": w((d, d_inner), d ** -0.5),
        "up_r": w((d, d_inner), d ** -0.5),
        "conv_w": w((k, d_inner), 0.1),
        "conv_b": torch.zeros(d_inner, dtype=dtype, device=device),
        # headwise (block-diagonal) q/k/v projections
        "wq": w((h, hd, hd), hd ** -0.5),
        "wk": w((h, hd, hd), hd ** -0.5),
        "wv": w((h, hd, hd), hd ** -0.5),
        "w_igate": torch.zeros(d_inner, h, dtype=f32, device=device),
        "b_igate": torch.full((h,), -3.0, dtype=f32, device=device),
        "w_fgate": torch.zeros(d_inner, h, dtype=f32, device=device),
        "b_fgate": torch.full((h,), 3.0, dtype=f32, device=device),
        "norm": layers.init_rmsnorm(d_inner, dtype, device),
        "down": w((d_inner, d), d_inner ** -0.5),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (K, C), then SiLU
    in f32, cast back."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return F.silu((out + b[None, None, :]).float()).to(x.dtype)


def mlstm_chunkwise(q: Tensor, k: Tensor, v: Tensor, log_i: Tensor,
                    log_f: Tensor, chunk: int) -> Tensor:
    """Stabilised chunkwise mLSTM.  q / k / v (B, S, H, hd) f32; log_i /
    log_f (B, S, H) f32.  Returns (B, S, H, hd).  The carry starts at
    m̄ = 0, as the reference's does."""
    b, s_orig, h, hd = q.shape
    chunk = min(chunk, s_orig) if s_orig % chunk else chunk
    pad = (-s_orig) % chunk
    if pad:   # causal: the padded tail cannot reach earlier outputs
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i, log_f = (F.pad(t, (0, 0, 0, pad)) for t in (log_i, log_f))
    s = s_orig + pad
    nc = s // chunk
    qc = q.reshape(b, nc, chunk, h, hd) * (hd ** -0.5)
    kc = k.reshape(b, nc, chunk, h, hd)
    vc = v.reshape(b, nc, chunk, h, hd)
    lic = log_i.reshape(b, nc, chunk, h)
    cumf = log_f.reshape(b, nc, chunk, h).cumsum(dim=2)      # F_t in chunk
    f_end = cumf[:, :, -1, :]
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=q.device).tril()[None, :, :, None]

    f32 = torch.float32
    s_t = torch.zeros(b, h, hd, hd, dtype=f32, device=q.device)
    n_t = torch.zeros(b, h, hd, dtype=f32, device=q.device)
    m_bar = torch.zeros(b, h, dtype=f32, device=q.device)
    hs = []
    for c in range(nc):
        qb, kb, vb = qc[:, c], kc[:, c], vc[:, c]
        li, cf, fe = lic[:, c], cumf[:, c], f_end[:, c]

        # log-weights
        lw_intra = cf[:, :, None, :] - cf[:, None, :, :] \
            + li[:, None, :, :]                              # (B,t,u,H)
        lw_intra = torch.where(tri, lw_intra, NEG)
        lw_inter = cf + m_bar[:, None, :]                    # (B,t,H)
        m_q = torch.maximum(lw_intra.amax(dim=2), lw_inter)  # (B,t,H)
        w_intra = torch.exp(lw_intra - m_q[:, :, None, :])
        w_inter = torch.exp(lw_inter - m_q)

        qkw = torch.einsum("bthd,buhd->btuh", qb, kb) * w_intra
        numer = torch.einsum("btuh,buhd->bthd", qkw, vb) \
            + w_inter[..., None] * torch.einsum("bthd,bhde->bthe", qb, s_t)
        denom = qkw.sum(dim=2) \
            + w_inter * torch.einsum("bthd,bhd->bth", qb, n_t)
        hs.append(numer / torch.maximum(denom.abs(),
                                        torch.exp(-m_q))[..., None])

        # state update, stabilised at the new running max m̄'
        lw_state = fe[:, None, :] - cf + li                  # (B,u,H)
        m_new = torch.maximum(m_bar + fe, lw_state.amax(dim=1))
        w_old = torch.exp(m_bar + fe - m_new)                # (B,H)
        w_add = torch.exp(lw_state - m_new[:, None, :])
        s_t = w_old[:, :, None, None] * s_t + torch.einsum(
            "buh,buhd,buhe->bhde", w_add, kb, vb)
        n_t = w_old[:, :, None] * n_t + torch.einsum(
            "buh,buhd->bhd", w_add, kb)
        m_bar = m_new
    return torch.stack(hs, dim=1).reshape(b, s, h, hd)[:, :s_orig]


def _local_heads(params: Dict[str, Tensor], cfg) -> Tuple[int, int]:
    """(heads, first head) of the mLSTM block ``params`` holds: all of
    them, or a rank's under a mesh (``wq``'s)."""
    heads = params["wq"].shape[0]
    return heads, split_offset(heads, cfg.n_heads)[1]


def _gates(params: Dict[str, Tensor], cfg, cf: Tensor
           ) -> Tuple[Tensor, Tensor]:
    """(log input gate, log forget gate) from the conv output in f32.
    With a rank's heads, ``cf`` holds the rank's channels and the gate
    weights its rows: the partial products of all heads are summed over
    the model ranks, then the rank's heads taken."""
    heads, lo = _local_heads(params, cfg)
    h = cfg.n_heads
    if heads == h:
        log_i = cf @ params["w_igate"] + params["b_igate"]
        log_f = -F.softplus(-(cf @ params["w_fgate"] + params["b_fgate"]))
        return log_i, log_f
    pre = sum_over_model(torch.cat([cf @ params["w_igate"],
                                    cf @ params["w_fgate"]], dim=-1))
    log_i = pre[..., lo:lo + heads] + params["b_igate"]
    log_f = -F.softplus(-(pre[..., h + lo:h + lo + heads]
                          + params["b_fgate"]))
    return log_i, log_f


def _mlstm_out(params: Dict[str, Tensor], cfg, y: Tensor, right: Tensor,
               split: bool) -> Tensor:
    """The cell's y (B, S, heads·hd) → RMSNorm over d_inner, gated by
    SiLU(right), ``down`` (its partial outputs summed when ``split``)."""
    y = layers.rmsnorm(params["norm"], y, cfg.norm_eps,
                       width=_mlstm_dims(cfg)[0])
    y = y * F.silu(right.float()).to(y.dtype)
    y = y @ params["down"]
    return reduce_from_model(y) if split else y


def mlstm_block(params: Dict[str, Tensor], cfg, x: Tensor) -> Tensor:
    """x (B, S, D) → (B, S, D)."""
    b, s, _ = x.shape
    _, h_all, hd = _mlstm_dims(cfg)
    h = _local_heads(params, cfg)[0]
    split = h != h_all
    if split:
        x = copy_to_model(x)
    left = x @ params["up_l"]
    right = x @ params["up_r"]
    c = _causal_conv(left, params["conv_w"], params["conv_b"])
    ch = c.reshape(b, s, h, hd)
    lh = left.reshape(b, s, h, hd)
    q = torch.einsum("bshd,hde->bshe", ch, params["wq"])
    k = torch.einsum("bshd,hde->bshe", ch, params["wk"])
    v = torch.einsum("bshd,hde->bshe", lh, params["wv"])
    log_i, log_f = _gates(params, cfg, c.float())
    y = mlstm_chunkwise(q.float(), k.float(), v.float(), log_i, log_f,
                        cfg.xlstm.chunk)
    y = y.reshape(b, s, h * hd).to(x.dtype)
    return _mlstm_out(params, cfg, y, right, split)


def axes_mlstm(cfg) -> Dict:
    """The reference's logical axes of :func:`init_mlstm`'s leaves."""
    return {"up_l": ("fsdp", "ff"), "up_r": ("fsdp", "ff"),
            "conv_w": (None, "ff"), "conv_b": ("ff",),
            "wq": ("heads", None, None), "wk": ("heads", None, None),
            "wv": ("heads", None, None),
            "w_igate": (None, "heads"), "b_igate": ("heads",),
            "w_fgate": (None, "heads"), "b_fgate": ("heads",),
            "norm": layers.axes_rmsnorm(), "down": ("ff", "fsdp")}


def placement_mlstm(cfg) -> Tuple[Dict, Dict]:
    """The port's placement of :func:`init_mlstm`'s leaves: (logical
    axes, units: the entries of a dimension that make one head).  Every
    head-aligned leaf splits by whole heads on ``"heads"``, the gate
    weights by their rows (the reference: ``(None, "heads")``, columns),
    the norm with the heads (the reference replicates it)."""
    _, _, hd = _mlstm_dims(cfg)
    axes = {"up_l": ("fsdp", "heads"), "up_r": ("fsdp", "heads"),
            "conv_w": (None, "heads"), "conv_b": ("heads",),
            "wq": ("heads", None, None), "wk": ("heads", None, None),
            "wv": ("heads", None, None),
            "w_igate": ("heads", None), "b_igate": ("heads",),
            "w_fgate": ("heads", None), "b_fgate": ("heads",),
            "norm": {"scale": ("heads",)}, "down": ("heads", "fsdp")}
    units = {"up_l": (1, hd), "up_r": (1, hd), "conv_w": (1, hd),
             "conv_b": (hd,), "wq": (1, 1, 1), "wk": (1, 1, 1),
             "wv": (1, 1, 1), "w_igate": (hd, 1), "b_igate": (1,),
             "w_fgate": (hd, 1), "b_fgate": (1,), "norm": {"scale": (hd,)},
             "down": (hd, 1)}
    return axes, units


def axes_mlstm_state() -> Dict:
    return {"conv": ("batch", None, "ff"), "s": ("batch", "heads", None, None),
            "n": ("batch", "heads", None), "m": ("batch", "heads")}


def placement_mlstm_state(cfg) -> Tuple[Dict, Dict]:
    """The port's placement of the mLSTM decode state: every leaf holds
    the rank's heads (the conv window by whole heads on ``"heads"``)."""
    _, _, hd = _mlstm_dims(cfg)
    axes = {"conv": ("batch", None, "heads"),
            "s": ("batch", "heads", None, None),
            "n": ("batch", "heads", None), "m": ("batch", "heads")}
    units = {"conv": (1, 1, hd), "s": (1, 1, 1, 1), "n": (1, 1, 1),
             "m": (1, 1)}
    return axes, units


def init_mlstm_state(cfg, batch: int, dtype, device) -> Dict[str, Tensor]:
    """Zeroed {"conv": (B, K-1, d_inner) in the model's type, "s": (B, H,
    hd, hd), "n": (B, H, hd), "m": (B, H), f32}."""
    d_inner, h, hd = _mlstm_dims(cfg)
    k = cfg.xlstm.conv_kernel
    f32 = torch.float32
    return {"conv": torch.zeros(batch, k - 1, d_inner, dtype=dtype,
                                device=device),
            "s": torch.zeros(batch, h, hd, hd, dtype=f32, device=device),
            "n": torch.zeros(batch, h, hd, dtype=f32, device=device),
            "m": torch.zeros(batch, h, dtype=f32, device=device)}


def mlstm_decode_step(params: Dict[str, Tensor], cfg, x: Tensor,
                      state: Dict[str, Tensor]
                      ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One token: x (B, 1, D) → (B, 1, D).  The matrix memory takes its
    rank-1 update IN PLACE (scaled by the forget weight, then one k vᵀ a
    head added), and so do the conv window, normaliser and max.  Returns
    (out, state)."""
    b = x.shape[0]
    _, h_all, hd = _mlstm_dims(cfg)
    h = _local_heads(params, cfg)[0]
    split = h != h_all
    if split:
        x = copy_to_model(x)
    left = (x @ params["up_l"])[:, 0]
    right = (x @ params["up_r"])[:, 0]
    win = torch.cat([state["conv"], left[:, None, :]], dim=1)
    c = torch.einsum("bkc,kc->bc", win, params["conv_w"]) + params["conv_b"]
    c = F.silu(c.float()).to(x.dtype)
    state["conv"].copy_(win[:, 1:])

    ch = c.reshape(b, h, hd)
    lh = left.reshape(b, h, hd)
    q = (torch.einsum("bhd,hde->bhe", ch, params["wq"])
         * hd ** -0.5).float()
    k = torch.einsum("bhd,hde->bhe", ch, params["wk"]).float()
    v = torch.einsum("bhd,hde->bhe", lh, params["wv"]).float()
    log_i, log_f = _gates(params, cfg, c.float())

    m_old = state["m"]
    m_new = torch.maximum(log_f + m_old, log_i)
    w_old = torch.exp(log_f + m_old - m_new)
    w_new = torch.exp(log_i - m_new)
    # the rank-1 factored update of the matrix view C̃ (paper §4.2)
    s = state["s"]
    s.mul_(w_old[:, :, None, None])
    s.view(b * h, hd, hd).baddbmm_(
        (w_new[:, :, None] * k).reshape(b * h, hd, 1),
        v.reshape(b * h, 1, hd))
    n = state["n"]
    n.mul_(w_old[:, :, None]).add_(w_new[:, :, None] * k)
    m_old.copy_(m_new)
    numer = (q[:, :, None, :] @ s)[:, :, 0]                 # (B,H,hd)
    denom = (q * n).sum(dim=-1).abs()
    y = numer / torch.maximum(denom, torch.exp(-m_new))[..., None]

    y = y.reshape(b, 1, h * hd).to(x.dtype)
    return _mlstm_out(params, cfg, y, right[:, None, :], split), state


# -- sLSTM ----------------------------------------------------------------------------


def _d_up(cfg) -> int:
    return int(cfg.xlstm.slstm_proj_factor * cfg.d_model)


def init_slstm(cfg, dtype, generator, device) -> Dict[str, Tensor]:
    """Random params at the reference's scales; the gate weights in f32.
    The reference draws ``up_l`` and ``up_r`` from one key, so they start
    equal: here one draw is used twice (ROADMAP.md Queue 3)."""
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    d_up = _d_up(cfg)
    f32 = torch.float32
    up = layers.normal((d, d_up), d ** -0.5, dtype, generator, device)
    return {
        "w_gates": layers.normal((d, 4 * d), d ** -0.5, f32, generator,
                                 device),                   # i,f,z,o from x
        "r_gates": layers.normal((h, hd, 4 * hd), hd ** -0.5, f32,
                                 generator, device),        # block-diagonal
        "b_gates": torch.cat([torch.full((d,), v, dtype=f32, device=device)
                              for v in (-3.0, 3.0, 0.0, 0.0)]),
        "norm": layers.init_rmsnorm(d, dtype, device),
        "up_l": up,
        "up_r": up.clone(),
        "down": layers.normal((d_up, d), d_up ** -0.5, dtype, generator,
                              device),
    }


def _slstm_cell(params: Dict[str, Tensor], cfg, xw: Tensor, carry):
    """One time step.  xw (B, 4D) the input's gate projections; carry
    (c, n, h, m), each (B, D) f32.  Returns (new carry, h)."""
    h_dim, d = cfg.n_heads, cfg.d_model
    hd = d // h_dim
    c_t, n_t, h_t, m_t = carry
    rec = torch.einsum("bhd,hde->bhe", h_t.reshape(-1, h_dim, hd),
                       params["r_gates"]).reshape(-1, 4 * d)
    pre = xw + rec + params["b_gates"][None, :]
    i_r, f_r, z_r, o_r = torch.chunk(pre, 4, dim=-1)
    log_i = i_r
    log_f = -F.softplus(-f_r)
    m_new = torch.maximum(log_f + m_t, log_i)
    i_g = torch.exp(log_i - m_new)
    f_g = torch.exp(log_f + m_t - m_new)
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    c_new = f_g * c_t + i_g * z
    n_new = f_g * n_t + i_g
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_out(params: Dict[str, Tensor], cfg, y: Tensor) -> Tensor:
    """The cell's outputs (B, S, D) in the model's type → the block's:
    RMSNorm, then the GeLU-gated up / down projection."""
    y = layers.rmsnorm(params["norm"], y, cfg.norm_eps)
    split = params["up_l"].shape[1] != _d_up(cfg)
    if split:
        split_offset(params["up_l"].shape[1], _d_up(cfg))   # checks it
        y = copy_to_model(y)
    up = y @ params["up_l"]
    gate = y @ params["up_r"]
    # jax.nn.gelu's default is the tanh approximation
    up = F.gelu(up.float(), approximate="tanh").to(up.dtype) * gate
    up = up @ params["down"]
    return reduce_from_model(up) if split else up


def slstm_block(params: Dict[str, Tensor], cfg, x: Tensor) -> Tensor:
    """The strictly sequential sLSTM over time: x (B, S, D) → (B, S, D),
    one Python step a position."""
    b, _, d = x.shape
    xw = x.float() @ params["w_gates"]
    carry = tuple(torch.zeros(b, d, dtype=torch.float32, device=x.device)
                  for _ in range(4))
    hs = []
    # unbind, not xw[:, t]: the backward stacks the steps' gradients once
    # (a select's backward writes a whole (B, S, 4D) gradient a step)
    for xw_t in xw.unbind(1):
        carry, h_t = _slstm_cell(params, cfg, xw_t, carry)
        hs.append(h_t)
    return _slstm_out(params, cfg, torch.stack(hs, dim=1).to(x.dtype))


def axes_slstm(cfg) -> Dict:
    """The reference's logical axes of :func:`init_slstm`'s leaves (its
    gate weights replicated)."""
    return {"w_gates": (None, None), "r_gates": ("heads", None, None),
            "b_gates": (None,), "norm": layers.axes_rmsnorm(),
            "up_l": ("fsdp", "ff"), "up_r": ("fsdp", "ff"),
            "down": ("ff", "fsdp")}


def placement_slstm(cfg) -> Tuple[Dict, Dict]:
    """The port's placement of :func:`init_slstm`'s leaves: the cell and
    its gate weights replicated (the cell mixes heads in its gates;
    the reference splits ``r_gates`` on ``"heads"``), the up/down
    projection as the reference places it, by ``"ff"``."""
    axes = dict(axes_slstm(cfg), r_gates=(None, None, None))
    units = {k: {"scale": (1,)} if k == "norm" else (1,) * len(v)
             for k, v in axes.items()}
    return axes, units


def axes_slstm_state() -> Dict:
    return {k: ("batch", None) for k in "cnhm"}


def init_slstm_state(cfg, batch: int, device) -> Dict[str, Tensor]:
    """Zeroed {"c", "n", "h", "m"}, each (B, D) f32."""
    return {k: torch.zeros(batch, cfg.d_model, dtype=torch.float32,
                           device=device) for k in "cnhm"}


def slstm_decode_step(params: Dict[str, Tensor], cfg, x: Tensor,
                      state: Dict[str, Tensor]
                      ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One token: x (B, 1, D) → (B, 1, D); ``state`` updated IN PLACE.
    Returns (out, state)."""
    xw = (x.float() @ params["w_gates"])[:, 0]
    carry, h_out = _slstm_cell(params, cfg, xw,
                               tuple(state[k] for k in "cnhm"))
    for key, new in zip("cnhm", carry):
        state[key].copy_(new)
    return _slstm_out(params, cfg, h_out[:, None, :].to(x.dtype)), state
