"""The bound that K1's bf16 gradients are held to on the card, against
the plain gradient through autograd; shared by ``chip_smoke.py`` (phase 3)
and the tests (``test_torch_flash.py`` on the CPU, ``test_torch_cuda.py``
on the card)."""

from typing import Optional

import torch

from repro_torch.kernels.ref import flash_attention, flash_attention_bwd


def flash_attention_bwd_bf16_bound(q, k, v, out, dout, lse, grads, want,
                                   causal: bool = True,
                                   window: Optional[int] = None,
                                   prefix_len: int = 0):
    """Per-element bounds on |grads - want| for bf16 operands, where
    ``grads`` are K1's (dq, dk, dv) and ``want`` the plain gradient through
    autograd (``ref.flash_attention`` on the same bf16 q, k, v; dout and
    the forward's bf16 out as given).  Both do f32 arithmetic on the same
    bf16 values and round each gradient to bf16 once.  They differ in
    three ways:

    - delta: K1 sums dout * out over the bf16 out, autograd over the f32
      out before its rounding (at most 2^-8 |out| away: bf16 keeps 8
      significant bits), so delta moves by δ ≤ 1.01 2^-8 Σ_d |dout||out|,
      and with it dS = P (dP - delta) scale by P δ scale: dq by scale δ
      (P |k|), dk by scale Pᵀ (δ |q|) summed over the group, dv not at all;
    - the roundings to bf16 of the two unrounded gradients a and b:
      |rnd(a) - rnd(b)| ≤ |a - b| + 2^-8 (|rnd(a)| + |rnd(b)|) (1 + 2^-7);
    - f32 sums in other orders: what the f32 kernel is held to, 2e-4 +
      2e-4 |want|.

    Returns one bound tensor for each of dq, dk, dv (f32)."""
    f32 = torch.float32
    qf, kf, vf, of, dof = (x.to(f32) for x in (q, k, v, out, dout))
    opts = dict(causal=causal, window=window, prefix_len=prefix_len)
    scale = q.shape[-1] ** -0.5
    shift = 1.01 * 2.0 ** -8 * (dof.abs() * of.abs()).sum(-1, keepdim=True)
    e_dq = scale * shift * flash_attention(qf, kf, kf.abs(), **opts)
    e_dk = scale * flash_attention_bwd(qf, kf, vf, of, shift * qf.abs(),
                                       lse, **opts)[2]
    bounds = []
    for g, w, e in zip(grads, want, (e_dq, e_dk, 0.0)):
        g, w = g.to(f32), w.to(f32)
        bounds.append(1.01 * (e + 2.0 ** -8 * (g.abs() + w.abs()))
                      + 2e-4 + 2e-4 * w.abs())
    return tuple(bounds)
