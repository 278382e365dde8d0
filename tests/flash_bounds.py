"""The bound that K1's bf16 gradients are held to on the card, against
the plain gradient through autograd; shared by ``chip_smoke.py`` (phase 3)
and the tests (``test_torch_flash.py`` on the CPU, ``test_torch_cuda.py``
on the card)."""

from typing import Optional

import torch

from repro_torch.kernels.ref import flash_attention, flash_attention_bwd

#: bf16's unit roundoff: 8 significant bits, round to nearest
U_BF16 = 2.0 ** -8


def flash_attention_bwd_bf16_bound(q, k, v, out, dout, lse, grads, want,
                                   causal: bool = True,
                                   window: Optional[int] = None,
                                   prefix_len: int = 0):
    """Per-element bounds on |grads - want| for bf16 operands, where
    ``grads`` are K1's (dq, dk, dv) and ``want`` the plain gradient through
    autograd (``ref.flash_attention`` on the same bf16 q, k, v; dout and
    the forward's bf16 out as given).  Both do f32 arithmetic on the same
    bf16 values and round each gradient to bf16 once, except that K1
    feeds P and dS to its bf16 tensor-core products as two bf16 terms
    each.  They differ in four ways:

    - delta: K1 sums dout * out over the bf16 out, autograd over the f32
      out before its rounding (at most u |out| away, u = 2^-8: bf16 keeps
      8 significant bits), so delta moves by δ ≤ 1.01 u Σ_d |dout||out|,
      and with it dS = P (dP - delta) scale by P δ scale: dq by scale δ
      (P |k|), dk by scale Pᵀ (δ |q|) summed over the group, dv not at all;
    - K1's two-term split: hi = bf16(P), lo = bf16(P - hi) leave |P - hi -
      lo| ≤ u |P - hi| ≤ u² |P| = 2^-16 |P|, so dv = Σ_group Pᵀ dout moves
      by at most 2^-16 Σ_group Pᵀ |dout| (1.01 of it for the f32 sums).
      dS (before its scale) is split the same way, so dq moves by scale
      2^-16 (|dS| |k|) and dk by scale 2^-16 Σ_group |dS|ᵀ |q|.  Here |dS|
      = P |dP - delta| ≤ P (‖dout_q‖ ‖v_k‖ + |delta_q|) (Cauchy-Schwarz
      on dP = dout · v), which keeps each term one plain attention pass
      on absolute values: dq's ‖dout_q‖ (P (‖v‖ |k|)) + |delta_q| (P |k|),
      dk's ‖v_k‖ Pᵀ (‖dout‖ |q|) + Pᵀ (|delta| |q|);
    - the roundings to bf16 of the two unrounded gradients a and b:
      |rnd(a) - rnd(b)| ≤ |a - b| + u (|rnd(a)| + |rnd(b)|) (1 + 2^-7);
    - f32 sums in other orders: what the f32 kernel is held to, 2e-4 +
      2e-4 |want|.

    A single bf16 rounding of P or dS errs by u = 256 u²: the split terms
    leave no room for one (``test_k1_bound_does_not_admit_a_single_bf16_
    p_or_ds``).  Returns one bound tensor for each of dq, dk, dv (f32)."""
    f32 = torch.float32
    qf, kf, vf, of, dof = (x.to(f32) for x in (q, k, v, out, dout))
    opts = dict(causal=causal, window=window, prefix_len=prefix_len)
    scale = q.shape[-1] ** -0.5
    shift = 1.01 * U_BF16 * (dof.abs() * of.abs()).sum(-1, keepdim=True)
    pk = flash_attention(qf, kf, kf.abs(), **opts)     # P |k|
    e_dq = scale * shift * pk
    e_dk = scale * flash_attention_bwd(qf, kf, vf, of, shift * qf.abs(),
                                       lse, **opts)[2]
    # K1's split P and dS: u² of the sums of their absolute terms
    split = 1.01 * U_BF16 ** 2
    dout_norm = dof.norm(dim=-1, keepdim=True)
    v_norm = vf.norm(dim=-1, keepdim=True)
    delta = (dof * of).sum(-1, keepdim=True).abs()
    e_dq = e_dq + split * scale * (
        dout_norm * flash_attention(qf, kf, v_norm * kf.abs(), **opts)
        + delta * pk)
    e_dk = e_dk + split * scale * (
        v_norm * flash_attention_bwd(qf, kf, vf, of, dout_norm * qf.abs(),
                                     lse, **opts)[2]
        + flash_attention_bwd(qf, kf, vf, of, delta * qf.abs(), lse,
                              **opts)[2])
    e_dv = split * flash_attention_bwd(qf, kf, vf, of, dof.abs(), lse,
                                       **opts)[2]
    bounds = []
    for g, w, e in zip(grads, want, (e_dq, e_dk, e_dv)):
        g, w = g.to(f32), w.to(f32)
        bounds.append(1.01 * (e + U_BF16 * (g.abs() + w.abs()))
                      + 2e-4 + 2e-4 * w.abs())
    return tuple(bounds)
