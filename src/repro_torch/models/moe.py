"""Mixture-of-Experts: token-choice top-k routing with static capacity.

The counterpart of the JAX package's ``models/moe.py`` on one device (its
local path): an f32 router, softmax, top-k renormalised; each expert
serves at most ``capacity`` of the (token, choice) pairs routed to it, in
token order, and the pairs past it are dropped.  Dispatch scatters token
ids into expert slots and gathers their activations (no k-fold copy),
the experts run as three batched products over (experts, capacity,
d_model) buffers, and the combine adds each slot's output, weighed by its
routing probability, back onto its token.  Shared experts (qwen2-moe) add
a sigmoid-gated SwiGLU MLP.

On a mesh (``use_sharding``), the counterpart of the reference's
``shard_map`` path: tokens arrive split over the batch axes and
replicated over ``model``; each rank routes its local tokens with the
replicated router.  When ``model`` divides the expert count the rank
holds ``E/m`` experts and serves only the pairs routed to them (expert
parallelism); otherwise every expert's ``expert_d_ff`` is split (tensor
parallelism inside every expert).  The shared expert follows its own
specs.  Either way the combine is ONE reduce over ``model``.  Capacity
is per data shard (``C_local`` from ``T_local``), and the aux loss is
each shard's own, averaged over the shards by ``LM.loss``: with data
parallelism, drops and aux follow the reference's per-shard semantics,
not the single-device values.  Under the ``"seq_sp"`` rule the block
takes the rank's positions: it routes them, gathers the sequence and
its routing for the dispatch, and reduce-scatters the combine back to
the rank's positions (:func:`_moe_seq`); capacity and aux are the same
as without the rule.

The reference writes a dropped pair to slot ``E * cap`` and an unfilled
slot's output to token ``T``, one past the end, under ``mode="drop"``;
here the id, probability and fill buffers have one trash slot and the
combine one trash row at those indices, sliced off after.  Every expert
reads all of its capacity every call, filled or not, as in the
reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..dist.sharding import (MODEL, copy_to_model, gather, gather_from_seq,
                             params_to_model, reduce_from_model,
                             reduce_scatter_to_seq, seq_block, split_offset)
from . import layers

Tensor = torch.Tensor


def init_moe(cfg, dtype, generator, device) -> Dict:
    """Router (f32), the experts' stacked SwiGLU weights, and the shared
    expert with its f32 gate (zero, as the reference draws it)."""
    d, e = cfg.d_model, cfg.moe
    ff = e.expert_d_ff

    def w(shape, std, dt=dtype):
        return layers.normal(shape, std, dt, generator, device)

    p = {"router": w((d, e.n_experts), d ** -0.5, torch.float32),
         "w_in": w((e.n_experts, d, ff), d ** -0.5),
         "w_gate": w((e.n_experts, d, ff), d ** -0.5),
         "w_out": w((e.n_experts, ff, d), ff ** -0.5)}
    if e.n_shared_experts:
        p["shared"] = layers.init_mlp(d, e.shared_d_ff, True, dtype,
                                      generator, device)
        p["shared_gate"] = torch.zeros((d, 1), dtype=torch.float32,
                                       device=device)
    return p


def axes_moe(cfg) -> Dict:
    p = {"router": (None, None), "w_in": ("experts", None, "ff"),
         "w_gate": ("experts", None, "ff"), "w_out": ("experts", "ff", None)}
    if cfg.moe.n_shared_experts:
        p["shared"] = layers.axes_mlp(True)
        p["shared_gate"] = (None, None)
    return p


def _capacity(n_tokens: int, cfg) -> int:
    """Slots an expert serves: every pair when T·k <= 4096 (decode steps,
    small prompts: nothing is dropped even if all land on one expert),
    else T·k·capacity_factor / E; a multiple of 8 either way."""
    e = cfg.moe
    if n_tokens * e.top_k <= 4096:
        return (n_tokens * e.top_k + 7) // 8 * 8
    c = int(n_tokens * e.top_k * e.capacity_factor / e.n_experts)
    return max(8, (c + 7) // 8 * 8)


def _route(xt_f32: Tensor, router: Tensor, cfg
           ) -> Tuple[Tensor, Tensor, Tensor]:
    """→ (top_p (T, k), top_e (T, k), probs (T, E)) in f32, top_p
    renormalised over the k choices."""
    probs = torch.softmax(xt_f32 @ router, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return top_p / top_p.sum(dim=-1, keepdim=True), top_e, probs


def _dispatch(xt: Tensor, top_p: Tensor, top_e: Tensor, n_exp: int,
              cap: int, offset: int = 0) -> Tuple[Tensor, Tensor, Tensor]:
    """The (token, choice) pairs routed to experts ``offset .. offset +
    n_exp - 1`` into their slots: → (buf (n_exp, cap, D) of the slots'
    activations, zero where unfilled; tok_of_slot (n_exp·cap,), T where
    unfilled; prob_of_slot (n_exp·cap,) f32)."""
    t, d = xt.shape
    k = top_e.shape[1]
    flat_e = top_e.reshape(-1) - offset                         # (T*k,)
    mine = (flat_e >= 0) & (flat_e < n_exp)
    flat_e = torch.where(mine, flat_e, 0)
    # each pair's position among its expert's pairs, in token order: the
    # scan runs along the innermost dimension of an (E, T*k) one-hot, since
    # torch's scan along the outer dimension of (T*k, E) takes one thread a
    # column (6.9 ms at T*k = 32768, E = 60 on an H100)
    onehot = (F.one_hot(flat_e, n_exp) * mine[:, None]).T.contiguous()
    pos = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(dim=0)
    keep = mine & (pos < cap)
    trash = n_exp * cap
    slot = torch.where(keep, flat_e * cap + pos, trash)

    # invert slot → (token, choice): scatter ids, then gather activations
    pair_tok = torch.arange(t * k, device=xt.device) // k
    tok_of_slot = torch.full((trash + 1,), t, dtype=torch.long,
                             device=xt.device)
    tok_of_slot[slot] = pair_tok
    prob_of_slot = torch.zeros(trash + 1, dtype=torch.float32,
                               device=xt.device)
    prob_of_slot[slot] = top_p.reshape(-1)
    tok_of_slot, prob_of_slot = tok_of_slot[:trash], prob_of_slot[:trash]
    buf = xt[tok_of_slot.clamp(max=t - 1)] * (tok_of_slot < t)[:, None].to(
        xt.dtype)
    return buf.view(n_exp, cap, d), tok_of_slot, prob_of_slot


def _experts(buf: Tensor, w_in: Tensor, w_gate: Tensor, w_out: Tensor
             ) -> Tensor:
    """Every expert's SwiGLU over its slots: (E, cap, D) → (E, cap, D)."""
    h = torch.bmm(buf, w_in)
    g = torch.bmm(buf, w_gate)
    h = F.silu(g.float()).to(h.dtype) * h
    return torch.bmm(h, w_out)


def _combine(out_buf: Tensor, tok_of_slot: Tensor, prob_of_slot: Tensor,
             t: int) -> Tensor:
    """Each slot's output, weighed by its probability, added onto its
    token: → (T, D) f32 (unfilled slots land on the trash row T)."""
    out_buf = out_buf.reshape(-1, out_buf.shape[-1]).float()
    out_buf = out_buf * prob_of_slot[:, None]
    out = torch.zeros((t + 1, out_buf.shape[1]), dtype=torch.float32,
                      device=out_buf.device)
    out.index_add_(0, tok_of_slot, out_buf)
    return out[:t]


def _shared_product(xt: Tensor, shared: Dict) -> Tensor:
    """The shared experts' SwiGLU, ungated: (T, D) f32."""
    h = xt @ shared["w_in"]
    g = xt @ shared["w_gate"]
    h = F.silu(g.float()).to(h.dtype) * h
    return (h @ shared["w_out"]).float()


def _shared_expert(xt: Tensor, xt_f32: Tensor, shared: Dict,
                   shared_gate: Tensor, partial: bool = False) -> Tensor:
    """The shared experts' SwiGLU, gated by sigmoid(x · shared_gate): (T,
    D) f32.  ``partial``: this rank's ``shared_d_ff`` columns, so its
    part of a sum; the gate, computed whole, enters the model region."""
    gate = torch.sigmoid(xt_f32 @ shared_gate)
    return _shared_product(xt, shared) * (copy_to_model(gate) if partial
                                          else gate)


def _placement(params: Dict, cfg) -> Tuple[int, bool, bool, bool]:
    """(the rank's first expert, routed experts split, a shared expert,
    shared expert split) from the local shapes."""
    e = cfg.moe
    n_local, ff_local = params["w_in"].shape[0], params["w_in"].shape[2]
    _, offset = split_offset(n_local, e.n_experts)
    split_offset(ff_local, e.expert_d_ff)               # checks the block
    routed_split = n_local != e.n_experts or ff_local != e.expert_d_ff
    shared = params.get("shared")
    shared_split = bool(shared) and shared["w_in"].shape[1] != e.shared_d_ff
    if shared_split:
        split_offset(shared["w_in"].shape[1], e.shared_d_ff)
    return offset, routed_split, bool(shared), shared_split


def _aux(top_e: Tensor, pe: Tensor, cfg) -> Tensor:
    """The load-balancing loss from the top choices and the mean router
    probabilities ``pe``."""
    e = cfg.moe
    me = F.one_hot(top_e, e.n_experts).float().mean(dim=(0, 1))
    return e.n_experts * (me * pe).sum() * e.router_aux_loss


def moe_block(params: Dict, cfg, x: Tensor, return_aux: bool = False,
              seq: bool = False):
    """x (B, S, D) → (B, S, D) [, the load-balancing loss (f32 scalar)].

    The experts' local shapes say how they are placed: ``w_in`` holding
    fewer than E experts is this rank's run of them (expert parallel),
    a narrower ``expert_d_ff`` is this rank's columns of every expert.
    The parts computed from split weights are partial sums, summed by one
    reduce; their inputs (the tokens, the routing weights, the shared
    gate) enter the model region, so that their gradients are summed
    too.  ``seq``: x (B, S/m, D) is the rank's positions (the
    ``"seq_sp"`` rule, :func:`_moe_seq`)."""
    if seq:
        return _moe_seq(params, cfg, x, return_aux)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    xt_f32 = xt.float()
    top_p, top_e, probs = _route(xt_f32, params["router"], cfg)
    n_local = params["w_in"].shape[0]
    offset, routed_split, _, shared_split = _placement(params, cfg)
    shared = params.get("shared")
    # one entry into the model region for everything split
    xc = copy_to_model(xt) if routed_split or shared_split else xt
    if routed_split:
        top_p = copy_to_model(top_p)
    buf, tok_of_slot, prob_of_slot = _dispatch(
        xc if routed_split else xt, top_p, top_e, n_local,
        _capacity(t, cfg), offset)
    out = _combine(_experts(buf, params["w_in"], params["w_gate"],
                            params["w_out"]), tok_of_slot, prob_of_slot, t)
    whole = None
    if shared_split:
        sh = _shared_expert(xc, xt_f32, shared, params["shared_gate"],
                            partial=True)
        out = out + sh if routed_split else reduce_from_model(sh) + out
    elif shared:
        whole = _shared_expert(xt, xt_f32, shared, params["shared_gate"])
    if routed_split:
        out = reduce_from_model(out)
    if whole is not None:
        out = out + whole
    out = out.to(x.dtype).view(b, s, d)
    if not return_aux:
        return out
    return out, _aux(top_e, probs.mean(dim=0), cfg)


def _moe_seq(params: Dict, cfg, x: Tensor, return_aux: bool):
    """:func:`moe_block` on the rank's positions x (B, S/m, D) of a
    sequence split over the model axis.  Each rank routes its positions
    (the router, read on every rank's own positions, enters the model
    region); the sequence and its routing weights are gathered whole for
    the dispatch, whose capacity is the whole sequence's, as without the
    rule; split experts' partial outputs (and a split shared expert's)
    are reduce-scattered to the rank's positions, whole ones computed on
    every rank and sliced.  A whole shared expert and the shared gate run
    on the rank's positions.  The aux loss takes the gathered choices and
    the router probabilities summed over the ranks (forward only: each
    rank's positions send back their own gradient)."""
    b, s_loc, d = x.shape
    e = cfg.moe
    k = e.top_k
    offset, routed_split, has_shared, shared_split = _placement(params, cfg)
    n_local = params["w_in"].shape[0]
    xl = x.reshape(b * s_loc, d)
    xl_f32 = xl.float()
    top_p, top_e, probs = _route(xl_f32, copy_to_model(params["router"]),
                                 cfg)
    xs = gather_from_seq(x, 1)
    s = xs.shape[1]
    t = b * s
    xt = xs.reshape(t, d)
    top_p = gather_from_seq(top_p.view(b, s_loc, k), 1).reshape(t, k)
    top_e = gather(top_e.view(b, s_loc, k), 1, MODEL).reshape(t, k)
    experts = [params[name] for name in ("w_in", "w_gate", "w_out")]
    if not routed_split:
        experts = [copy_to_model(w) for w in experts]
    buf, tok_of_slot, prob_of_slot = _dispatch(
        xt, top_p, top_e, n_local, _capacity(t, cfg), offset)
    out = _combine(_experts(buf, *experts), tok_of_slot, prob_of_slot, t)
    shared = params.get("shared")
    gate_w = copy_to_model(params["shared_gate"]) if has_shared else None
    sh = None
    if shared_split:
        gate = gather_from_seq(torch.sigmoid(xl_f32 @ gate_w).view(
            b, s_loc, 1), 1).reshape(t, 1)
        sh = _shared_product(xt, shared) * gate
    if routed_split:
        if sh is not None:
            out = out + sh
        out = reduce_scatter_to_seq(out.view(b, s, d), 1)
    else:
        out = seq_block(out.view(b, s, d), 1)
        if sh is not None:
            out = reduce_scatter_to_seq(sh.view(b, s, d), 1) + out
    if has_shared and not shared_split:
        whole = _shared_product(xl, params_to_model(shared))
        out = out + (whole * torch.sigmoid(xl_f32 @ gate_w)).view(
            b, s_loc, d)
    out = out.to(x.dtype)
    if not return_aux:
        return out
    pe = reduce_from_model(probs.sum(dim=0)) / t
    return out, _aux(top_e, pe, cfg)
