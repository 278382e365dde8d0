"""LM assembly: one :class:`LM` for all ten architectures.

The counterpart of the JAX package's ``models/model.py`` :class:`LM`.
Families:

- dense / moe: embed, ``n_layers`` blocks of RMSNorm → attention →
  residual → RMSNorm → MLP or MoE → residual, final RMSNorm, head;
- vlm (paligemma): projected image patches before the text, attended
  bidirectionally (prefix-LM);
- audio (hubert): projected frames, no causal mask, no decode step;
- hybrid (zamba2): a Mamba2 backbone in groups of ``attn_every`` blocks,
  each group followed by ONE weight-shared attention + MLP block (its own
  KV cache at each application), then a tail of Mamba2 blocks;
- ssm (xlstm): groups of ``mlstm_per_slstm`` mLSTM blocks and one sLSTM
  block.

Parameters stay stacked along leading layer axes under the reference's
names (``blocks``; ``mamba_groups`` (G, attn_every, ...), ``mamba_tail``,
``shared_attn``; ``mlstm_groups`` (G, per, ...), ``slstm``), so its params
map over leaf by leaf (:mod:`.weights`).

Every method is a pure function of the params it is given, except that
:meth:`LM.decode_step` writes the new token's k/v and the recurrent
states into the cache in place.  :meth:`LM.loss` is the training
objective; under ``cfg.remat`` other than ``"none"`` each block of a pass
that autograd records runs under ``torch.utils.checkpoint`` (its
activations recomputed in the backward), which moves memory, not values.

:meth:`LM.param_axes` and :meth:`LM.cache_axes` are the reference's
logical-axis trees, leaf for leaf; :meth:`LM.param_specs` and
:meth:`LM.cache_specs` are the port's placement of them on the active
mesh (``dist.sharding``), the recurrent blocks and states by whole heads
(:meth:`LM.placement`).  Under ``use_sharding`` every method takes each
rank's local blocks and runs explicit SPMD: tensor and expert
parallelism on the ``model`` axis, the batch split over the data axes;
:meth:`LM.loss` gives the global batch's value on every rank.  The
``"seq_sp"`` rule splits the transformer families' residual stream over
the sequence between blocks (:meth:`LM.backbone`), and the
``"cache_seq"`` rule the decode cache's slots (:meth:`LM.cache_specs`,
:meth:`LM.decode_step`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.runtime import resolve_device
from ..dist import sharding
from ..dist.sharding import (MODEL, P, aligned_spec, all_reduce,
                             batch_mean, current_ctx, gather_from_data,
                             gather_from_seq, map_axes, params_to_model,
                             reduce_from_model, resolve_spec,
                             scatter_to_seq, shard_tree, spec_axes,
                             split_offset)
from . import attention, layers, moe, ssm, xlstm

Params = Dict[str, Any]
Tensor = torch.Tensor

#: the families whose params are one ``blocks`` stack of transformer blocks
TRANSFORMER = ("dense", "moe", "vlm", "audio")
#: the recurrent families: no batched prefill, the cache holds states
RECURRENT = ("hybrid", "ssm")
FAMILIES = TRANSFORMER + RECURRENT


class LM:
    """Config-driven model on ``device`` (``None``: the card)."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
        self.cfg = cfg
        self.dtype = layers.DTYPES[cfg.dtype]
        self.device = resolve_device(device)
        self._shapes: Optional[Params] = None
        # the "fsdp" rule's splits, by mesh and rules (:meth:`_fsdp_plan`)
        self._plans: Dict[Any, Tuple[Any, Optional[Params]]] = {}

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Random params drawn from ``generator`` (on ``self.device``), at
        the reference's scales: N(0, 1/fan_in) weights, unit norms, zero
        biases and shared-expert gates; the recurrent blocks' gate and
        decay leaves in f32 (:mod:`.ssm`, :mod:`.xlstm`)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        p: Params = {"embed": layers.init_embedding(cfg.vocab, cfg.d_model,
                                                    dt, generator, dev),
                     "final_norm": layers.init_rmsnorm(cfg.d_model, dt, dev)}
        if not cfg.tie_embeddings:
            p["lm_head"] = layers.init_embedding(cfg.vocab, cfg.d_model, dt,
                                                 generator, dev)
        if cfg.frontend_dim:
            p["frontend"] = layers.init_frontend_proj(
                cfg.frontend_dim, cfg.d_model, dt, generator, dev)
        if cfg.family in TRANSFORMER:
            p["blocks"] = _stack([self._init_block(generator)
                                  for _ in range(cfg.n_layers)])
        elif cfg.family == "hybrid":
            groups, tail = self._zamba_layout()
            p["mamba_groups"] = _stack([
                _stack([self._init_mamba_block(generator)
                        for _ in range(cfg.attn_every)])
                for _ in range(groups)])
            if tail:
                p["mamba_tail"] = _stack([self._init_mamba_block(generator)
                                          for _ in range(tail)])
            p["shared_attn"] = self._init_block(generator)
        else:
            groups, per = self._xlstm_layout()
            p["mlstm_groups"] = _stack([
                _stack([self._init_mlstm_block(generator)
                        for _ in range(per)])
                for _ in range(groups)])
            p["slstm"] = _stack([self._init_slstm_block(generator)
                                 for _ in range(groups)])
        return p

    def _init_block(self, generator) -> Params:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        p = {"ln1": layers.init_rmsnorm(cfg.d_model, dt, dev),
             "attn": attention.init_attention(cfg, dt, generator, dev),
             "ln2": layers.init_rmsnorm(cfg.d_model, dt, dev)}
        if cfg.moe is not None and cfg.family == "moe":
            p["moe"] = moe.init_moe(cfg, dt, generator, dev)
        elif cfg.d_ff > 0:
            p["mlp"] = layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                                       dt, generator, dev)
        return p

    def _init_mamba_block(self, generator) -> Params:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        return {"ln": layers.init_rmsnorm(cfg.d_model, dt, dev),
                "mixer": ssm.init_mamba2(cfg, dt, generator, dev)}

    def _init_mlstm_block(self, generator) -> Params:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        return {"ln": layers.init_rmsnorm(cfg.d_model, dt, dev),
                "mixer": xlstm.init_mlstm(cfg, dt, generator, dev)}

    def _init_slstm_block(self, generator) -> Params:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        return {"ln": layers.init_rmsnorm(cfg.d_model, dt, dev),
                "cell": xlstm.init_slstm(cfg, dt, generator, dev)}

    # -- placement ----------------------------------------------------------
    def param_axes(self) -> Params:
        """The reference's logical axes of every param leaf: the tree of
        :meth:`init` with a tuple of logical names (or None) a dimension,
        the stacked layer axes None."""
        cfg = self.cfg
        p: Params = {"embed": layers.axes_embedding(),
                     "final_norm": layers.axes_rmsnorm()}
        if not cfg.tie_embeddings:
            p["lm_head"] = layers.axes_embedding()
        if cfg.frontend_dim:
            p["frontend"] = layers.axes_frontend_proj()
        if cfg.family in TRANSFORMER:
            p["blocks"] = _stack_axes(self._axes_block())
        elif cfg.family == "hybrid":
            _, tail = self._zamba_layout()
            mamba = {"ln": layers.axes_rmsnorm(),
                     "mixer": ssm.axes_mamba2(cfg)}
            p["mamba_groups"] = _stack_axes(_stack_axes(mamba))
            if tail:
                p["mamba_tail"] = _stack_axes(mamba)
            p["shared_attn"] = self._axes_block()
        else:
            p["mlstm_groups"] = _stack_axes(_stack_axes(
                {"ln": layers.axes_rmsnorm(),
                 "mixer": xlstm.axes_mlstm(cfg)}))
            p["slstm"] = _stack_axes({"ln": layers.axes_rmsnorm(),
                                      "cell": xlstm.axes_slstm(cfg)})
        return p

    def _axes_block(self) -> Params:
        cfg = self.cfg
        p = {"ln1": layers.axes_rmsnorm(),
             "attn": attention.axes_attention(cfg),
             "ln2": layers.axes_rmsnorm()}
        if cfg.moe is not None and cfg.family == "moe":
            p["moe"] = moe.axes_moe(cfg)
        elif cfg.d_ff > 0:
            p["mlp"] = layers.axes_mlp(cfg.mlp_gated)
        return p

    def cache_axes(self, long_context: bool = False) -> Params:
        """The reference's logical axes of the decode cache's leaves."""
        fam = self.cfg.family
        kv = _stack_axes(attention.axes_kv_cache(long_context))
        if fam in ("dense", "moe", "vlm"):
            return {"kv": kv}
        if fam == "hybrid":
            _, tail = self._zamba_layout()
            c = {"mamba": _stack_axes(_stack_axes(ssm.axes_mamba2_state())),
                 "kv": kv}
            if tail:
                c["mamba_tail"] = _stack_axes(ssm.axes_mamba2_state())
            return c
        if fam == "ssm":
            return {"mlstm": _stack_axes(_stack_axes(
                        xlstm.axes_mlstm_state())),
                    "slstm": _stack_axes(xlstm.axes_slstm_state())}
        raise ValueError(f"no decode cache for family {fam}")

    def param_shapes(self) -> Params:
        """The whole params' shapes, from an init on the meta device (no
        storage, no generator), made once a model."""
        if self._shapes is None:
            meta = LM(self.cfg, device="meta").init(None)
            self._shapes = map_axes(lambda _, x: tuple(x.shape),
                                    self.param_axes(), meta)
        return self._shapes

    def _param_units(self, axes: Params, in_attention: bool = False
                     ) -> Params:
        """Per leaf of ``axes``, the entries of each dimension that make
        one indivisible unit: a head's ``head_dim`` along the attention's
        flattened head columns, else 1."""
        heads = attention.head_units(self.cfg)
        out = {}
        for k, v in axes.items():
            if isinstance(v, dict):
                out[k] = self._param_units(v, k == "attn")
            else:
                unit = heads[k] if in_attention else ()
                out[k] = (1,) * (len(v) - len(unit)) + tuple(unit)
        return out

    def placement(self) -> Tuple[Params, Params]:
        """The port's logical placement of every param leaf: (axes, units),
        two trees of :meth:`param_axes`' shape.  The axes are the
        reference's, except the recurrent mixers', which split by whole
        heads (:func:`.ssm.placement_mamba2`, :func:`.xlstm.placement_mlstm`,
        :func:`.xlstm.placement_slstm`); a unit is the entries of a
        dimension that make one head (1 where there is none), which no
        split may cut."""
        axes = self.param_axes()
        units = self._param_units(axes)
        fam = self.cfg.family
        if fam == "hybrid":
            mixer = ssm.placement_mamba2(self.cfg)
            _place(axes, units, ("mamba_groups", "mixer"), mixer, 2)
            if "mamba_tail" in axes:
                _place(axes, units, ("mamba_tail", "mixer"), mixer, 1)
        elif fam == "ssm":
            _place(axes, units, ("mlstm_groups", "mixer"),
                   xlstm.placement_mlstm(self.cfg), 2)
            _place(axes, units, ("slstm", "cell"),
                   xlstm.placement_slstm(self.cfg), 1)
        return axes, units

    def param_specs(self, ctx=None) -> Params:
        """The port's placement of every param leaf on the active mesh:
        :meth:`placement` resolved as the reference resolves its axes
        (:func:`~repro_torch.dist.sharding.resolve_spec`), except that no
        head is cut (:func:`~repro_torch.dist.sharding.aligned_spec`; an
        expert never is, the expert dimension being whole experts).

        The layers run tensor parallelism on the ``model`` axis, and the
        ``"fsdp"`` rule's dimensions split over its own axes (the data
        axes), which each block gathers whole before it runs
        (:meth:`_fsdp_plan`).  The ``"seq_sp"`` rule places no param (it
        splits activations, :meth:`backbone`).  Raises for a rule that
        splits a parameter over another axis (``"fsdp"`` on ``model``
        too), and for ``"seq_sp"`` onto another axis than ``model``,
        whose reduces it turns into reduce-scatters."""
        ctx = ctx or current_ctx()
        off_model = set(ctx.mesh_axes_for("seq_sp")) - {MODEL}
        if off_model:
            raise NotImplementedError(
                f"the seq_sp rule onto {sorted(off_model)}: the port splits "
                "the sequence over the model axis only, where its "
                "tensor-parallel reduces become reduce-scatters")
        axes, units = self.placement()
        specs = map_axes(lambda ax, shape, unit: aligned_spec(
            ax, shape, unit, ctx), axes, self.param_shapes(), units)
        fsdp, bad = set(ctx.mesh_axes_for("fsdp")) - {MODEL}, set()

        def check(ax, spec):
            for logical, entry in zip(ax, spec):
                allowed = fsdp if logical == "fsdp" else {MODEL}
                bad.update(set(spec_axes(P(entry))) - allowed)

        map_axes(check, axes, specs)
        if bad:
            raise NotImplementedError(
                f"rules that split parameters over {sorted(bad)}: the "
                "port's layers run tensor parallelism on the model axis "
                "and gather the fsdp rule's dimensions over the data axes "
                "only")
        return specs

    def _fsdp_plan(self, ctx=None) -> Optional[Params]:
        """Where the ``"fsdp"`` rule splits each param leaf on the active
        mesh: a tree of :meth:`param_axes`' shape holding (the dimension,
        counted from the end, so that it holds for one layer's slice of a
        stacked leaf too; its mesh axes), or None for a leaf it leaves
        whole; None when it splits nothing (the default rules)."""
        ctx = ctx or current_ctx()
        if not ctx.fsdp_axes:
            return None
        key = (id(ctx.mesh), repr(sorted(ctx.rules.items())))
        hit = self._plans.get(key)
        if hit is not None and hit[0] is ctx.mesh:
            return hit[1]
        axes, _ = self.placement()

        def where(ax, spec):
            for i, (logical, entry) in enumerate(zip(ax, spec)):
                if logical == "fsdp" and entry is not None:
                    return i - len(ax), spec_axes(P(entry))
            return None

        plan = map_axes(where, axes, self.param_specs(ctx))
        self._plans[key] = (ctx.mesh, plan)
        return plan

    def _gather(self, tree, *path: str):
        """``tree``, the params at ``path`` (or one layer's of them), with
        every leaf the ``"fsdp"`` rule splits gathered whole over its axes
        (:func:`~repro_torch.dist.sharding.gather_from_data`: its gradient
        reduce-scattered back), so the block sees the block of the model
        axis it sees without the rule; ``tree`` itself without it."""
        plan = self._fsdp_plan()
        for k in path:
            if plan is None:
                break
            plan = plan[k]
        return _gathered(tree, plan)

    def _gathering(self, fn, *path: str):
        """``fn(block_params, *args)`` with its block's params gathered
        first (:meth:`_gather` at ``path``).  Under :meth:`_remat` the
        gather runs inside the recomputed region: the recompute gathers
        again, and no gathered layer outlives its block."""
        if self._fsdp_plan() is None:
            return fn

        def gathered(bp, *args):
            return fn(self._gather(bp, *path), *args)

        return gathered

    def cache_specs(self, batch: int, max_seq: int,
                    long_context: bool = False, ctx=None) -> Params:
        """The port's placement of the decode cache of :meth:`init_cache`
        (``batch``, ``max_seq``) on the active mesh: the reference's
        :meth:`cache_axes` resolved, except the recurrent states', which
        hold the rank's heads (:func:`.ssm.placement_mamba2_state`,
        :func:`.xlstm.placement_mlstm_state`).  A sharded decode takes
        ``shard_tree(init_cache(batch, max_seq), cache_specs(batch,
        max_seq))`` (or ``init_cache(batch, max_seq, specs)``, the rank's
        block alone), as a sharded step takes its params.  Under the
        ``"cache_seq"`` rule the KV caches' slots split over its axes
        where they divide them (the reference's decode_32k on ``model``,
        long_500k on ``("data", "model")`` where a batch of 1 leaves the
        data axis free); :meth:`prefill` and :meth:`decode_step` then take
        these specs."""
        ctx = ctx or current_ctx()
        axes = self.cache_axes(long_context)
        units = map_axes(lambda ax: (1,) * len(ax), axes)
        cfg = self.cfg
        if cfg.family == "hybrid":
            state = ssm.placement_mamba2_state(cfg)
            _place(axes, units, ("mamba",), state, 2)
            if "mamba_tail" in axes:
                _place(axes, units, ("mamba_tail",), state, 1)
        elif cfg.family == "ssm":
            _place(axes, units, ("mlstm",), xlstm.placement_mlstm_state(cfg),
                   2)
        shapes = LM(cfg, device="meta").init_cache(batch, max_seq)
        return map_axes(lambda ax, x, unit: aligned_spec(
            ax, tuple(x.shape), unit, ctx), axes, shapes, units)

    def _zamba_layout(self) -> Tuple[int, int]:
        """(groups of ``attn_every`` Mamba2 blocks, Mamba2 blocks after
        the last group): zamba2-1.2b's 38 layers are 6 groups of 6 and a
        tail of 2."""
        groups = self.cfg.n_layers // self.cfg.attn_every
        return groups, self.cfg.n_layers - groups * self.cfg.attn_every

    def _xlstm_layout(self) -> Tuple[int, int]:
        """(groups, mLSTM blocks a group); each group ends in one sLSTM
        block: xlstm-350m's 24 layers are 3 groups of 7 + 1."""
        per = self.cfg.xlstm.mlstm_per_slstm
        return self.cfg.n_layers // (per + 1), per

    def _blocks(self, params: Params):
        """Layer i's params, as views into the stacked leaves."""
        for i in range(self.cfg.n_layers):
            yield _index(params["blocks"], i)

    # -- forward --------------------------------------------------------------
    def _remat(self, fn):
        """``fn`` recomputed in the backward, as the reference's
        ``_maybe_remat`` wraps each scanned block in ``jax.checkpoint``:
        under ``cfg.remat`` "block", "full" (or "attn") the call runs
        inside a non-reentrant ``torch.utils.checkpoint``, which keeps only
        the block's inputs and recomputes the rest (under the sharding
        context of the forward) (JAX's policies differ
        in which products "block" and "attn" save; here every policy
        recomputes the whole block).  A call that autograd does not record
        (grad mode off, or no tensor argument requiring grad) runs ``fn``
        as it is."""
        if self.cfg.remat == "none":
            return fn

        def wrapped(*args):
            if torch.is_grad_enabled() and _requires_grad(args):
                # the recompute may run in autograd's device thread, which
                # does not see the caller's placement context: install it
                ctx = current_ctx()

                def placed(*a):
                    with sharding.installed(ctx):
                        return fn(*a)

                return checkpoint(placed, *args, use_reentrant=False)
            return fn(*args)

        return wrapped

    def _layer(self, bp: Params, x: Tensor, positions: Tensor, causal: bool,
               prefix_len: int, seq: bool = False
               ) -> Tuple[Tensor, Optional[Tensor]]:
        """One transformer block: attention, then :meth:`_block`; ``seq``:
        x is the rank's positions (:meth:`backbone`)."""
        a = attention.attention_block(
            bp["attn"], self.cfg,
            layers.rmsnorm(_norm(bp["ln1"], seq), x, self.cfg.norm_eps),
            positions, causal=causal, prefix_len=prefix_len, seq=seq)
        return self._block(bp, x, a, return_aux=True, seq=seq)

    def _block(self, bp: Params, h: Tensor, attn_out: Tensor,
               return_aux: bool = False, seq: bool = False
               ) -> Tuple[Tensor, Optional[Tensor]]:
        """The residual tail of a block, after its attention output; with
        ``return_aux`` also the block's router loss (None without MoE)."""
        h = h + attn_out
        hn = layers.rmsnorm(_norm(bp["ln2"], seq), h, self.cfg.norm_eps)
        aux = None
        if "moe" in bp:
            f = moe.moe_block(bp["moe"], self.cfg, hn, return_aux=return_aux,
                              seq=seq)
            if return_aux:
                f, aux = f
            h = h + f
        elif "mlp" in bp:
            h = h + layers.mlp(bp["mlp"], hn, self.cfg.mlp_gated,
                               self.cfg.d_ff, seq=seq)
        return h, aux

    def _seq_split(self, x: Tensor) -> bool:
        """Whether the ``"seq_sp"`` rule splits the residual stream x (the
        rank's rows, (B, S, D)) over the sequence: it maps to the model
        axis (:meth:`param_specs`) and resolves on the global shape, so an
        S that the axis does not divide stays whole."""
        ctx = current_ctx()
        if ctx.size(ctx.mesh_axes_for("seq_sp")) == 1:
            return False
        b, s, d = x.shape
        spec = resolve_spec(("batch", "seq_sp", None),
                            (b * ctx.size(ctx.batch_axes), s, d), ctx)
        return len(spec) > 1 and spec_axes(P(spec[1])) == (MODEL,)

    def backbone(self, params: Params, x: Tensor, positions: Tensor, *,
                 causal: bool = True, prefix_len: int = 0
                 ) -> Tuple[Tensor, Tensor]:
        """(B, S, D) → (B, S, D); returns (hidden, aux_loss: the blocks'
        router losses summed, 0 without MoE).

        Under the ``"seq_sp"`` rule (Megatron's sequence parallelism, the
        reference's ``shard(h, "batch", "seq_sp", None)`` between the
        blocks) the transformer families keep the residual stream split
        over the sequence between blocks: each rank runs the norms and
        residual adds on its positions, gathers the sequence before
        attention and the MLP or MoE, and reduce-scatters their
        row-parallel outputs; remat saves the block's split input, and
        the fsdp gathers stay inside the region.  The sequence is
        gathered whole after the last block.  The hybrid and ssm families
        ignore the rule, as the reference's backbones for them carry no
        ``seq_sp`` annotation."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "hybrid":
            return self._zamba_backbone(params, x, positions, causal), aux
        if cfg.family == "ssm":
            return self._xlstm_backbone(params, x), aux
        seq = self._seq_split(x)
        if seq:
            x = scatter_to_seq(x, 1)
        layer = self._remat(self._gathering(self._layer, "blocks"))
        for bp in self._blocks(params):
            x, block_aux = layer(bp, x, positions, causal, prefix_len, seq)
            if block_aux is not None:
                aux = aux + block_aux
        if seq:
            x = gather_from_seq(x, 1, summed=False)
        return x, aux

    def _mamba(self, bp: Params, x: Tensor) -> Tensor:
        return x + ssm.mamba2_block(
            bp["mixer"], self.cfg,
            layers.rmsnorm(bp["ln"], x, self.cfg.norm_eps))

    def _shared_part(self, bp: Params, x: Tensor, positions: Tensor,
                     causal: bool) -> Tensor:
        """The hybrid's weight-shared attention + MLP block."""
        a = attention.attention_block(
            bp["attn"], self.cfg,
            layers.rmsnorm(bp["ln1"], x, self.cfg.norm_eps), positions,
            causal=causal)
        return self._block(bp, x, a)[0]

    def _zamba_backbone(self, params: Params, x: Tensor, positions: Tensor,
                        causal: bool) -> Tensor:
        cfg = self.cfg
        groups, tail = self._zamba_layout()
        mamba = self._remat(self._gathering(self._mamba, "mamba_groups"))
        shared = self._remat(self._gathering(self._shared_part,
                                             "shared_attn"))
        for g in range(groups):
            group = _index(params["mamba_groups"], g)
            for i in range(cfg.attn_every):
                x = mamba(_index(group, i), x)
            # the weight-shared block, the same params each time (autograd
            # sums their gradients over the groups)
            x = shared(params["shared_attn"], x, positions, causal)
        mamba = self._remat(self._gathering(self._mamba, "mamba_tail"))
        for i in range(tail):
            x = mamba(_index(params["mamba_tail"], i), x)
        return x

    def _mlstm(self, bp: Params, x: Tensor) -> Tensor:
        return x + xlstm.mlstm_block(
            bp["mixer"], self.cfg,
            layers.rmsnorm(bp["ln"], x, self.cfg.norm_eps))

    def _slstm(self, sp: Params, x: Tensor) -> Tensor:
        return x + xlstm.slstm_block(
            sp["cell"], self.cfg,
            layers.rmsnorm(sp["ln"], x, self.cfg.norm_eps))

    def _xlstm_backbone(self, params: Params, x: Tensor) -> Tensor:
        groups, per = self._xlstm_layout()
        mlstm = self._remat(self._gathering(self._mlstm, "mlstm_groups"))
        slstm = self._remat(self._gathering(self._slstm, "slstm"))
        for g in range(groups):
            group = _index(params["mlstm_groups"], g)
            for i in range(per):
                x = mlstm(_index(group, i), x)
            x = slstm(_index(params["slstm"], g), x)
        return x

    def _input(self, batch: Dict, name: str) -> Tensor:
        return torch.as_tensor(batch[name], device=self.device)

    def embed_inputs(self, params: Params, batch: Dict
                     ) -> Tuple[Tensor, Tensor, int]:
        """Batch dict → (embeddings (B, S, D), positions (S,), prefix_len).

        vlm: the projected ``patches`` (B, P, frontend_dim), then the
        ``tokens``' embeddings, scaled by sqrt(d_model) rounded to the
        params' type when the head is tied; prefix_len = P.  audio: the
        projected ``frames``.  Otherwise the ``tokens``' embeddings."""
        cfg = self.cfg
        if cfg.family == "vlm":
            patches = layers.frontend_proj(
                self._gather(params["frontend"], "frontend"),
                self._input(batch, "patches").to(self.dtype))
            tok = self._embed_tokens(params, self._input(batch, "tokens"))
            x = torch.cat([patches, tok], dim=1)
            prefix = patches.shape[1]
        elif cfg.family == "audio":
            x = layers.frontend_proj(
                self._gather(params["frontend"], "frontend"),
                self._input(batch, "frames").to(self.dtype))
            prefix = 0
        else:
            x = layers.embed(self._gather(params["embed"], "embed"),
                             self._input(batch, "tokens").long(), cfg.vocab)
            prefix = 0
        positions = torch.arange(x.shape[1], device=self.device)
        return x, positions, prefix

    def _embed_tokens(self, params: Params, tokens: Tensor) -> Tensor:
        """Token embeddings; a vlm's tied head scales them by sqrt(d_model)
        in the params' type (bf16: 45.25 at d_model 2048), as the
        reference's ``jnp.asarray(d ** 0.5, tok.dtype)`` does."""
        x = layers.embed(self._gather(params["embed"], "embed"),
                         tokens.long(), self.cfg.vocab)
        if self.cfg.family == "vlm" and self.cfg.tie_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def logits(self, params: Params, hidden: Tensor) -> Tensor:
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        return layers.unembed(self._gather(params[name], name), hidden,
                              self.cfg.vocab)

    def _hidden(self, params: Params, batch: Dict) -> Tuple[Tensor, Tensor]:
        cfg = self.cfg
        x, positions, prefix = self.embed_inputs(params, batch)
        h, aux = self.backbone(params, x, positions,
                               causal=not cfg.encoder_only, prefix_len=prefix)
        return layers.rmsnorm(params["final_norm"], h, cfg.norm_eps), aux

    def hidden(self, params: Params, batch: Dict) -> Tensor:
        """Final-norm hidden states (B, S, D): what the head reads."""
        return self._hidden(params, batch)[0]

    def forward(self, params: Params, batch: Dict) -> Tuple[Tensor, Tensor]:
        """Full-sequence forward → (logits (B, S, V) f32, aux_loss).  On a
        mesh: the rank's batch rows and vocab shard of the logits (the
        reference's ``("batch", None, "vocab")``), the rank's aux."""
        h, aux = self._hidden(params, batch)
        return self.logits(params, h), aux

    # -- loss -------------------------------------------------------------------
    def loss(self, params: Params, batch: Dict
             ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The training objective → (total, {"ce", "aux"}): the mean
        next-token cross-entropy (a vlm's text positions only, after its
        ``n_patches`` image positions; audio: the cross-entropy of the
        frames' ``targets``, averaged over its ``mask``), plus the blocks'
        router loss.

        On a mesh ``batch`` holds this rank's rows; the cross-entropy is
        vocab-parallel over the model axis, and the values are the global
        batch's on every rank (audio's masked mean sums its numerator and
        its denominator over the data ranks apart; the aux is each data
        shard's own, averaged).  Each rank's gradient is its own shard's
        term: the train step's mean over the data ranks completes it."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch)
        ctx = current_ctx()
        n_data = ctx.size(ctx.batch_axes)
        if cfg.family == "audio":
            mask = self._input(batch, "mask").float()
            ce = _cross_entropy(logits, self._input(batch, "targets"),
                                cfg.vocab)
            den = mask.sum()
            if n_data > 1:
                den = all_reduce(den.detach().clone(), ctx.batch_axes, ctx)
            loss = (ce * mask).sum() * n_data / den.clamp_min(1.0)
        else:
            if cfg.family == "vlm":
                logits = logits[:, cfg.n_patches:]
            tokens = self._input(batch, "tokens")
            loss = _cross_entropy(logits[:, :-1], tokens[:, 1:],
                                  cfg.vocab).mean()
        if n_data > 1:
            loss, aux = batch_mean(torch.stack([loss, aux.float()])).unbind()
        return loss + aux, {"ce": loss, "aux": aux}

    # -- decode ---------------------------------------------------------------
    def _check_decoder(self, what: str) -> None:
        """Raise for an encoder (audio), which has no ``what``: no cache,
        no prefill and no decode step."""
        if self.cfg.encoder_only:
            raise ValueError(f"{self.cfg.name} ({self.cfg.family}) is an "
                             f"encoder: it has no {what}")

    def init_cache(self, batch: int, max_seq: int,
                   specs: Optional[Params] = None) -> Params:
        """The zeroed decode cache, leaves stacked as the params are:

        - transformer families: {"kv": {"k", "v"}}, (n_layers, B, L, KV,
          hd);
        - hybrid: {"mamba": {"conv", "ssm"}} (G, attn_every, B, ...),
          {"kv"} (G, B, L, KV, hd), one cache for each application of the
          shared block, and {"mamba_tail"} (tail, B, ...) when there is a
          tail;
        - ssm: {"mlstm": {"conv", "s", "n", "m"}} (G, per, B, ...) and
          {"slstm": {"c", "n", "h", "m"}} (G, B, D).

        With ``specs`` (:meth:`cache_specs` of the same ``batch`` and
        ``max_seq``) the rank's block of each leaf alone, zeroed, as
        ``shard_tree`` would cut the whole cache.
        """
        self._check_decoder("decode cache")
        if specs is not None:
            local = shard_tree(LM(self.cfg, device="meta").init_cache(
                batch, max_seq), specs)
            return map_axes(lambda _, x: torch.zeros(
                x.shape, dtype=x.dtype, device=self.device), specs, local)
        cfg, dt, dev = self.cfg, self.dtype, self.device
        if cfg.family == "ssm":
            groups, per = self._xlstm_layout()
            return {"mlstm": _stacked_zeros(
                        xlstm.init_mlstm_state(cfg, batch, dt, dev),
                        (groups, per)),
                    "slstm": _stacked_zeros(
                        xlstm.init_slstm_state(cfg, batch, dev), (groups,))}
        kv = attention.init_kv_cache(cfg, batch, max_seq, dt, dev)
        if cfg.family != "hybrid":
            return {"kv": _stacked_zeros(kv, (cfg.n_layers,))}
        groups, tail = self._zamba_layout()
        state = ssm.init_mamba2_state(cfg, batch, dt, dev)
        cache = {"mamba": _stacked_zeros(state, (groups, cfg.attn_every)),
                 "kv": _stacked_zeros(kv, (groups,))}
        if tail:
            cache["mamba_tail"] = _stacked_zeros(state, (tail,))
        return cache

    def _cache_seq(self, specs: Optional[Params]) -> Tuple[str, ...]:
        """The mesh axes the KV caches' slots split over, read from the
        cache's ``specs`` (:meth:`cache_specs`; a local cache no longer
        says what divided).  Without them, none; that raises under an
        active ``"cache_seq"`` rule."""
        if specs is None:
            ctx = current_ctx()
            if ctx.size(ctx.mesh_axes_for("cache_seq")) > 1:
                raise ValueError(
                    "the cache_seq rule may split the decode cache's slots: "
                    "pass the cache's specs (LM.cache_specs)")
            return ()
        return _dim_axes(specs["kv"]["k"], 2)

    def prefill(self, params: Params, batch: Dict, max_seq: int,
                specs: Optional[Params] = None) -> Tuple[Tensor, Params]:
        """One full forward pass that also fills the decode cache
        (bidirectional over a vlm's image prefix).

        Returns (logits (B, S, V), cache ready for decode at pos = S).
        On a mesh ``batch`` holds the rank's rows; with ``specs``
        (:meth:`cache_specs` of the global batch and ``max_seq``, needed
        under the ``"cache_seq"`` rule) the cache is the rank's block of
        them, each rank writing its own slots with every KV head.
        """
        cfg = self.cfg
        self._check_decoder("prefill with a cache")
        if cfg.family in RECURRENT:
            raise NotImplementedError(
                f"batched prefill-with-cache for family {cfg.family} uses "
                "the recurrent decode path instead (ServeEngine.prefill "
                "steps it token by token)")
        x, positions, prefix = self.embed_inputs(params, batch)
        b, s, _ = x.shape
        seq = self._cache_seq(specs)
        if specs is None:
            cache = self.init_cache(b, max_seq)
        else:
            rows = current_ctx().size(_dim_axes(specs["kv"]["k"], 1))
            cache = self.init_cache(b * rows, max_seq, specs)
        kc, vc = cache["kv"]["k"], cache["kv"]["v"]
        span = kc.shape[2]
        cache_len = span * current_ctx().size(seq)
        if cfg.sliding_window is not None and s > cache_len:
            raise NotImplementedError(
                "SWA ring-cache prefill beyond the window: decode the "
                "overflow stepwise")
        take = min(s, cache_len)
        # this rank's slots [lo, hi) of the first `take`
        lo = current_ctx().coord(seq) * span
        hi = min(take, lo + span)
        for i, bp in enumerate(self._blocks(params)):
            bp = self._gather(bp, "blocks")
            a, (k, v) = attention.attention_block(
                bp["attn"], cfg, layers.rmsnorm(bp["ln1"], x, cfg.norm_eps),
                positions, causal=True, prefix_len=prefix, return_kv=True)
            # the rope'd K/V of the last `take` positions, from slot 0
            if hi > lo:
                kc[i, :, :hi - lo] = k[:, s - take + lo:s - take + hi]
                vc[i, :, :hi - lo] = v[:, s - take + lo:s - take + hi]
            x, _ = self._block(bp, x, a)
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return self.logits(params, x), cache

    def decode_step(self, params: Params, cache: Params, token, pos: int,
                    specs: Optional[Params] = None) -> Tuple[Tensor, Params]:
        """One decode step. token (B, 1) ints; pos an int.  Writes the
        token's k/v and the recurrent states into ``cache`` in place, so
        its storage stays fixed from step to step.  Returns (logits
        (B, 1, V), cache).

        The position and the valid slot count go to the device once per
        step, in one int32 tensor, which every attention layer's rope and
        flash-decode kernel read there.  ``specs``: the cache's placement
        (:meth:`cache_specs`), needed under the ``"cache_seq"`` rule, where
        each rank holds a block of the slots
        (:func:`.attention._decode_slots`)."""
        cfg = self.cfg
        self._check_decoder("decode step")
        x = self._embed_tokens(params, torch.as_tensor(token,
                                                       device=self.device))
        if cfg.family == "ssm":
            x = self._xlstm_decode(params, cache, x)
        else:
            kc, vc = cache["kv"]["k"], cache["kv"]["v"]
            pos = int(pos)
            seq = self._cache_seq(specs)
            slot, n_valid = attention.cache_slot(
                cfg, kc.shape[2] * current_ctx().size(seq), pos)
            step = torch.tensor([pos, n_valid], dtype=torch.int32,
                                device=self.device)

            def attend(bp, x, i):
                a, _ = attention.decode_attention(
                    bp["attn"], cfg,
                    layers.rmsnorm(bp["ln1"], x, cfg.norm_eps),
                    {"k": kc[i], "v": vc[i]}, slot, step[:1], step[1], seq)
                return self._block(bp, x, a)[0]

            if cfg.family == "hybrid":
                x = self._zamba_decode(params, cache, x, attend)
            else:
                for i, bp in enumerate(self._blocks(params)):
                    x = attend(self._gather(bp, "blocks"), x, i)
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return self.logits(params, x), cache

    def _mamba_step(self, bp: Params, x: Tensor, state: Params) -> Tensor:
        m, _ = ssm.mamba2_decode_step(
            bp["mixer"], self.cfg,
            layers.rmsnorm(bp["ln"], x, self.cfg.norm_eps), state)
        return x + m

    def _zamba_decode(self, params: Params, cache: Params, x: Tensor,
                      attend) -> Tensor:
        """The hybrid's step: each group's Mamba2 blocks, then the shared
        block on the group's own KV cache (``attend(block, x, g)``), then
        the tail."""
        groups, tail = self._zamba_layout()
        for g in range(groups):
            group = _index(params["mamba_groups"], g)
            states = _index(cache["mamba"], g)
            for i in range(self.cfg.attn_every):
                x = self._mamba_step(
                    self._gather(_index(group, i), "mamba_groups"), x,
                    _index(states, i))
            x = attend(self._gather(params["shared_attn"], "shared_attn"), x,
                       g)
        for i in range(tail):
            x = self._mamba_step(
                self._gather(_index(params["mamba_tail"], i), "mamba_tail"),
                x, _index(cache["mamba_tail"], i))
        return x

    def _xlstm_decode(self, params: Params, cache: Params, x: Tensor
                      ) -> Tensor:
        cfg = self.cfg
        groups, per = self._xlstm_layout()
        for g in range(groups):
            group = _index(params["mlstm_groups"], g)
            states = _index(cache["mlstm"], g)
            for i in range(per):
                bp = self._gather(_index(group, i), "mlstm_groups")
                m, _ = xlstm.mlstm_decode_step(
                    bp["mixer"], cfg,
                    layers.rmsnorm(bp["ln"], x, cfg.norm_eps),
                    _index(states, i))
                x = x + m
            sp = self._gather(_index(params["slstm"], g), "slstm")
            s, _ = xlstm.slstm_decode_step(
                sp["cell"], cfg, layers.rmsnorm(sp["ln"], x, cfg.norm_eps),
                _index(cache["slstm"], g))
            x = x + s
        return x


def _cross_entropy(logits: Tensor, targets: Tensor,
                   vocab: Optional[int] = None) -> Tensor:
    """Per-position cross-entropy ``logsumexp(logits) - logits[target]``,
    in f32.  Logits narrower than ``vocab`` are this rank's vocab shard:
    the max, the sum of exps and the target's logit are reduced over the
    model axis."""
    logits = logits.float()
    width = logits.shape[-1]
    if vocab is None or width == vocab:
        true = logits.gather(-1, targets.long()[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1) - true
    _, lo = split_offset(width, vocab)
    ctx = current_ctx()
    top = all_reduce(logits.detach().amax(dim=-1), MODEL, ctx,
                     op=dist.ReduceOp.MAX)
    local = targets.long() - lo
    inside = (local >= 0) & (local < width)
    true = logits.gather(-1, local.clamp(0, width - 1)[..., None])[..., 0]
    # one reduce of the stacked (sum of exps, target logit)
    sums = reduce_from_model(torch.stack(
        [torch.exp(logits - top[..., None]).sum(dim=-1),
         true * inside.float()]))
    return torch.log(sums[0]) + top - sums[1]


def _norm(params: Params, seq: bool) -> Params:
    """An RMSNorm's params for a block; under the ``"seq_sp"`` rule
    (``seq``) each rank reads them on its positions only, so they enter
    the model region (their gradient summed over its ranks)."""
    return params_to_model(params) if seq else params


def _dim_axes(spec, dim: int) -> Tuple[str, ...]:
    """The mesh axes a PartitionSpec splits dimension ``dim`` over (()
    where it leaves it whole, trailing Nones included)."""
    return spec_axes(P(spec[dim])) if dim < len(spec) else ()


def _place(axes: Dict, units: Dict, path: Tuple[str, ...],
           placement: Tuple[Dict, Dict], layers_: int) -> None:
    """Put a block's (axes, units) placement at ``path`` of the two trees,
    behind ``layers_`` stacked layer axes (None axes, units of 1)."""
    ax, un = placement
    for _ in range(layers_):
        ax = _stack_axes(ax)
        un = _stack_units(un)
    *head, last = path
    for k in head:
        axes, units = axes[k], units[k]
    axes[last], units[last] = ax, un


def _stack_units(units: Dict) -> Dict:
    """A leading layer axis (a unit of 1) on every leaf of a units tree."""
    return {k: _stack_units(v) if isinstance(v, dict) else (1,) + v
            for k, v in units.items()}


def _stack_axes(axes: Dict) -> Dict:
    """A leading layer axis (None: layers are never sharded) on every
    leaf of an axes tree."""
    return {k: _stack_axes(v) if isinstance(v, dict) else (None,) + v
            for k, v in axes.items()}


def _requires_grad(tree) -> bool:
    """Whether a tensor in ``tree`` (nested tuples, lists and dicts)
    requires grad."""
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_requires_grad(v) for v in tree)
    return False


def _stack(trees):
    """A list of like-shaped param dicts → one dict of stacked leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _stacked_zeros(tree, lead: Tuple[int, ...]):
    """Zeros shaped as each leaf of ``tree`` behind the ``lead`` axes."""
    if isinstance(tree, dict):
        return {k: _stacked_zeros(v, lead) for k, v in tree.items()}
    return tree.new_zeros(lead + tuple(tree.shape))


def _gathered(tree, plan):
    """``tree`` with each leaf that ``plan`` (:meth:`LM._fsdp_plan`'s tree,
    or a subtree of it) places gathered whole."""
    if plan is None:
        return tree
    if isinstance(tree, dict):
        return {k: _gathered(v, plan[k]) for k, v in tree.items()}
    dim, axes = plan
    return gather_from_data(tree, dim, axes)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def build_model(cfg: ModelConfig, device=None) -> LM:
    return LM(cfg, device=device)
