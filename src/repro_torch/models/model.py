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
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.runtime import resolve_device
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
        the block's inputs and recomputes the rest (JAX's policies differ
        in which products "block" and "attn" save; here every policy
        recomputes the whole block).  A call that autograd does not record
        (grad mode off, or no tensor argument requiring grad) runs ``fn``
        as it is."""
        if self.cfg.remat == "none":
            return fn

        def wrapped(*args):
            if torch.is_grad_enabled() and _requires_grad(args):
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        return wrapped

    def _layer(self, bp: Params, x: Tensor, positions: Tensor, causal: bool,
               prefix_len: int) -> Tuple[Tensor, Optional[Tensor]]:
        """One transformer block: attention, then :meth:`_block`."""
        a = attention.attention_block(
            bp["attn"], self.cfg,
            layers.rmsnorm(bp["ln1"], x, self.cfg.norm_eps), positions,
            causal=causal, prefix_len=prefix_len)
        return self._block(bp, x, a, return_aux=True)

    def _block(self, bp: Params, h: Tensor, attn_out: Tensor,
               return_aux: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
        """The residual tail of a block, after its attention output; with
        ``return_aux`` also the block's router loss (None without MoE)."""
        h = h + attn_out
        hn = layers.rmsnorm(bp["ln2"], h, self.cfg.norm_eps)
        aux = None
        if "moe" in bp:
            f = moe.moe_block(bp["moe"], self.cfg, hn, return_aux=return_aux)
            if return_aux:
                f, aux = f
            h = h + f
        elif "mlp" in bp:
            h = h + layers.mlp(bp["mlp"], hn, self.cfg.mlp_gated)
        return h, aux

    def backbone(self, params: Params, x: Tensor, positions: Tensor, *,
                 causal: bool = True, prefix_len: int = 0
                 ) -> Tuple[Tensor, Tensor]:
        """(B, S, D) → (B, S, D); returns (hidden, aux_loss: the blocks'
        router losses summed, 0 without MoE)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "hybrid":
            return self._zamba_backbone(params, x, positions, causal), aux
        if cfg.family == "ssm":
            return self._xlstm_backbone(params, x), aux
        layer = self._remat(self._layer)
        for bp in self._blocks(params):
            x, block_aux = layer(bp, x, positions, causal, prefix_len)
            if block_aux is not None:
                aux = aux + block_aux
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
        mamba, shared = self._remat(self._mamba), \
            self._remat(self._shared_part)
        for g in range(groups):
            group = _index(params["mamba_groups"], g)
            for i in range(cfg.attn_every):
                x = mamba(_index(group, i), x)
            # the weight-shared block, the same params each time (autograd
            # sums their gradients over the groups)
            x = shared(params["shared_attn"], x, positions, causal)
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
        mlstm, slstm = self._remat(self._mlstm), self._remat(self._slstm)
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
                params["frontend"], self._input(batch, "patches").to(
                    self.dtype))
            tok = self._embed_tokens(params, self._input(batch, "tokens"))
            x = torch.cat([patches, tok], dim=1)
            prefix = patches.shape[1]
        elif cfg.family == "audio":
            x = layers.frontend_proj(
                params["frontend"], self._input(batch, "frames").to(
                    self.dtype))
            prefix = 0
        else:
            x = layers.embed(params["embed"],
                             self._input(batch, "tokens").long())
            prefix = 0
        positions = torch.arange(x.shape[1], device=self.device)
        return x, positions, prefix

    def _embed_tokens(self, params: Params, tokens: Tensor) -> Tensor:
        """Token embeddings; a vlm's tied head scales them by sqrt(d_model)
        in the params' type (bf16: 45.25 at d_model 2048), as the
        reference's ``jnp.asarray(d ** 0.5, tok.dtype)`` does."""
        x = layers.embed(params["embed"], tokens.long())
        if self.cfg.family == "vlm" and self.cfg.tie_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def logits(self, params: Params, hidden: Tensor) -> Tensor:
        head = params["embed"] if self.cfg.tie_embeddings \
            else params["lm_head"]
        return layers.unembed(head, hidden)

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
        """Full-sequence forward → (logits (B, S, V) f32, aux_loss)."""
        h, aux = self._hidden(params, batch)
        return self.logits(params, h), aux

    # -- loss -------------------------------------------------------------------
    def loss(self, params: Params, batch: Dict
             ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The training objective → (total, {"ce", "aux"}): the mean
        next-token cross-entropy (a vlm's text positions only, after its
        ``n_patches`` image positions; audio: the cross-entropy of the
        frames' ``targets``, averaged over its ``mask``), plus the blocks'
        router loss."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch)
        if cfg.family == "audio":
            mask = self._input(batch, "mask").float()
            ce = _cross_entropy(logits, self._input(batch, "targets"))
            loss = (ce * mask).sum() / mask.sum().clamp_min(1.0)
        else:
            if cfg.family == "vlm":
                logits = logits[:, cfg.n_patches:]
            tokens = self._input(batch, "tokens")
            loss = _cross_entropy(logits[:, :-1], tokens[:, 1:]).mean()
        return loss + aux, {"ce": loss, "aux": aux}

    # -- decode ---------------------------------------------------------------
    def _check_decoder(self, what: str) -> None:
        """Raise for an encoder (audio), which has no ``what``: no cache,
        no prefill and no decode step."""
        if self.cfg.encoder_only:
            raise ValueError(f"{self.cfg.name} ({self.cfg.family}) is an "
                             f"encoder: it has no {what}")

    def init_cache(self, batch: int, max_seq: int) -> Params:
        """The zeroed decode cache, leaves stacked as the params are:

        - transformer families: {"kv": {"k", "v"}}, (n_layers, B, L, KV,
          hd);
        - hybrid: {"mamba": {"conv", "ssm"}} (G, attn_every, B, ...),
          {"kv"} (G, B, L, KV, hd), one cache for each application of the
          shared block, and {"mamba_tail"} (tail, B, ...) when there is a
          tail;
        - ssm: {"mlstm": {"conv", "s", "n", "m"}} (G, per, B, ...) and
          {"slstm": {"c", "n", "h", "m"}} (G, B, D).
        """
        self._check_decoder("decode cache")
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

    def prefill(self, params: Params, batch: Dict, max_seq: int
                ) -> Tuple[Tensor, Params]:
        """One full forward pass that also fills the decode cache
        (bidirectional over a vlm's image prefix).

        Returns (logits (B, S, V), cache ready for decode at pos = S).
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
        cache = self.init_cache(b, max_seq)
        kc, vc = cache["kv"]["k"], cache["kv"]["v"]
        cache_len = kc.shape[2]
        if cfg.sliding_window is not None and s > cache_len:
            raise NotImplementedError(
                "SWA ring-cache prefill beyond the window: decode the "
                "overflow stepwise")
        take = min(s, cache_len)
        for i, bp in enumerate(self._blocks(params)):
            a, (k, v) = attention.attention_block(
                bp["attn"], cfg, layers.rmsnorm(bp["ln1"], x, cfg.norm_eps),
                positions, causal=True, prefix_len=prefix, return_kv=True)
            # the rope'd K/V of the last `take` positions, from slot 0
            kc[i, :, :take] = k[:, s - take:]
            vc[i, :, :take] = v[:, s - take:]
            x, _ = self._block(bp, x, a)
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return self.logits(params, x), cache

    def decode_step(self, params: Params, cache: Params, token, pos: int
                    ) -> Tuple[Tensor, Params]:
        """One decode step. token (B, 1) ints; pos an int.  Writes the
        token's k/v and the recurrent states into ``cache`` in place, so
        its storage stays fixed from step to step.  Returns (logits
        (B, 1, V), cache).

        The position and the valid slot count go to the device once per
        step, in one int32 tensor, which every attention layer's rope and
        flash-decode kernel read there."""
        cfg = self.cfg
        self._check_decoder("decode step")
        x = self._embed_tokens(params, torch.as_tensor(token,
                                                       device=self.device))
        if cfg.family == "ssm":
            x = self._xlstm_decode(params, cache, x)
        else:
            kc, vc = cache["kv"]["k"], cache["kv"]["v"]
            pos = int(pos)
            slot, n_valid = attention.cache_slot(cfg, kc.shape[2], pos)
            step = torch.tensor([pos, n_valid], dtype=torch.int32,
                                device=self.device)

            def attend(bp, x, i):
                a, _ = attention.decode_attention(
                    bp["attn"], cfg,
                    layers.rmsnorm(bp["ln1"], x, cfg.norm_eps),
                    {"k": kc[i], "v": vc[i]}, slot, step[:1], step[1])
                return self._block(bp, x, a)[0]

            if cfg.family == "hybrid":
                x = self._zamba_decode(params, cache, x, attend)
            else:
                for i, bp in enumerate(self._blocks(params)):
                    x = attend(bp, x, i)
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
                x = self._mamba_step(_index(group, i), x,
                                     _index(states, i))
            x = attend(params["shared_attn"], x, g)
        for i in range(tail):
            x = self._mamba_step(_index(params["mamba_tail"], i), x,
                                 _index(cache["mamba_tail"], i))
        return x

    def _xlstm_decode(self, params: Params, cache: Params, x: Tensor
                      ) -> Tensor:
        cfg = self.cfg
        groups, per = self._xlstm_layout()
        for g in range(groups):
            group = _index(params["mlstm_groups"], g)
            states = _index(cache["mlstm"], g)
            for i in range(per):
                bp = _index(group, i)
                m, _ = xlstm.mlstm_decode_step(
                    bp["mixer"], cfg,
                    layers.rmsnorm(bp["ln"], x, cfg.norm_eps),
                    _index(states, i))
                x = x + m
            sp = _index(params["slstm"], g)
            s, _ = xlstm.slstm_decode_step(
                sp["cell"], cfg, layers.rmsnorm(sp["ln"], x, cfg.norm_eps),
                _index(cache["slstm"], g))
            x = x + s
        return x


def _cross_entropy(logits: Tensor, targets: Tensor) -> Tensor:
    """Per-position cross-entropy ``logsumexp(logits) - logits[target]``,
    in f32."""
    logits = logits.float()
    true = logits.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - true


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


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def build_model(cfg: ModelConfig, device=None) -> LM:
    return LM(cfg, device=device)
