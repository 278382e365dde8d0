"""LM assembly for the ``dense`` family (pre-norm transformer stack).

The counterpart of the JAX package's ``models/model.py`` :class:`LM` for
the dense family: embed, ``n_layers`` blocks of RMSNorm → attention →
residual → RMSNorm → MLP → residual, final RMSNorm, head.  Per-layer
parameters stay stacked along a leading layer axis, as in the reference,
so its params map over one to one (:mod:`.weights`).  The moe, ssm,
hybrid, vlm and audio families raise: ROADMAP.md Queue 1 item 13.

Every method is a pure function of the params it is given, except that
:meth:`LM.decode_step` writes the new token's k/v into the cache in place.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.runtime import resolve_device
from . import attention, layers

Params = Dict[str, Any]
Tensor = torch.Tensor

FAMILIES = ("dense",)


class LM:
    """Config-driven dense decoder on ``device`` (``None``: the card)."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
                "port runs the dense family (ROADMAP.md Queue 1 item 13)")
        self.cfg = cfg
        self.dtype = layers.DTYPES[cfg.dtype]
        self.device = resolve_device(device)

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Random params drawn from ``generator`` (on ``self.device``), at
        the reference's scales: N(0, 1/fan_in) weights, unit norms."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        p: Params = {"embed": layers.init_embedding(cfg.vocab, cfg.d_model,
                                                    dt, generator, dev),
                     "final_norm": layers.init_rmsnorm(cfg.d_model, dt, dev)}
        if not cfg.tie_embeddings:
            p["lm_head"] = layers.init_embedding(cfg.vocab, cfg.d_model, dt,
                                                 generator, dev)
        blocks = [self._init_block(generator) for _ in range(cfg.n_layers)]
        p["blocks"] = _stack(blocks)
        return p

    def _init_block(self, generator) -> Params:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        p = {"ln1": layers.init_rmsnorm(cfg.d_model, dt, dev),
             "attn": attention.init_attention(cfg, dt, generator, dev),
             "ln2": layers.init_rmsnorm(cfg.d_model, dt, dev)}
        if cfg.d_ff > 0:
            p["mlp"] = layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                                       dt, generator, dev)
        return p

    def _blocks(self, params: Params):
        """Layer i's params, as views into the stacked leaves."""
        for i in range(self.cfg.n_layers):
            yield _index(params["blocks"], i)

    # -- forward --------------------------------------------------------------
    def _block(self, bp: Params, h: Tensor, attn_out: Tensor) -> Tensor:
        """The residual tail of a block, after its attention output."""
        h = h + attn_out
        hn = layers.rmsnorm(bp["ln2"], h, self.cfg.norm_eps)
        if "mlp" in bp:
            h = h + layers.mlp(bp["mlp"], hn, self.cfg.mlp_gated)
        return h

    def backbone(self, params: Params, x: Tensor, positions: Tensor, *,
                 causal: bool = True, prefix_len: int = 0
                 ) -> Tuple[Tensor, Tensor]:
        """(B, S, D) → (B, S, D); returns (hidden, aux_loss = 0)."""
        cfg = self.cfg
        for bp in self._blocks(params):
            a = attention.attention_block(
                bp["attn"], cfg, layers.rmsnorm(bp["ln1"], x, cfg.norm_eps),
                positions, causal=causal, prefix_len=prefix_len)
            x = self._block(bp, x, a)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def embed_inputs(self, params: Params, batch: Dict
                     ) -> Tuple[Tensor, Tensor, int]:
        """Batch dict → (embeddings (B, S, D), positions (S,), prefix_len)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x = layers.embed(params["embed"], tokens)
        positions = torch.arange(x.shape[1], device=self.device)
        return x, positions, 0

    def logits(self, params: Params, hidden: Tensor) -> Tensor:
        head = params["embed"] if self.cfg.tie_embeddings \
            else params["lm_head"]
        return layers.unembed(head, hidden)

    def hidden(self, params: Params, batch: Dict) -> Tensor:
        """Final-norm hidden states (B, S, D): what the head reads."""
        cfg = self.cfg
        x, positions, prefix = self.embed_inputs(params, batch)
        h, _ = self.backbone(params, x, positions,
                             causal=not cfg.encoder_only, prefix_len=prefix)
        return layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)

    def forward(self, params: Params, batch: Dict) -> Tuple[Tensor, Tensor]:
        """Full-sequence forward → (logits (B, S, V) f32, aux_loss)."""
        h = self.hidden(params, batch)
        return self.logits(params, h), torch.zeros(
            (), dtype=torch.float32, device=h.device)

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> Params:
        """{"kv": {"k", "v"}} of shape (n_layers, B, L, KV, hd), zeroed."""
        one = attention.init_kv_cache(self.cfg, batch, max_seq, self.dtype,
                                      self.device)
        n = self.cfg.n_layers
        return {"kv": {name: x.new_zeros((n,) + tuple(x.shape))
                       for name, x in one.items()}}

    def prefill(self, params: Params, batch: Dict, max_seq: int
                ) -> Tuple[Tensor, Params]:
        """One full forward pass that also fills the decode cache.

        Returns (logits (B, S, V), cache ready for decode at pos = S).
        """
        cfg = self.cfg
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
            x = self._block(bp, x, a)
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return self.logits(params, x), cache

    def decode_step(self, params: Params, cache: Params, token, pos: int
                    ) -> Tuple[Tensor, Params]:
        """One decode step. token (B, 1) ints; pos an int.  Writes the
        token's k/v into ``cache`` in place.  Returns (logits (B, 1, V),
        cache).

        The position and the valid slot count go to the device once per
        step, in one int32 tensor, which every layer's rope and
        flash-decode kernel read there."""
        cfg = self.cfg
        tokens = torch.as_tensor(token, device=self.device).long()
        x = layers.embed(params["embed"], tokens)
        kc, vc = cache["kv"]["k"], cache["kv"]["v"]
        pos = int(pos)
        slot, n_valid = attention.cache_slot(cfg, kc.shape[2], pos)
        step = torch.tensor([pos, n_valid], dtype=torch.int32,
                            device=self.device)
        for i, bp in enumerate(self._blocks(params)):
            a, _ = attention.decode_attention(
                bp["attn"], cfg, layers.rmsnorm(bp["ln1"], x, cfg.norm_eps),
                {"k": kc[i], "v": vc[i]}, slot, step[:1], step[1])
            x = self._block(bp, x, a)
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return self.logits(params, x), cache


def _stack(trees):
    """A list of like-shaped param dicts → one dict of stacked leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def build_model(cfg: ModelConfig, device=None) -> LM:
    return LM(cfg, device=device)
