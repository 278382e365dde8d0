"""Config system: model architecture + parallelism + run settings.

One ``<arch>.py`` per assigned architecture instantiates :class:`ModelConfig`
with the exact published numbers; ``reduced()`` derives the CPU smoke-test
variant (same family, tiny dims).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    expert_d_ff: int = 0          # routed expert hidden size
    shared_d_ff: int = 0          # shared expert hidden size (total)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    state: int = 64              # N: SSM state size
    headdim: int = 64            # P: channels per SSD head
    expand: int = 2              # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk: int = 128             # SSD chunk length


@dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0     # mLSTM up-projection
    conv_kernel: int = 4
    mlstm_per_slstm: int = 7     # block pattern [m×7, s]×…
    chunk: int = 128
    slstm_proj_factor: float = 1.333
    slstm_unroll: int = 1        # time-scan unroll (wgrad RMW batching)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    mlp_gated: bool = True                  # SwiGLU vs plain GeLU MLP
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None    # SWA (h2o-danube)
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    attn_every: int = 0                     # zamba2: shared attn cadence
    encoder_only: bool = False              # hubert
    prefix_vision: bool = False             # paligemma: image-prefix LM
    n_patches: int = 256                    # vlm stub: patches per image
    frontend_dim: int = 0                   # audio/vlm stub input dim
    max_seq: int = 32768
    dtype: str = "bfloat16"
    fsdp: bool = True                       # shard params over data axis too
    remat: str = "block"                    # none | block | full
    # citation / provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline."""
        d, v = self.d_model, self.vocab
        total = v * d  # embeddings
        if not self.tie_embeddings:
            total += v * d
        hd = self.resolved_head_dim
        for _ in range(self.n_layers):
            # attention (per layer, where applicable)
            if self.family not in ("ssm",):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o
            if self.moe:
                e = self.moe
                total += e.n_experts * (3 if self.mlp_gated else 2) * d * e.expert_d_ff
                total += d * e.n_experts  # router
                if e.n_shared_experts:
                    total += (3 if self.mlp_gated else 2) * d * e.shared_d_ff
            elif self.d_ff > 0:
                total += (3 if self.mlp_gated else 2) * d * self.d_ff
            if self.ssm and self.family in ("ssm", "hybrid"):
                di = self.ssm.expand * d
                total += d * 2 * di + di * d  # in/out projections
                total += di * 2 * self.ssm.state  # B, C projections (approx)
            total += 2 * d  # norms
        if self.xlstm:
            per = self.xlstm.mlstm_per_slstm
            groups = self.n_layers // (per + 1)
            di = int(self.xlstm.proj_factor * d)
            hd = di // self.n_heads
            mlstm = (2 * d * di                       # up_l, up_r
                     + self.xlstm.conv_kernel * di    # conv
                     + 3 * self.n_heads * hd * hd     # headwise q,k,v
                     + 2 * di * self.n_heads          # gates
                     + di * d)                        # down
            d_up = int(self.xlstm.slstm_proj_factor * d)
            hd_s = d // self.n_heads
            slstm = (4 * d * d + 4 * self.n_heads * hd_s * hd_s
                     + 2 * d * d_up + d_up * d)
            total += groups * (per * mlstm + slstm)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        e = self.moe
        per_expert = (3 if self.mlp_gated else 2) * d * e.expert_d_ff
        inactive = self.n_layers * (e.n_experts - e.top_k) * per_expert
        return self.param_count() - inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw: Dict = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else
                         max(2, self.attn_every + 1)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            d_ff=256 if self.d_ff > 0 else 0,
            vocab=512,
            head_dim=32,
            max_seq=256,
            dtype="float32",
            fsdp=False,
            remat="none",
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(2, self.moe.top_k),
                expert_d_ff=128,
                shared_d_ff=128 if self.moe.n_shared_experts else 0)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, state=16, headdim=32,
                                            chunk=32)
        if self.xlstm:
            kw["xlstm"] = dataclasses.replace(self.xlstm, chunk=32,
                                              mlstm_per_slstm=3)
            kw["n_layers"] = 4
        if self.attn_every:
            kw["attn_every"] = 2
            kw["n_layers"] = 5
        if self.prefix_vision:
            kw["n_patches"] = 16
            kw["frontend_dim"] = 128
        if self.frontend_dim and not self.prefix_vision:
            kw["frontend_dim"] = 128
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# assigned input shapes (same 4 for every LM arch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment skip rules (documented in DESIGN.md §6)."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")
                         or cfg.sliding_window is not None)
        if not sub_quadratic:
            return False, "pure full-attention arch: long_500k skipped"
    return True, ""
