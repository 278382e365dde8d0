"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 MoE.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (GQA kv=16)
d_ff=1408 (routed expert) vocab=151936, shared expert hidden 4×1408=5632.
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    mlp_gated=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        n_shared_experts=4,
        expert_d_ff=1408,
        shared_d_ff=5632,
        capacity_factor=1.25,
    ),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
