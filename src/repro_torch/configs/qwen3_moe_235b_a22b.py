"""qwen3-moe-235b-a22b — 128 routed experts, top-8.

[hf:Qwen/Qwen3-30B-A3B family; hf]  94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536 vocab=151936.
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,
    qkv_bias=False,
    mlp_gated=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        n_experts=128,
        top_k=8,
        n_shared_experts=0,
        expert_d_ff=1536,
        capacity_factor=1.25,
    ),
    source="hf:Qwen/Qwen3-235B-A22B",
)
