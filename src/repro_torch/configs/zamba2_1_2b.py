"""zamba2-1.2b — Mamba2 backbone + shared attention block.

[arXiv:2411.15242; hf]  38 Mamba2 layers, d_model=2048; one *shared*
transformer block (32H full attention + d_ff=8192 MLP) applied every 6
Mamba2 blocks with the same weights each time; ssm_state=64.
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    mlp_gated=True,
    attn_every=6,            # shared attn block cadence
    ssm=SSMConfig(state=64, headdim=64, expand=2, conv_kernel=4, chunk=128),
    source="arXiv:2411.15242",
)
