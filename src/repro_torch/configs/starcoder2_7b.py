"""starcoder2-7b — GQA + RoPE code model, non-gated GeLU MLP, biases.

[arXiv:2402.19173; hf]  32L d_model=4608 36H (GQA kv=4, head_dim 128)
d_ff=18432 vocab=49152.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    head_dim=128,
    qkv_bias=True,
    mlp_gated=False,
    rope_theta=1_000_000.0,
    source="arXiv:2402.19173",
)
