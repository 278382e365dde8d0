"""qwen1.5-32b — dense MHA (kv = heads) with QKV bias.

[hf:Qwen/Qwen1.5-32B; hf]  64L d_model=5120 40H (kv=40, head_dim 128)
d_ff=27392 vocab=152064.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    mlp_gated=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-32B",
)
