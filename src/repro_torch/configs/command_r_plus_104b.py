"""command-r-plus-104b — dense GQA giant, no biases, tied embeddings.

[hf:CohereForAI/c4ai-command-r-plus; unverified]  64L d_model=12288 96H
(GQA kv=8, head_dim 128) d_ff=33792 vocab=256000.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    head_dim=128,
    qkv_bias=False,
    mlp_gated=True,
    tie_embeddings=True,
    rope_theta=75_000_000.0,
    source="hf:CohereForAI/c4ai-command-r-plus",
)
