"""hubert-xlarge — encoder-only audio transformer (w2v2 architecture).

[arXiv:2106.07447; unverified]  48L d_model=1280 16H (kv=16, head_dim 80)
d_ff=5120 vocab=504 (masked-prediction cluster codebook).  The conv
feature extractor is a STUB: ``input_specs()`` provides precomputed frame
embeddings (batch, frames, 512) that a linear feature projection maps to
d_model.  HuBERT's conv relative positional embedding is replaced by RoPE
(TPU adaptation, noted in DESIGN.md).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    qkv_bias=True,
    mlp_gated=False,
    encoder_only=True,
    frontend_dim=512,
    source="arXiv:2106.07447",
)
