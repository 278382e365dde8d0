"""paligemma-3b — SigLIP vision prefix + Gemma-2B decoder.

[arXiv:2407.07726; hf]  LM backbone: 18L d_model=2048 8H (MQA kv=1,
head_dim 256) d_ff=16384 (GeGLU) vocab=257216.  The SigLIP frontend is a
STUB: ``input_specs()`` provides precomputed patch embeddings
(batch, 256, 1152); a linear multimodal projector maps them to d_model.
Prefix-LM attention: bidirectional over the image prefix, causal after.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    mlp_gated=True,
    tie_embeddings=True,
    prefix_vision=True,
    n_patches=256,
    frontend_dim=1152,
    source="arXiv:2407.07726",
)
