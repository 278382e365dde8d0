"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf]  24L d_model=2560 32H (GQA kv=8, head_dim 80)
d_ff=6912 vocab=32000, SWA window 4096.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    head_dim=80,
    mlp_gated=True,
    sliding_window=4096,
    source="arXiv:2401.16818",
)
