"""xlstm-350m — sLSTM + mLSTM blocks (xLSTM[7:1] pattern).

[arXiv:2405.04517; unverified]  24L d_model=1024 4H d_ff=0 vocab=50304.
Block pattern: 7 mLSTM blocks then 1 sLSTM block, repeated (24 = 3×8).
"""

from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    xlstm=XLSTMConfig(proj_factor=2.0, conv_kernel=4, mlstm_per_slstm=7,
                      chunk=128),
    source="arXiv:2405.04517",
)
