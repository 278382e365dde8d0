"""Architecture registry: ``get_config("<arch-id>")`` for the 10 assigned
architectures.  Plain data, a copy of the JAX package's ``configs``; the
port's model runs the ``dense`` family (see ``repro_torch.models``)."""

from typing import Dict, List

from .base import ModelConfig, MoEConfig, SSMConfig, XLSTMConfig, ShapeConfig, \
    SHAPES, shape_applicable

from .qwen2_moe_a2_7b import CONFIG as _qwen2_moe
from .qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
from .zamba2_1_2b import CONFIG as _zamba2
from .xlstm_350m import CONFIG as _xlstm
from .paligemma_3b import CONFIG as _paligemma
from .command_r_plus_104b import CONFIG as _command_r
from .h2o_danube_1_8b import CONFIG as _danube
from .starcoder2_7b import CONFIG as _starcoder2
from .qwen1_5_32b import CONFIG as _qwen15_32b
from .hubert_xlarge import CONFIG as _hubert

ARCHS: Dict[str, ModelConfig] = {
    "qwen2-moe-a2.7b": _qwen2_moe,
    "qwen3-moe-235b-a22b": _qwen3_moe,
    "zamba2-1.2b": _zamba2,
    "xlstm-350m": _xlstm,
    "paligemma-3b": _paligemma,
    "command-r-plus-104b": _command_r,
    "h2o-danube-1.8b": _danube,
    "starcoder2-7b": _starcoder2,
    "qwen1.5-32b": _qwen15_32b,
    "hubert-xlarge": _hubert,
}


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")


def list_archs() -> List[str]:
    return sorted(ARCHS)


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "XLSTMConfig",
           "ShapeConfig", "SHAPES", "shape_applicable", "ARCHS",
           "get_config", "list_archs"]
