"""The LM substrate of the port: layers, GQA attention on the flash
kernels, the MoE block, the :class:`LM` of the dense, moe, vlm and audio
families, and the hand-over of the JAX package's params
(:func:`params_from_numpy`)."""

from .model import LM, build_model
from .weights import params_from_numpy

__all__ = ["LM", "build_model", "params_from_numpy"]
