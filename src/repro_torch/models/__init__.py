"""The LM substrate of the port: layers, GQA attention on the flash
kernels, the MoE block, the Mamba2 (:mod:`.ssm`) and xLSTM (:mod:`.xlstm`)
blocks, the :class:`LM` of all six families, and the hand-over of the JAX
package's params (:func:`params_from_numpy`)."""

from . import ssm, xlstm
from .model import LM, build_model
from .weights import params_from_numpy

__all__ = ["LM", "build_model", "params_from_numpy", "ssm", "xlstm"]
