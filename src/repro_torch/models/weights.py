"""Hand-over of parameters from the JAX package's ``LM.init`` tree.

The port's :class:`~.model.LM` keeps the reference's param layout
(stacked per-layer leaves under ``blocks``), so a tree of numpy arrays
(``jax.tree.map(np.asarray, params)``) maps over leaf by leaf.  The tests
pass the same weights through both packages this way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.runtime import resolve_device


def _leaf(x, device, dtype) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: exact via f32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(a)
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def params_from_numpy(tree: Any, device=None, dtype=None) -> Any:
    """The nested dict ``tree`` with every array leaf as a torch tensor on
    ``device`` (``None``: the card), cast to ``dtype`` when given; None
    leaves (a compression state's raw leaves) stay None.  The optimizer's
    and the compression's states come over leaf by leaf too
    (``repro_torch.train.opt_state_from_numpy``,
    ``compression_state_from_numpy``)."""
    device = resolve_device(device)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return None if t is None else _leaf(t, device, dtype)

    return go(tree)
