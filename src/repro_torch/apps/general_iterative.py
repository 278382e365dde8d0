"""General iterative form T_{i+1} = A·T_i + B (paper §5.3, Fig. 3g–h)."""

from __future__ import annotations

import numpy as np

from ..core.iterative import general_form as build_general_program
from .common import App


class GeneralIterative(App):
    def __init__(self, n: int, p: int, k: int = 16, model: str = "exp",
                 s: int = 4, with_b: bool = True, rank: int = 1,
                 force_rep=None, **kw):
        prog = build_general_program(k=k, n=n, p_dim=p, model=model, s=s,
                                     with_b=with_b)
        super().__init__(prog, "A", rank=rank, force_rep=force_rep, **kw)
        self.n, self.p, self.k, self.model = n, p, k, model
        self.with_b = with_b

    @staticmethod
    def synthesize(n: int, p: int, with_b: bool = True, seed: int = 0):
        """Random A (spectral radius about 0.9), T0 and B, as float32
        numpy."""
        rng = np.random.default_rng(seed)
        A = (rng.normal(size=(n, n)) * 0.9 / np.sqrt(n)).astype(np.float32)
        T0 = rng.normal(size=(n, p)).astype(np.float32)
        out = {"A": A, "T0": T0}
        if with_b:
            out["B"] = rng.normal(size=(n, p)).astype(np.float32)
        return out
