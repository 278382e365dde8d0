"""Sums of matrix powers S_k = I + A + … + A^{k-1} (paper §5.2.3, Fig. 3d)."""

from __future__ import annotations

import numpy as np

from ..core.iterative import sums_of_powers as build_sums_program
from .common import App


class SumsOfPowers(App):
    def __init__(self, n: int, k: int = 16, model: str = "exp", s: int = 4,
                 rank: int = 1, **kw):
        prog = build_sums_program(k=k, n=n, model=model, s=s)
        super().__init__(prog, "A", rank=rank, **kw)
        self.n, self.k, self.model = n, k, model

    @staticmethod
    def synthesize(n: int, seed: int = 0):
        """Random A with spectral radius about 0.9, as float32 numpy."""
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(n, n)).astype(np.float32)
        A *= 0.9 / np.sqrt(n)
        return {"A": A}
