"""Matrix powers A^k (paper §5.2, Fig. 3a–c, Tables 2–3)."""

from __future__ import annotations

import numpy as np

from ..core.iterative import matrix_powers as build_powers_program
from .common import App


class MatrixPowers(App):
    def __init__(self, n: int, k: int = 16, model: str = "exp", s: int = 4,
                 rank: int = 1, **kw):
        prog = build_powers_program(k=k, n=n, model=model, s=s)
        super().__init__(prog, "A", rank=rank, **kw)
        self.n, self.k, self.model = n, k, model

    @staticmethod
    def synthesize(n: int, seed: int = 0, spectral_scale: float = 0.9):
        """Random A scaled to spectral radius < 1 so powers stay bounded
        ('preconditioned appropriately for numerical stability', §7), as a
        float32 numpy array."""
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(n, n)).astype(np.float32)
        A *= spectral_scale / max(1e-6, float(np.max(np.abs(
            np.linalg.eigvals(A[:256, :256]))))) if n <= 256 else 1.0
        if n > 256:
            A *= spectral_scale / np.sqrt(n)  # circular law estimate
        return {"A": A}

    def row_update(self, row: int, delta_row: np.ndarray):
        u = np.zeros((self.n, 1), dtype=np.float32)
        u[row, 0] = 1.0
        v = np.asarray(delta_row, dtype=np.float32).reshape(self.n, 1)
        return u, v
