"""Ordinary Least Squares (paper §5.1, Examples 4.2/4.3, Fig. 3e).

``β* = (XᵀX)⁻¹ Xᵀ Y`` maintained under rank-1 (row) updates to X.
Incremental cost O(n² + mn) vs re-evaluation O(n^γ + mn²).
"""

from __future__ import annotations

import numpy as np

from ..core import Program, dim, inverse, matmul, transpose
from .common import App


def build_ols_program(m: int, n: int, p: int) -> Program:
    prog = Program(name=f"ols_m{m}_n{n}_p{p}")
    M, N, P = dim("m"), dim("n"), dim("p")
    X = prog.input("X", (M, N))
    Y = prog.input("Y", (M, P))
    Z = prog.let("Z", matmul(transpose(X), X))
    W = prog.let("W", inverse(Z))
    prog.let("beta", matmul(W, matmul(transpose(X), Y)))
    prog.outputs = ["beta"]
    prog.bind_dims(m=m, n=n, p=p)
    return prog


class OLS(App):
    def __init__(self, m: int, n: int, p: int = 1, rank: int = 1,
                 sequential_sm: bool = False, **kw):
        super().__init__(build_ols_program(m, n, p), "X", rank=rank,
                         sequential_sm=sequential_sm, **kw)
        self.m, self.n, self.p = m, n, p

    @staticmethod
    def synthesize(m: int, n: int, p: int = 1, seed: int = 0,
                   noise: float = 0.1):
        """Well-conditioned synthetic regression problem, as float32 numpy
        arrays (the engines copy them onto their device)."""
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(m, n)).astype(np.float32)
        beta_true = rng.normal(size=(n, p)).astype(np.float32)
        Y = X @ beta_true + noise * rng.normal(size=(m, p)).astype(np.float32)
        return {"X": X, "Y": Y.astype(np.float32)}, beta_true

    def row_update(self, row: int, delta_row: np.ndarray):
        """The paper's update pattern: one row of X changes."""
        u = np.zeros((self.m, 1), dtype=np.float32)
        u[row, 0] = 1.0
        v = np.asarray(delta_row, dtype=np.float32).reshape(self.n, 1)
        return u, v
