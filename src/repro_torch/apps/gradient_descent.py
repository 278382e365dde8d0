"""Batch gradient descent for linear regression (paper §7 "B≠0", Fig. 3h).

    Θ_{i+1} = Θ_i − η·Xᵀ(X·Θ_i − Y)  ≡  A·Θ_i + B,
    A := I − η·XᵀX   (view),   B := η·XᵀY   (view).

Updates to X hit *both* A and B; the compiler's simultaneous multi-view
delta propagation (Example 4.5) handles this in one trigger.
"""

from __future__ import annotations

import numpy as np

from ..core import Program, dim, identity, matmul, scale, sub, transpose
from ..core.iterative import append_general_iteration
from .common import App


def build_bgd_program(m: int, n: int, p: int, k: int = 16, eta: float = 1e-3,
                      model: str = "linear", s: int = 4) -> Program:
    prog = Program(name=f"bgd_{model}_k{k}")
    M, N, P_ = dim("m"), dim("n"), dim("p")
    X = prog.input("X", (M, N))
    Y = prog.input("Y", (M, P_))
    Theta0 = prog.input("Theta0", (N, P_))
    G = prog.let("G", matmul(transpose(X), X))           # XᵀX
    A = prog.let("A", sub(identity(N), scale(eta, G)))   # I − η·XᵀX
    B = prog.let("B", scale(eta, matmul(transpose(X), Y)))
    out = append_general_iteration(prog, A, B, Theta0, k, model, s)
    prog.outputs = [out]
    prog.bind_dims(m=m, n=n, p=p)
    return prog


class BatchGradientDescent(App):
    def __init__(self, m: int, n: int, p: int, k: int = 16, eta: float = 1e-3,
                 model: str = "linear", s: int = 4, rank: int = 1, **kw):
        super().__init__(build_bgd_program(m, n, p, k, eta, model, s),
                         "X", rank=rank, **kw)
        self.m, self.n, self.p, self.k, self.eta = m, n, p, k, eta

    @staticmethod
    def synthesize(m: int, n: int, p: int, eta: float = None, seed: int = 0):
        """A synthetic regression problem (X, Y) and Θ0 = 0, as float32
        numpy."""
        rng = np.random.default_rng(seed)
        X = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
        beta = rng.normal(size=(n, p)).astype(np.float32)
        Y = (X @ beta + 0.01 * rng.normal(size=(m, p))).astype(np.float32)
        Theta0 = np.zeros((n, p), dtype=np.float32)
        return {"X": X, "Y": Y, "Theta0": Theta0}

    def row_update(self, row: int, delta_row: np.ndarray):
        """One row of X changes by ``delta_row``."""
        u = np.zeros((self.m, 1), dtype=np.float32)
        u[row, 0] = 1.0
        v = np.asarray(delta_row, dtype=np.float32).reshape(self.n, 1)
        return u, v
