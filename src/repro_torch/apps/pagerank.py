"""PageRank via the power method (paper §5.2/§5.3).

    r_{i+1} = α·M·r_i + (1−α)/n · 1

with M the column-stochastic transition matrix.  In LINVIEW form this is
the general iteration with ``A := α·M`` (a *view*, so edge updates to M
propagate through the Scale delta rule) and constant ``B``.

Edge updates: inserting/removing edges incident to one page changes one
column of M — a rank-1 update (paper §4.2's "one complete row or column").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core import Program, dim, scale
from ..core.iterative import append_general_iteration
from .common import App


def build_pagerank_program(n: int, k: int = 16, alpha: float = 0.85,
                           model: str = "linear", s: int = 4) -> Program:
    prog = Program(name=f"pagerank_{model}_k{k}")
    N, ONE = dim("n"), 1
    M = prog.input("M", (N, N))
    r0 = prog.input("r0", (N, ONE))
    e = prog.input("e", (N, ONE))       # (1−α)/n · 1 — static teleport vector
    A = prog.let("A", scale(alpha, M))
    out = append_general_iteration(prog, A, e, r0, k, model, s)
    prog.outputs = [out]
    prog.bind_dims(n=n, p=1)
    return prog


class PageRank(App):
    def __init__(self, n: int, k: int = 16, alpha: float = 0.85,
                 model: str = "linear", s: int = 4, rank: int = 1, **kw):
        super().__init__(build_pagerank_program(n, k, alpha, model, s),
                         "M", rank=rank, **kw)
        self.n, self.k, self.alpha = n, k, alpha

    @staticmethod
    def synthesize(n: int, alpha: float = 0.85, avg_degree: int = 8,
                   seed: int = 0):
        """Random graph → column-stochastic M, uniform r0, teleport e, as
        float32 numpy."""
        rng = np.random.default_rng(seed)
        adj = (rng.random((n, n)) < avg_degree / n).astype(np.float32)
        np.fill_diagonal(adj, 0.0)
        deg = adj.sum(axis=0)
        deg[deg == 0] = 1.0
        M = adj / deg  # column-stochastic
        r0 = np.full((n, 1), 1.0 / n, dtype=np.float32)
        e = np.full((n, 1), (1.0 - alpha) / n, dtype=np.float32)
        return {"M": M.astype(np.float32), "r0": r0, "e": e}

    def edge_update(self, page: int, new_column: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Replace the outlink column of ``page``: M[:,page] = new_column.

        Returns (u, v) with ΔM = u vᵀ, u = new_col − old_col, v = e_page.
        """
        old = self.engine.views["M"][:, page].cpu().numpy()
        u = (np.asarray(new_column, dtype=np.float32) - old).reshape(-1, 1)
        v = np.zeros((self.n, 1), dtype=np.float32)
        v[page, 0] = 1.0
        return u, v
