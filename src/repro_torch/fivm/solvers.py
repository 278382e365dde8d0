"""Solvers over the maintained ring (LINVIEW §5; F-IVM regression /
clustering).

The ring keeps ``G = XᵀX`` and ``XY = XᵀY`` exact under inserts and
deletes; a solver's job reduces to the normal-equation solve
``(G + λI)·B = XY``.  :class:`RidgeSolver` (λ=0 ⇒ OLS) caches the
Cholesky factor of ``G + λI`` and, on refresh, prices the two ways of
catching up with the ring's event log — ``k`` rank-one Cholesky
update/downdates (``2kn²``) versus refactoring from the maintained gram
(``n³/3``) — through :func:`repro_torch.plan.solver_resolve_strategy`, the §7
incremental-vs-reeval crossover transplanted to the solver layer
(crossing at ``k ≈ n/6``).  A downdate that breaks positive
definiteness (numerically drained direction after delete-heavy churn)
falls back to the refactor arm.

Fitted coefficients are pushed back through :meth:`Ring.set_model`, so
``grad = G·B − XY`` stays a *maintained view*: reading the gradient
after more data arrives costs a view read, not an ``O(M·n·p)``
recompute.

:class:`KMeansSolver` reads the same ring: live rows from the
maintained ``X``/``W`` input views, seeded deterministically (so the
incremental fit is bit-comparable to batch retrain on the same data),
Lloyd steps on the live set.

Everything here runs on the host in numpy (scipy where present), as in
the JAX package: a ridge refresh reads ``G`` (features²) and ``XY`` from
the ring once, and k-means only the live rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..core.cost import solver_crossover_rank  # noqa: F401 (re-export)
from .ring import Ring


# ---------------------------------------------------------------------------
# Cholesky rank-1 update / downdate
# ---------------------------------------------------------------------------


class DowndateError(RuntimeError):
    """A rank-1 downdate left ``G + λI`` numerically non-PD; the caller
    falls back to refactoring from the maintained gram."""


def chol_rank1_update(L: np.ndarray, x: np.ndarray,
                      sign: float = 1.0) -> np.ndarray:
    """In-place lower-Cholesky rank-1 update: ``LLᵀ ± xxᵀ`` (Golub &
    Van Loan §6.5.4; ``sign=−1`` is the downdate, the delete path).

    ``O(n²)`` with vectorized column tails — the per-event arm of the
    §7 solver crossover.  Raises :class:`DowndateError` when a downdate
    pivot goes non-positive instead of fabricating a factor.
    """
    L = np.asarray(L)
    x = np.asarray(x, dtype=L.dtype).reshape(-1).copy()
    n = L.shape[0]
    sign = float(sign)
    for k in range(n):
        Lkk = L[k, k]
        r2 = Lkk * Lkk + sign * x[k] * x[k]
        if r2 <= 0.0 or not np.isfinite(r2):
            raise DowndateError(
                f"pivot {k} went non-positive ({r2:.3e}) during "
                f"{'downdate' if sign < 0 else 'update'}")
        r = np.sqrt(r2)
        c, s = r / Lkk, x[k] / Lkk
        L[k, k] = r
        if k + 1 < n:
            tail = L[k + 1:, k]
            tail += sign * s * x[k + 1:]
            tail /= c
            x[k + 1:] = c * x[k + 1:] - s * tail
    return L


def _solve_from_chol(L: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    from scipy.linalg import solve_triangular  # type: ignore
    z = solve_triangular(L, rhs, lower=True)
    return solve_triangular(L.T, z, lower=False)


def _solve_from_chol_np(L: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    # numpy-only back-substitution (scipy is not a baked-in dep)
    n = L.shape[0]
    z = np.zeros_like(rhs)
    for i in range(n):
        z[i] = (rhs[i] - L[i, :i] @ z[:i]) / L[i, i]
    b = np.zeros_like(rhs)
    for i in range(n - 1, -1, -1):
        b[i] = (z[i] - L[i + 1:, i] @ b[i + 1:]) / L[i, i]
    return b


def solve_cholesky(L: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """``(LLᵀ)⁻¹ rhs`` by two triangular solves (scipy when present,
    pure numpy otherwise — the container may not ship scipy)."""
    try:
        return _solve_from_chol(L, rhs)
    except ImportError:
        return _solve_from_chol_np(L, rhs)


# ---------------------------------------------------------------------------
# batch (retrain-from-scratch) baselines — the bench/test oracles
# ---------------------------------------------------------------------------


def batch_ridge(X: np.ndarray, Y: np.ndarray, lam: float = 0.0
                ) -> np.ndarray:
    """Retrain-from-scratch: build ``XᵀX`` from the raw live rows,
    factor, solve.  ``O(M·n² + n³/3)`` — what the ring's maintained-G
    refresh is benchmarked against."""
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    n = X.shape[1]
    A = X.T @ X + float(lam) * np.eye(n)
    L = np.linalg.cholesky(A)
    return solve_cholesky(L, X.T @ Y).astype(np.float32)


def batch_kmeans(X: np.ndarray, k: int, *, iters: int = 10,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded Lloyd on a raw data matrix → ``(centroids, labels)``.
    Deterministic given ``(X, k, iters, seed)`` — the retrain oracle
    :meth:`KMeansSolver.fit` is compared against."""
    X = np.asarray(X, np.float64)
    m = X.shape[0]
    k = min(k, max(m, 1))
    rng = np.random.default_rng(seed)
    if m == 0:
        return np.zeros((0, X.shape[1]), np.float32), np.zeros(0, np.int32)
    centers = X[rng.choice(m, size=k, replace=False)].copy()
    labels = np.zeros(m, dtype=np.int64)
    for _ in range(max(1, iters)):
        d2 = ((X[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        labels = d2.argmin(1)
        for j in range(k):
            mask = labels == j
            if mask.any():
                centers[j] = X[mask].mean(0)
    return centers.astype(np.float32), labels.astype(np.int32)


# ---------------------------------------------------------------------------
# ridge / OLS over the ring
# ---------------------------------------------------------------------------


@dataclass
class SolverStats:
    refreshes: int = 0
    chol_updates: int = 0      # rank-1 update/downdates applied
    refactors: int = 0         # full n³/3 refactors
    downdate_fallbacks: int = 0
    strategy_log: List[str] = field(default_factory=list)


class RidgeSolver:
    """Ridge regression (λ=0 ⇒ OLS) as a consumer of one ring slot.

    ``coefficients()`` reads ``G``/``XY`` from the ring, catches the
    cached Cholesky factor up with the ring's event log (update vs
    refactor priced per refresh), solves, and pushes the result back
    through :meth:`Ring.set_model` — after which ``gradient()`` is a
    maintained-view read.
    """

    def __init__(self, ring: Ring, lam: float = 0.0,
                 slot: Optional[int] = None, *,
                 update_cost_scale: float = 1.0):
        self.ring = ring
        self.lam = float(lam)
        self.slot = ring.claim_slot() if slot is None else slot
        self.update_cost_scale = float(update_cost_scale)
        self.stats = SolverStats()
        self._L: Optional[np.ndarray] = None
        self._cursor = 0           # position in ring.event_log
        self._coef: Optional[np.ndarray] = None
        self._coef_version = -1

    # -- factor maintenance ------------------------------------------------

    def _refactor(self) -> None:
        n = self.ring.spec.features
        A = self.ring.gram().astype(np.float64) + self.lam * np.eye(n)
        self._L = np.linalg.cholesky(A)
        self._cursor = self.ring.log_version
        self.stats.refactors += 1

    def _catch_up(self) -> str:
        """Bring ``L`` up to the ring's log head; returns the strategy
        taken (``"update"`` / ``"refactor"`` / ``"fresh"``)."""
        from ..plan import solver_resolve_strategy
        n = self.ring.spec.features
        pending = self.ring.log_version - self._cursor
        if self._L is None:
            self._refactor()
            return "fresh"
        if pending == 0:
            return "update"
        strategy = solver_resolve_strategy(
            n, pending, cost_scale=self.update_cost_scale)
        if strategy == "refactor":
            self._refactor()
            return "refactor"
        try:
            for w, x in self.ring.event_log[self._cursor:]:
                chol_rank1_update(self._L, x.astype(np.float64), sign=w)
                self.stats.chol_updates += 1
            self._cursor = self.ring.log_version
        except DowndateError:
            # numerically drained pivot after churn: the maintained gram
            # is still exact — refactor from it
            self.stats.downdate_fallbacks += 1
            self._refactor()
            return "refactor"
        return "update"

    # -- solve -------------------------------------------------------------

    def coefficients(self, *, push: bool = True) -> np.ndarray:
        """The current model ``B = (G + λI)⁻¹·XY`` against everything
        the ring has absorbed.  With ``push`` (default) the result is
        written back to the ring slot so ``grad{slot}`` stays
        maintained."""
        version = self.ring.log_version
        if self._coef is not None and self._coef_version == version:
            return self._coef.copy()
        strategy = self._catch_up()
        self.stats.refreshes += 1
        self.stats.strategy_log.append(strategy)
        rhs = self.ring.xty().astype(np.float64)
        B = solve_cholesky(self._L, rhs).astype(np.float32)
        self._coef, self._coef_version = B, version
        if push:
            self.ring.set_model(self.slot, B)
        return B.copy()

    def gradient(self) -> np.ndarray:
        """``∇ = G·B − XY + λ·B`` via the maintained view (requires a
        prior ``coefficients()`` push for freshness of the B input)."""
        return self.ring.gradient(self.slot, self.lam)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, np.float32) @ self.coefficients(push=False)


class OLSSolver(RidgeSolver):
    """λ=0 ridge, named for the §5.1 workload."""

    def __init__(self, ring: Ring, slot: Optional[int] = None, **kw):
        super().__init__(ring, lam=0.0, slot=slot, **kw)


# ---------------------------------------------------------------------------
# k-means over the ring
# ---------------------------------------------------------------------------


class KMeansSolver:
    """Lloyd's k-means reading the ring's maintained ``X``/``W`` views.

    The assignment/centroid steps consume the *maintained* design
    matrix — exact under inserts and deletes because the row carriers
    are — so ``fit()`` after any churn equals
    :func:`batch_kmeans` on the surviving rows (same seed, same
    deterministic init), which is the property the tests pin.
    """

    def __init__(self, ring: Ring, k: int, *, iters: int = 10,
                 seed: int = 0):
        self.ring = ring
        self.k = int(k)
        self.iters = int(iters)
        self.seed = int(seed)
        self.centers: Optional[np.ndarray] = None
        self.inertia: float = float("nan")
        self.fits = 0

    def fit(self) -> np.ndarray:
        X_live, _ = self.ring.live_data()
        centers, labels = batch_kmeans(X_live, self.k, iters=self.iters,
                                       seed=self.seed)
        self.centers = centers
        if len(labels):
            d2 = ((X_live[:, None, :].astype(np.float64)
                   - centers[None, :, :]) ** 2).sum(-1)
            self.inertia = float(d2[np.arange(len(labels)), labels].sum())
        else:
            self.inertia = 0.0
        self.fits += 1
        return centers

    def assign(self, X: np.ndarray) -> np.ndarray:
        if self.centers is None:
            self.fit()
        d2 = ((np.asarray(X, np.float64)[:, None, :]
               - self.centers[None, :, :]) ** 2).sum(-1)
        return d2.argmin(1).astype(np.int32)
