"""Cost model (paper §3, Table 2).

Counts FLOPs and bytes for symbolic expressions under a concrete dimension
binding.  Hash-consing makes the count CSE-aware: a shared subexpression is
priced once, the way the generated code evaluates it.

The paper states asymptotics with a matmul exponent γ (O(n^γ), §3); the
γ-form strings live only in the human-readable ``TABLE2`` report dict.
All decision-making FLOP counts fix γ = 3 — the classical 2·a·b·c — since
that is what BLAS/XLA executes (the paper makes the same practical
assumption).  See docs/cost_model.md for the function-by-function map to
the paper's cost expressions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from . import expr as ex
from .expr import Expr
from .factored import ColSlice, DenseDelta, HStack, LowRank


@dataclass(frozen=True)
class Cost:
    flops: float
    bytes_rw: float  # bytes read+written, 4 B/elt (f32 runtime)

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops, self.bytes_rw + other.bytes_rw)

    @staticmethod
    def zero() -> "Cost":
        return Cost(0.0, 0.0)


ELT = 4.0  # bytes per element


def _dim(d, binding: Dict[str, int]) -> int:
    if isinstance(d, ex.Dim):
        return binding[d.name]
    return int(d)


def shape_of(e: Expr, binding: Dict[str, int]) -> Tuple[int, int]:
    return (_dim(e.shape[0], binding), _dim(e.shape[1], binding))


def expr_cost(e: Expr, binding: Dict[str, int]) -> Cost:
    """CSE-aware cost of evaluating ``e`` once."""
    seen: Dict[int, Cost] = {}

    def go(x: Expr) -> Cost:
        if id(x) in seen:
            return Cost.zero()  # shared node: already priced
        sub = Cost.zero()
        for c in x.children:
            sub = sub + go(c)
        mine = _node_cost(x, binding)
        seen[id(x)] = mine
        return sub + mine

    return go(e)


def _node_cost(x: Expr, binding) -> Cost:
    if isinstance(x, ex.MatMul):
        a, b = shape_of(x.lhs, binding)
        b2, c = shape_of(x.rhs, binding)
        assert b == b2, (x, b, b2)
        return Cost(2.0 * a * b * c, ELT * (a * b + b * c + a * c))
    if isinstance(x, ex.Add):
        n, m = shape_of(x, binding)
        t = len(x.terms)
        return Cost((t - 1) * n * m, ELT * t * n * m)
    if isinstance(x, ex.Scale):
        n, m = shape_of(x, binding)
        return Cost(n * m, ELT * 2 * n * m)
    if isinstance(x, ex.Transpose):
        n, m = shape_of(x, binding)
        return Cost(0.0, ELT * 2 * n * m)
    if isinstance(x, ex.Inverse):
        n, _ = shape_of(x, binding)
        if n == 1:
            return Cost(1.0, ELT * 2)
        return Cost((2.0 / 3.0) * n ** 3 + 2.0 * n ** 2, ELT * 2 * n * n)
    if isinstance(x, HStack):
        n, m = shape_of(x, binding)
        return Cost(0.0, ELT * 2 * n * m)
    if isinstance(x, ColSlice):
        n, _ = shape_of(x, binding)
        return Cost(0.0, ELT * 2 * n)
    # leaves
    return Cost.zero()


def expr_cost_kinds(e: Expr, binding: Dict[str, int]) -> Dict[str, float]:
    """CSE-aware FLOPs of ``e`` bucketed by op kind: ``"matmul"``,
    ``"inverse"``, ``"other"``.

    Wall-clock per FLOP differs wildly between kinds — a BLAS3 matmul
    streams at machine peak while an n×n factorization (``Inverse``) and
    elementwise traffic run far below it — so a planner comparing
    trigger FLOPs against re-evaluation FLOPs needs per-kind scales, not
    one global fudge factor (see
    :attr:`repro.plan.WorkloadDescriptor.op_cost_scales`).
    """
    kinds = {"matmul": 0.0, "inverse": 0.0, "other": 0.0}
    seen: Dict[int, bool] = {}
    stack = [e]
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen[id(x)] = True
        stack.extend(x.children)
        flops = _node_cost(x, binding).flops
        if isinstance(x, ex.MatMul):
            kinds["matmul"] += flops
        elif isinstance(x, ex.Inverse):
            kinds["inverse"] += flops
        else:
            kinds["other"] += flops
    return kinds


def lowrank_cost(d: LowRank, binding: Dict[str, int]) -> Cost:
    """Cost of evaluating every factor block of a factored delta."""
    total = Cost.zero()
    seen: Dict[int, bool] = {}
    for blk in list(d.left) + list(d.right):
        # share the CSE cache across blocks
        total = total + _expr_cost_shared(blk, binding, seen)
    return total


def _expr_cost_shared(e: Expr, binding, seen: Dict[int, bool]) -> Cost:
    total = Cost.zero()
    stack = [e]
    order = []
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen[id(x)] = True
        order.append(x)
        stack.extend(x.children)
    for x in order:
        total = total + _node_cost(x, binding)
    return total


def apply_update_cost(view_shape: Tuple[int, int], rank: int) -> Cost:
    """Cost of ``M += U Vᵀ`` (the rank-k GER): 2·k·n·m FLOPs, M touched twice."""
    n, m = view_shape
    return Cost(2.0 * rank * n * m, ELT * (2 * n * m + rank * (n + m)))


def dense_delta_cost(d: DenseDelta, binding: Dict[str, int]) -> Cost:
    return expr_cost(d.value, binding)


# ---------------------------------------------------------------------------
# batched-trigger cost model (§6 batching + §4.2 avalanche containment)
# ---------------------------------------------------------------------------


def batched_apply_cost(view_shape: Tuple[int, int], rank: int,
                       batch: int) -> Cost:
    """Cost of applying a T-batch of rank-k updates in ONE pass over M.

    FLOPs match T sequential GERs (2·T·k·n·m) but M crosses memory once,
    not T times — the batched kernel's roofline win.  Compare against
    ``apply_update_cost`` called T times to see the T× byte saving.
    """
    n, m = view_shape
    return Cost(2.0 * batch * rank * n * m,
                ELT * (2 * n * m + batch * rank * (n + m)))


def recompress_cost(n: int, m: int, stacked_rank: int) -> Cost:
    """Thin-QR both stacked factors + SVD of the (K × K) core.

    O((n + m)·K² + K³) — independent of the maintained views, so it pays
    whenever it shaves enough rank off every subsequent view sweep.
    """
    K = stacked_rank
    flops = 2.0 * (n + m) * K * K + 22.0 * K ** 3  # QR×2 + SVD + recombine
    return Cost(flops, ELT * (2 * (n + m) * K + 4 * K * K))


def batched_strategy(view_shape: Tuple[int, int], stacked_rank: int,
                     compressed_rank: int, reeval_flops: float) -> str:
    """Pick how to refresh one view under a stacked rank-K batch delta.

    Returns one of:
      * ``"stacked"``     — fire the rank-K batched trigger as-is;
      * ``"recompress"``  — QR/SVD the factors down to ``compressed_rank``
                            first (wins once K outgrows the numerical
                            rank: compaction is view-size independent);
      * ``"reeval"``      — recompute the view from scratch (wins past the
                            crossover rank, the paper's §7 regime where
                            INCR loses to REEVAL).
    """
    n, m = view_shape
    stacked = batched_apply_cost(view_shape, stacked_rank, 1).flops
    comp = (recompress_cost(n, m, stacked_rank).flops
            + batched_apply_cost(view_shape, compressed_rank, 1).flops)
    best, best_cost = "stacked", stacked
    if comp < best_cost:
        best, best_cost = "recompress", comp
    if reeval_flops < best_cost:
        best = "reeval"
    return best


def batch_crossover_rank(view_shape: Tuple[int, int],
                         reeval_flops: float) -> int:
    """Stacked rank beyond which re-evaluating the view beats the trigger.

    Solves ``2·K·n·m ≥ reeval_flops`` for K — the §7 crossover where the
    incremental strategy stops winning and the engine should fall back.
    """
    n, m = view_shape
    return max(1, int(reeval_flops / (2.0 * n * m)))


# ---------------------------------------------------------------------------
# row-local (sparsity-aware) carrier costs
# ---------------------------------------------------------------------------


def rowlocal_apply_cost(view_shape: Tuple[int, int], rank: int,
                        rows: int) -> Cost:
    """Cost of the row-slab GER: ``M[rows] += B Vᵀ`` touching ``rows``
    of the n rows.  FLOPs and M-traffic both scale with the affected
    row count — the §3 "local change" priced as data instead of
    structure.  The right factor still crosses memory whole."""
    n, m = view_shape
    r = min(int(rows), n)
    return Cost(2.0 * rank * r * m, ELT * (2 * r * m + rank * (r + m)))


def rowlocal_crossover_fraction(view_shape: Tuple[int, int], rank: int,
                                efficiency: float = 0.5) -> float:
    """Affected fraction below which the row-slab sweep beats the dense
    rank-k sweep.

    The slab path's gather/scatter runs at a discount (``efficiency``,
    wall-clock per byte relative to the dense kernel's streaming reads
    — slab DMA is strided and the index plan costs host time), so the
    crossover solves ``traffic_slab(r) = efficiency · traffic_dense``
    for ``r/n`` rather than the trivial ``r < n``.  Engines default
    their ``rowlocal_fraction`` below this (0.25) — the model is used
    by the planner to decide *strategy*, the engine bound to decide
    *kernel*.
    """
    n, m = view_shape
    k = max(1, int(rank))
    dense = 2.0 * n * m + k * (n + m)
    r_star = (efficiency * dense - k * m) / (2.0 * m + k)
    return min(1.0, max(0.0, r_star / max(n, 1)))


# ---------------------------------------------------------------------------
# normal-equation solver costs (repro.fivm: models over the maintained ring)
# ---------------------------------------------------------------------------


def cholesky_factor_cost(n: int) -> Cost:
    """Factoring ``A = L Lᵀ`` from scratch: n³/3 FLOPs over an (n, n)
    SPD matrix (the re-solve path of a ridge/OLS model whose gram view
    the ring maintains)."""
    return Cost(float(n) ** 3 / 3.0, ELT * 2.0 * n * n)


def cholesky_update_cost(n: int, rank: int) -> Cost:
    """Rank-``rank`` Cholesky update/downdate: ``rank`` rank-1 passes at
    ~2n² FLOPs each (Givens sweep over the triangle) — the incremental
    re-solve path, priced against :func:`cholesky_factor_cost` exactly
    like the §7 trigger-vs-reeval crossover."""
    return Cost(2.0 * max(1, int(rank)) * float(n) * n,
                ELT * (max(1, int(rank)) + 1.0) * n * n)


def triangular_solve_cost(n: int, p: int) -> Cost:
    """Two triangular solves ``L Lᵀ B = C`` for an (n, p) right-hand
    side (paid identically by both re-solve strategies, so it cancels
    out of the crossover but belongs in absolute refresh pricing)."""
    return Cost(2.0 * float(n) * n * max(1, int(p)),
                ELT * (n * n + 2.0 * n * max(1, int(p))))


def solver_crossover_rank(n: int) -> int:
    """Accumulated factor-update rank past which re-factoring beats
    rank-1 update/downdate sweeps: solves ``2·K·n² ≥ n³/3`` for K —
    the §7 crossover restated for the solver's triangular factor."""
    return max(1, int(n / 6))


# ---------------------------------------------------------------------------
# asymptotic (Table 2) reports — used for docs/EXPERIMENTS, not decisions
# ---------------------------------------------------------------------------

TABLE2 = {
    # (family, strategy, model) -> human-readable complexity
    ("powers", "reeval", "linear"): "n^γ·k",
    ("powers", "reeval", "exp"): "n^γ·log k",
    ("powers", "reeval", "skip"): "n^γ·(log s + k/s)",
    ("powers", "incr", "linear"): "n²·k²",
    ("powers", "incr", "exp"): "n²·k",
    ("powers", "incr", "skip"): "n²·k²/s",
    ("general", "reeval", "linear"): "p·n²·k",
    ("general", "reeval", "exp"): "(n^γ + p·n²)·log k",
    ("general", "incr", "linear"): "(n² + p·n)·k²",
    ("general", "incr", "exp"): "(n² + p·n)·k",
    ("general", "hybrid", "linear"): "p·n²·k",
    ("general", "hybrid", "exp"): "p·n²·log k + n²·k",
    ("general", "hybrid", "skip"): "p·n²·(log s + k/s) + n²·s",
}
