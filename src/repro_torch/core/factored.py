"""Factored delta representation (paper §4.2, §4.3).

A delta matrix is maintained as a sum of outer products of *blocks*,
``ΔM = Σ_i  L_i · R_iᵀ`` where each ``L_i`` is ``(n × k_i)`` and each
``R_i`` is ``(m × k_i)``.  Equivalently ``ΔM = P Qᵀ`` for the horizontal
stacks ``P = [L_1 … L_b]``, ``Q = [R_1 … R_b]`` — the paper's block-matrix
form.  Ranks ``k_i`` are static Python ints, so every staged computation
has static shapes.

``DenseDelta`` is the paper's *hybrid* representation (§5.3): the delta is
kept as a single (possibly full-rank) matrix expression.  The cost model
decides which representation each statement uses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import expr as ex
from .expr import Expr, Shape


def _block_rank(e: Expr) -> int:
    k = e.shape[1]
    if not isinstance(k, int):
        raise ex.ShapeError(f"factored block must have static rank, got {e.shape}")
    return k


@dataclass(frozen=True)
class LowRank:
    """Factored delta ``Σ_i left[i] @ right[i].T`` (rank = Σ_i k_i)."""

    left: Tuple[Expr, ...]
    right: Tuple[Expr, ...]

    def __post_init__(self):
        assert len(self.left) == len(self.right)
        for l, r in zip(self.left, self.right):
            if _block_rank(l) != _block_rank(r):
                raise ex.ShapeError(
                    f"block rank mismatch: {l.shape} vs {r.shape}")

    @property
    def rank(self) -> int:
        return sum(_block_rank(l) for l in self.left)

    @property
    def shape(self) -> Shape:
        if not self.left:
            raise ValueError("rank-0 delta has no shape; use LowRank.zero_like")
        return (self.left[0].shape[0], self.right[0].shape[0])

    def is_zero(self) -> bool:
        return not self.left

    def transpose(self) -> "LowRank":
        return LowRank(self.right, self.left)

    def scale(self, factor) -> "LowRank":
        return LowRank(tuple(ex.scale(factor, l) for l in self.left), self.right)

    def to_expr(self) -> Expr:
        """The dense expression ``Σ L_i R_iᵀ`` (used by the hybrid path)."""
        if self.is_zero():
            raise ValueError("rank-0 delta")
        return ex.add(*[ex.matmul(l, ex.transpose(r)) for l, r in
                        zip(self.left, self.right)])

    @staticmethod
    def zero() -> "LowRank":
        return LowRank((), ())

    @staticmethod
    def outer(u: Expr, v: Expr) -> "LowRank":
        """Single-block factored delta ``u vᵀ``."""
        return LowRank((u,), (v,))


@dataclass(frozen=True)
class DenseDelta:
    """Hybrid representation: the delta as one matrix expression."""

    value: Expr

    @property
    def shape(self) -> Shape:
        return self.value.shape

    def is_zero(self) -> bool:
        return self.value.is_zero()

    def transpose(self) -> "DenseDelta":
        return DenseDelta(ex.transpose(self.value))

    def scale(self, factor) -> "DenseDelta":
        return DenseDelta(ex.scale(factor, self.value))


DeltaRep = Union[LowRank, DenseDelta]


def combine_blocks(blocks: Sequence[Tuple[Expr, Expr]]) -> LowRank:
    """Common-factor extraction (§4.3).

    Given monomial outer products ``Σ l_i r_iᵀ``, group terms that share a
    right block and sum their left sides (then symmetrically group by left
    block).  With the hash-consed IR, "shares a factor" is pointer equality.
    This is the syntactic factoring the paper uses: it does not guarantee
    minimal rank (that would need value inspection) but reproduces the
    paper's 2×-per-squaring growth instead of 3×.
    """
    # group by right factor
    by_right: Dict[int, Tuple[Expr, List[Expr]]] = {}
    order: List[int] = []
    for l, r in blocks:
        key = id(r)
        if key not in by_right:
            by_right[key] = (r, [])
            order.append(key)
        by_right[key][1].append(l)
    stage1: List[Tuple[Expr, Expr]] = []
    for key in order:
        r, ls = by_right[key]
        stage1.append((ex.add(*ls) if len(ls) > 1 else ls[0], r))
    # group by left factor
    by_left: Dict[int, Tuple[Expr, List[Expr]]] = {}
    order = []
    for l, r in stage1:
        key = id(l)
        if key not in by_left:
            by_left[key] = (l, [])
            order.append(key)
        by_left[key][1].append(r)
    left: List[Expr] = []
    right: List[Expr] = []
    for key in order:
        l, rs = by_left[key]
        left.append(l)
        right.append(ex.add(*rs) if len(rs) > 1 else rs[0])
    return LowRank(tuple(left), tuple(right))


def lowrank_matmul(d1: LowRank, e1: Expr, d2: LowRank, e2: Expr) -> LowRank:
    """Product rule for factored deltas (§4.1 + §4.3 factoring):

    ``Δ(E1·E2) = ΔE1·E2 + E1·ΔE2 + ΔE1·ΔE2`` with ``ΔE1 = P1 Q1ᵀ``,
    ``ΔE2 = P2 Q2ᵀ`` becomes, grouped by common factors,

        left  = [P1,  E1·P2 + P1·(Q1ᵀ P2)]
        right = [E2ᵀ·Q1,  Q2]

    which is exactly the paper's Example 4.6 shape: rank k1 + k2, every new
    product is (big × skinny) or (skinny × skinny) — O(k n²) work.
    """
    blocks: List[Tuple[Expr, Expr]] = []
    # (ΔE1) E2  →  P1 (E2ᵀ Q1)ᵀ
    for l, r in zip(d1.left, d1.right):
        blocks.append((l, ex.matmul(ex.transpose(e2), r)))
    # E1 (ΔE2)  →  (E1 P2) Q2ᵀ
    for l, r in zip(d2.left, d2.right):
        blocks.append((ex.matmul(e1, l), r))
    # (ΔE1)(ΔE2)  →  (P1 (Q1ᵀ P2)) Q2ᵀ   — k×k inner products stay tiny
    for l1, r1 in zip(d1.left, d1.right):
        for l2, r2 in zip(d2.left, d2.right):
            blocks.append((ex.matmul(l1, ex.matmul(ex.transpose(r1), l2)), r2))
    return combine_blocks(blocks)


def lowrank_add(*deltas: LowRank) -> LowRank:
    blocks: List[Tuple[Expr, Expr]] = []
    for d in deltas:
        blocks.extend(zip(d.left, d.right))
    return combine_blocks(blocks)


def lowrank_inverse_woodbury(view: Expr, d: LowRank,
                             sequential: bool = False) -> LowRank:
    """Incremental inverse under a factored update (Sherman–Morrison /
    Woodbury, §4.1).

    For ``W = E⁻¹`` (materialized, pre-update) and ``ΔE = P Qᵀ`` (rank k):

        Δ(E⁻¹) = −W P (I_k + Qᵀ W P)⁻¹ Qᵀ W
                = L Rᵀ,   L = −W P (I_k + Qᵀ W P)⁻¹,  R = Wᵀ Q

    The only inversion is k×k.  With ``sequential=True`` the paper-faithful
    Example 4.3 path is produced instead: k successive rank-1
    Sherman–Morrison applications (same result, more statements).
    """
    if d.is_zero():
        return LowRank.zero()
    if sequential:
        return _sherman_morrison_chain(view, d)
    # stack blocks: P = [L_1 … L_b]  — symbolically a single block if b == 1,
    # otherwise we keep per-block structure by concatenating via hstack expr.
    P = _hstack(d.left)
    Q = _hstack(d.right)
    k = sum(_block_rank(l) for l in d.left)
    WP = ex.matmul(view, P)
    cap = ex.add(ex.identity(k), ex.matmul(ex.transpose(Q), WP))  # k×k
    L = ex.scale(-1.0, ex.matmul(WP, ex.inverse(cap)))
    R = ex.matmul(ex.transpose(view), Q)
    return LowRank((L,), (R,))


def _sherman_morrison_chain(view: Expr, d: LowRank) -> LowRank:
    """Example 4.3: apply rank-1 Sherman–Morrison per outer product in turn.

    Each step must use the *current* inverse ``W + Σ previous deltas``; the
    deltas are themselves rank-1 so the chain stays factored.  Blocks of
    rank > 1 are split into rank-1 column slices first.
    """
    ones: List[Tuple[Expr, Expr]] = []
    for l, r in zip(d.left, d.right):
        k = _block_rank(l)
        if k == 1:
            ones.append((l, r))
        else:
            for j in range(k):
                ones.append((ColSlice.make(l, j), ColSlice.make(r, j)))
    d = LowRank(tuple(l for l, _ in ones), tuple(r for _, r in ones))
    out_blocks: List[Tuple[Expr, Expr]] = []

    def current_apply(x: Expr) -> Expr:
        """(W + Σ l_j r_jᵀ) · x  evaluated factored."""
        terms = [ex.matmul(view, x)]
        for l, r in out_blocks:
            terms.append(ex.matmul(l, ex.matmul(ex.transpose(r), x)))
        return ex.add(*terms)

    def current_apply_t(x: Expr) -> Expr:
        """(W + Σ l_j r_jᵀ)ᵀ · x."""
        terms = [ex.matmul(ex.transpose(view), x)]
        for l, r in out_blocks:
            terms.append(ex.matmul(r, ex.matmul(ex.transpose(l), x)))
        return ex.add(*terms)

    for u, v in zip(d.left, d.right):
        if _block_rank(u) != 1:
            raise ValueError("sequential Sherman–Morrison needs rank-1 blocks")
        Wu = current_apply(u)                      # n×1
        Wtv = current_apply_t(v)                   # n×1
        denom = ex.add(ex.const(1.0), ex.matmul(ex.transpose(v), Wu))  # 1×1
        L = ex.scale(-1.0, ex.matmul(Wu, ex.inverse(denom)))
        out_blocks.append((L, Wtv))
    return LowRank(tuple(l for l, _ in out_blocks),
                   tuple(r for _, r in out_blocks))


def _hstack(blocks: Sequence[Expr]) -> Expr:
    if len(blocks) == 1:
        return blocks[0]
    return HStack.make(tuple(blocks))


@dataclass(frozen=True, eq=False)
class ColSlice(Expr):
    """Column ``j`` of a block, as an (n, 1) matrix."""

    operand: Expr
    col: int

    @staticmethod
    def make(operand: Expr, col: int) -> "ColSlice":
        node = ColSlice(operand, col)
        object.__setattr__(node, "shape", (operand.shape[0], 1))
        object.__setattr__(node, "children", (operand,))
        return node

    def __repr__(self) -> str:
        return f"{self.operand!r}[:,{self.col}]"


@dataclass(frozen=True, eq=False)
class HStack(Expr):
    """Horizontal concatenation of column blocks — the paper's block matrix.

    Introduced only where a genuinely stacked operand is needed (Woodbury
    capacitance); everywhere else blocks stay separate to avoid copies.
    """

    blocks: Tuple[Expr, ...]

    @staticmethod
    def make(blocks: Tuple[Expr, ...]) -> "HStack":
        n = blocks[0].shape[0]
        k = 0
        for b in blocks:
            if b.shape[0] != n:
                raise ex.ShapeError("hstack row mismatch")
            k += _block_rank(b)
        node = HStack(blocks)
        object.__setattr__(node, "shape", (n, k))
        object.__setattr__(node, "children", tuple(blocks))
        return node

    def __repr__(self) -> str:
        return "[" + " ".join(map(repr, self.blocks)) + "]"


# ---------------------------------------------------------------------------
# batched update streams (§4.2 avalanche containment across the batch dim)
# ---------------------------------------------------------------------------
#
# A stream of T factored updates {(U_t, V_t)} to one input is itself a
# factored delta with stacked blocks  P = [U_1 … U_T],  Q = [V_1 … V_T]:
#
#     Σ_t U_t V_tᵀ  =  P Qᵀ,      rank ≤ Σ_t k_t.
#
# The helpers below are *numeric*: they run at batch-flush time, on the
# engine's device, so the resulting rank is a Python int the compiler can
# bucket triggers by.


def to_f32(x, device, copy: bool = False) -> torch.Tensor:
    """``x`` (numpy, list, scalar or tensor) as a float32 tensor on
    ``device``.  ``copy=True`` guarantees fresh storage even where the
    conversion alone would share the caller's memory (a CPU tensor, or a
    numpy array viewed by ``torch.from_numpy``)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32, copy=copy)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def stack_update_arrays(updates: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                        device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack T factored updates ``[(u_t, v_t)]`` into ``(P, Q)``.

    Each ``u_t`` is (n, k_t), ``v_t`` is (m, k_t), as numpy arrays or
    tensors; 1-D vectors are treated as rank-1 columns.  Returns float32
    ``P: (n, K)``, ``Q: (m, K)`` on ``device`` with ``K = Σ_t k_t``.
    """
    if not updates:
        raise ValueError("empty update batch")
    us, vs = [], []
    for u, v in updates:
        u = to_f32(u, device)
        v = to_f32(v, device)
        if u.dim() == 1:
            u = u[:, None]
        if v.dim() == 1:
            v = v[:, None]
        if u.shape[1] != v.shape[1]:
            raise ex.ShapeError(f"update rank mismatch: {tuple(u.shape)} vs "
                                f"{tuple(v.shape)}")
        us.append(u)
        vs.append(v)
    return torch.cat(us, dim=1), torch.cat(vs, dim=1)


def recompress_factors(P: torch.Tensor, Q: torch.Tensor,
                       max_rank: Optional[int] = None,
                       tol: float = 1e-7
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-compress a stacked factored delta ``P Qᵀ`` to minimal rank.

    The paper's §4.2 avalanche containment applied across the batch
    dimension: repeated stacking grows K = Σ k_t without bound, but the
    *numerical* rank is often far smaller (e.g. Zipf-skewed row updates
    that keep hitting the same rows).  Thin-QR both factors, SVD the small
    (K × K) core, and truncate:

        P = Q_p R_p,  Q = Q_q R_q,  R_p R_qᵀ = U Σ Vᵀ
        P' = Q_p U_r Σ_r,   Q' = Q_q V_r        (rank r ≤ K)

    Cost O((n + m) K² + K³) — independent of the view sizes the trigger
    will touch, which is what makes compaction pay before a rank-K
    trigger fires.  Singular values below ``tol · σ_max`` are dropped;
    ``max_rank`` caps the result (lossy beyond the numerical rank).
    Runs on the factors' device through ``torch.linalg``.
    """
    P = P.to(torch.float32)
    Q = Q.to(torch.float32)
    K = P.shape[1]
    if K != Q.shape[1]:
        raise ex.ShapeError(f"factor rank mismatch: {tuple(P.shape)} vs "
                            f"{tuple(Q.shape)}")
    qp, rp = torch.linalg.qr(P)        # (n, K), (K, K)
    qq, rq = torch.linalg.qr(Q)        # (m, K), (K, K)
    uc, s, vct = torch.linalg.svd(rp @ rq.T)
    s_max = float(s[0]) if s.numel() else 0.0
    r = max(1, int((s > tol * s_max).sum()))
    if max_rank is not None:
        r = min(r, max_rank)
    P2 = qp @ (uc[:, :r] * s[:r])      # (n, r)
    Q2 = qq @ vct[:r].T                # (m, r)
    return P2.contiguous(), Q2.contiguous()


def pad_factors_to_rank(P: torch.Tensor, Q: torch.Tensor, rank: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad stacked factors (n, K) → (n, rank) for a static bucket.

    Exact: zero columns contribute nothing to ``P Qᵀ``, and every trigger
    delta rule is well-defined under them (the Woodbury capacitance gains
    identity rows/cols, the Sherman–Morrison denominators become 1).
    """
    K = P.shape[1]
    if K > rank:
        raise ValueError(f"cannot pad rank {K} down to {rank}")
    if K == rank:
        return P, Q
    return F.pad(P, (0, rank - K)), F.pad(Q, (0, rank - K))


# ---------------------------------------------------------------------------
# runtime delta carriers (sparsity-aware containment, §3–§5)
# ---------------------------------------------------------------------------
#
# A carrier describes one concrete update at run time:
#
#   * ``LowRankCarrier``  — dense-shaped ``P Qᵀ`` factors (the raw pair);
#   * ``RowLocalCarrier`` — an affected-row index set plus the compact
#     row block: ``ΔA = scatter(rows, B) Vᵀ`` touches only ``r`` of
#     ``n`` rows.  Row support is preserved by exactly the §4 closure the
#     compiler proves per view (``delta.row_support_preserved``); views
#     outside it widen the carrier to ``LowRankCarrier`` via
#     :meth:`~DeltaCarrier.factors`.
#   * ``NoOpCarrier``     — a delta known to change nothing; the engine
#     skips its firing.
#
# Carriers are host-side numpy values: ranks and row counts stay Python
# ints, so triggers bucket exactly as for raw pairs.  The engine uploads
# a carrier's factors to its device only when it fires.


class DeltaCarrier:
    """One concrete factored update ``ΔA`` to an engine input."""

    kind: str = "abstract"

    @property
    def rank(self) -> int:
        raise NotImplementedError

    @property
    def nm(self) -> Tuple[int, int]:
        """The (n, m) shape of the carried delta."""
        raise NotImplementedError

    def factors(self, device=None):
        """Widen to dense-shaped ``(P, Q)`` float32 factors (the oracle
        representation every carrier must agree with exactly): numpy
        arrays, or float32 tensors on ``device`` when one is given, with
        the same values bit for bit."""
        raise NotImplementedError

    def affected_fraction(self) -> float:
        """Fraction of rows the delta can touch (1.0 unless contained)."""
        return 1.0

    def norm_bound(self) -> float:
        """Upper bound on ``‖ΔA‖_F`` (``‖P‖_F · ‖Q‖_F``)."""
        raise NotImplementedError

    def is_noop(self, tol: float = 0.0) -> bool:
        """Whether applying this delta is guaranteed to move no view by
        more than ``tol`` (in delta Frobenius norm)."""
        return self.norm_bound() <= tol

    def negate(self) -> "DeltaCarrier":
        """The downdate ``-ΔA``."""
        P, Q = self.factors()
        return LowRankCarrier(np.negative(P), Q)


def _as_f32_factor(a, name: str) -> np.ndarray:
    a = np.asarray(a, dtype=np.float32)
    if a.ndim == 1:
        a = a[:, None]
    if a.ndim != 2:
        raise ex.ShapeError(f"{name} must be 2-D, got shape {a.shape}")
    return a


@dataclass(frozen=True)
class LowRankCarrier(DeltaCarrier):
    """Dense-shaped factored delta ``ΔA = P Qᵀ`` — the classic carrier."""

    P: np.ndarray   # (n, k)
    Q: np.ndarray   # (m, k)

    kind = "low_rank"

    @property
    def rank(self) -> int:
        return int(self.P.shape[1])

    @property
    def nm(self) -> Tuple[int, int]:
        return int(self.P.shape[0]), int(self.Q.shape[0])

    def factors(self, device=None):
        if device is None:
            return self.P, self.Q
        return to_f32(self.P, device), to_f32(self.Q, device)

    def norm_bound(self) -> float:
        return float(np.linalg.norm(self.P)) * float(np.linalg.norm(self.Q))

    def negate(self) -> "LowRankCarrier":
        return LowRankCarrier(np.negative(self.P), self.Q)


@dataclass(frozen=True)
class RowLocalCarrier(DeltaCarrier):
    """Row-contained factored delta: ``ΔA = scatter_n(rows, block) @ Vᵀ``.

    ``rows`` is the sorted, duplicate-free affected-row index set
    (``r`` entries), ``block`` the compact ``(r, k)`` left factor whose
    i-th row lands on row ``rows[i]``, and ``V`` the dense ``(m, k)``
    right factor.
    """

    rows: np.ndarray    # (r,) int32, sorted unique, all < n
    block: np.ndarray   # (r, k) float32
    V: np.ndarray       # (m, k) float32
    n: int              # full row dimension of the carried delta

    kind = "row_local"

    def __post_init__(self):
        if self.rows.ndim != 1 or self.block.ndim != 2 or self.V.ndim != 2:
            raise ex.ShapeError(
                f"row-local carrier dims: rows {self.rows.shape}, "
                f"block {self.block.shape}, V {self.V.shape}")
        if self.block.shape[0] != self.rows.shape[0]:
            raise ex.ShapeError(
                f"block rows {self.block.shape[0]} != affected rows "
                f"{self.rows.shape[0]}")
        if self.block.shape[1] != self.V.shape[1]:
            raise ex.ShapeError(
                f"carrier rank mismatch: block {self.block.shape} vs "
                f"V {self.V.shape}")

    @property
    def rank(self) -> int:
        return int(self.block.shape[1])

    @property
    def rows_touched(self) -> int:
        return int(self.rows.shape[0])

    @property
    def nm(self) -> Tuple[int, int]:
        return int(self.n), int(self.V.shape[0])

    def affected_fraction(self) -> float:
        return self.rows_touched / max(int(self.n), 1)

    def factors(self, device=None):
        """Widen: scatter the compact block into a dense-shaped P.  On a
        ``device`` P is made there (zeros and an index write), not on the
        host and uploaded: at 2²⁰ rows that is 4 MB a rank."""
        if device is None:
            P = np.zeros((int(self.n), self.rank), dtype=np.float32)
            P[self.rows] = self.block
            return P, self.V
        P = torch.zeros((int(self.n), self.rank), dtype=torch.float32,
                        device=device)
        P[torch.as_tensor(self.rows, dtype=torch.long,
                          device=device)] = to_f32(self.block, device)
        return P, to_f32(self.V, device)

    def norm_bound(self) -> float:
        return (float(np.linalg.norm(self.block))
                * float(np.linalg.norm(self.V)))

    def scale(self, factor: float) -> "RowLocalCarrier":
        """Scalar scale preserves row support exactly (§4 closure)."""
        return RowLocalCarrier(self.rows, self.block * float(factor),
                               self.V, self.n)

    def matmul_right(self, W: np.ndarray) -> "RowLocalCarrier":
        """``ΔA @ W`` preserves row support: only V changes."""
        W = np.asarray(W, dtype=np.float32)
        return RowLocalCarrier(self.rows, self.block, W.T @ self.V, self.n)

    def negate(self) -> "RowLocalCarrier":
        """Negation preserves row support."""
        return RowLocalCarrier(self.rows, np.negative(self.block),
                               self.V, self.n)


@dataclass(frozen=True)
class NoOpCarrier(DeltaCarrier):
    """A delta known (to tolerance) to change nothing — skips firing."""

    n: int
    m: int

    kind = "noop"

    @property
    def rank(self) -> int:
        return 0

    @property
    def nm(self) -> Tuple[int, int]:
        return int(self.n), int(self.m)

    def affected_fraction(self) -> float:
        return 0.0

    def factors(self, device=None):
        P = np.zeros((int(self.n), 1), np.float32)
        Q = np.zeros((int(self.m), 1), np.float32)
        if device is None:
            return P, Q
        return to_f32(P, device), to_f32(Q, device)

    def norm_bound(self) -> float:
        return 0.0

    def is_noop(self, tol: float = 0.0) -> bool:
        return True

    def negate(self) -> "NoOpCarrier":
        return self


def row_delta_carrier(rows, V, n: int, *, weight: float = 1.0
                      ) -> RowLocalCarrier:
    """The row tuple-update carrier: ``ΔA`` adds ``weight · V[:, j]ᵀ`` to
    row ``rows[j]`` of an ``(n, m)`` input.  ``rows`` is a scalar slot or
    a duplicate-free index array; ``V`` is ``(m,)`` for one row or
    ``(m, r)`` column-per-row for several."""
    rows = np.atleast_1d(np.asarray(rows, dtype=np.int32))
    V = np.asarray(V, dtype=np.float32)
    if V.ndim == 1:
        V = V[:, None]
    if V.shape[1] != rows.size:
        raise ex.ShapeError(f"row_delta_carrier: {rows.size} rows but "
                            f"{V.shape[1]} value columns")
    block = np.eye(rows.size, dtype=np.float32) * np.float32(weight)
    order = np.argsort(rows)
    return RowLocalCarrier(rows[order], block[order], V, n)


def as_carrier(u, v=None) -> DeltaCarrier:
    """Normalize an update to a carrier: a :class:`DeltaCarrier` as it
    is (``v`` must then be ``None``), or a raw factor pair."""
    if isinstance(u, DeltaCarrier):
        if v is not None:
            raise ValueError("carrier updates take no separate v factor")
        return u
    if v is None:
        raise ValueError("raw factor updates need both u and v")
    return LowRankCarrier(_as_f32_factor(u, "u"), _as_f32_factor(v, "v"))


def detect_row_local(u, v, *, max_fraction: float = 0.5,
                     noop_tol: float = 0.0) -> DeltaCarrier:
    """Classify raw ``(u, v)`` factors into the tightest carrier: empty
    row support of ``u`` (or a delta under ``noop_tol``) is a
    :class:`NoOpCarrier`, support of at most ``max_fraction`` of the rows
    a :class:`RowLocalCarrier`, anything wider a :class:`LowRankCarrier`.
    Exact — zero rows of ``u`` contribute nothing to ``u vᵀ``."""
    u = _as_f32_factor(u, "u")
    v = _as_f32_factor(v, "v")
    rows = np.flatnonzero(np.any(u != 0.0, axis=1)).astype(np.int32)
    n = u.shape[0]
    if rows.size == 0:
        return NoOpCarrier(n, v.shape[0])
    c: DeltaCarrier
    if rows.size <= max_fraction * n:
        c = RowLocalCarrier(rows, u[rows], v, n)
    else:
        c = LowRankCarrier(u, v)
    if noop_tol > 0.0 and c.is_noop(noop_tol):
        return NoOpCarrier(n, v.shape[0])
    return c


def stack_carriers(carriers: Sequence[DeltaCarrier]) -> DeltaCarrier:
    """Stack a batch of carriers for one input into a single carrier.

    All-row-local batches stay row-local: rows = sorted union, compact
    blocks placed in union coordinates, ranks concatenated.  Any
    dense-shaped member widens the whole stack to
    :class:`LowRankCarrier`; no-ops contribute nothing.  The stacked rank
    is ``Σ k_t`` and the dense widening equals stacking the members'
    factors.
    """
    live = [c for c in carriers if c.kind != "noop"]
    if not live:
        if not carriers:
            raise ValueError("empty carrier batch")
        n, m = carriers[0].nm
        return NoOpCarrier(n, m)
    if all(c.kind == "row_local" for c in live):
        n = live[0].n
        if any(c.n != n for c in live):
            raise ex.ShapeError("row-local carriers disagree on n")
        rows = np.unique(np.concatenate([c.rows for c in live]))
        rows = rows.astype(np.int32)
        total_k = sum(c.rank for c in live)
        block = np.zeros((rows.size, total_k), np.float32)
        V = np.concatenate([c.V for c in live], axis=1)
        off = 0
        for c in live:
            # positions of the member's rows in the sorted union
            idx = np.searchsorted(rows, c.rows)
            block[idx, off:off + c.rank] = c.block
            off += c.rank
        return RowLocalCarrier(rows, block, V, n)
    us, vs = zip(*(c.factors() for c in live))
    us = [_as_f32_factor(u, "u") for u in us]
    vs = [_as_f32_factor(v, "v") for v in vs]
    for u, v in zip(us, vs):
        if u.shape[1] != v.shape[1]:
            raise ex.ShapeError(f"update rank mismatch: {u.shape} vs "
                                f"{v.shape}")
    return LowRankCarrier(np.concatenate(us, axis=1),
                          np.concatenate(vs, axis=1))
