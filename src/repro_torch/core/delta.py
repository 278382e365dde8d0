"""Delta derivation (paper §4.1) over the symbolic IR.

``derive(E, env)`` computes the total delta of ``E`` under *simultaneous*
factored updates of the variables named in ``env``.  The product rule

    Δ(E1·E2) = ΔE1·E2 + E1·ΔE2 + ΔE1·ΔE2

is exact for simultaneous multi-variable updates when ``ΔEi`` is the total
delta of ``Ei`` — the paper's sequential multi-update rule (Example 4.5)
expands to the same expression, so a single recursive pass suffices.

All variables in the produced expressions denote *pre-update* values, which
matches trigger semantics: every factor block is evaluated first, the
``+=`` updates are applied last (Alg. 1 / Example 4.6).

``derive(E, env, order=k)`` with ``k ≥ 2`` produces the k-th order delta
(delta-of-delta, DBToaster arXiv 1207.0137): Δ applied recursively to
the Δᵏ⁻¹ representation.  For a polynomial program of degree d the
hierarchy terminates — ``Δ^(d+1) E ≡ 0`` — and each level's blocks read
*less* of the base views than the last (Δ² of a quadratic reads none),
which is exactly why materializing the hierarchy makes triggers
asymptotically cheaper.  The inverse (Woodbury) rule does not extend
past first order without materializing the capacitance inverse, so
deriving through it raises :class:`IncrementalInverseError` — the
compiler records such views as unsupported at depth ≥ 2.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from . import expr as ex
from .expr import Expr
from .factored import (ColSlice, DeltaRep, DenseDelta, HStack, LowRank,
                       lowrank_add, lowrank_inverse_woodbury, lowrank_matmul)


@dataclass
class DeltaEnv:
    """Maps var name → its delta representation.

    ``views`` maps an expression (by interned id) to the Var materializing
    it — the inverse rule needs the *old value* of ``E⁻¹`` and may only be
    applied when that inverse is materialized as a view (the compiler's
    auxiliary-view pass guarantees this).
    """

    deltas: Dict[str, DeltaRep] = field(default_factory=dict)
    views: Dict[int, Expr] = field(default_factory=dict)
    sequential_sm: bool = False  # paper-faithful rank-1 SM chain vs Woodbury

    def delta_of(self, name: str) -> Optional[DeltaRep]:
        return self.deltas.get(name)

    def view_for(self, e: Expr) -> Optional[Expr]:
        return self.views.get(id(e))


def is_static(e: Expr, env: DeltaEnv) -> bool:
    """True if no variable of ``e`` has a registered delta."""
    return not any(v in env.deltas for v in e.free_vars())


def derive(e: Expr, env: DeltaEnv, order: int = 1,
           steps: Optional[list] = None) -> DeltaRep:
    """Total delta of ``e`` under the updates in ``env``.

    ``order`` selects the delta depth.  ``order <= 1`` (including the
    degenerate ``order=0``) is the classic first-order total delta and is
    bit-identical to the pre-existing behavior.  ``order=k`` applies Δ
    recursively ``k`` times; by default every level differentiates w.r.t.
    the *same* update symbols (the diagonal Δᵏ E(A; d, …, d), which is what
    a materialized ΔᵏV view maintains).  ``steps`` optionally supplies a
    distinct :class:`DeltaEnv` per extra level for mixed-update algebra
    tests: ``len(steps) == order - 1``.
    """
    if order < 0:
        raise ValueError(f"delta order must be >= 0, got {order}")
    d = _derive(e, env, {})
    if order <= 1:
        return d
    envs = list(steps) if steps is not None else [env] * (order - 1)
    if len(envs) != order - 1:
        raise ValueError(
            f"steps must supply {order - 1} environments, got {len(envs)}")
    for env_j in envs:
        if d.is_zero():
            return LowRank.zero()
        d = derive_delta(d, env_j)
    return d


def derive_delta(d: DeltaRep, env: DeltaEnv) -> DeltaRep:
    """Δ of a delta *representation* — one level of delta-of-delta.

    A factored rep Σᵢ lᵢ·rᵢᵀ is differentiated blockwise with the product
    rule Δ(l·rᵀ) = Δl·rᵀ + l·Δrᵀ + Δl·Δrᵀ; a dense rep falls back to the
    expression-level rules.  The update symbols themselves (``dU_*`` /
    ``dV_*`` vars) carry no registered delta, so they are constants at the
    next level — exactly DBToaster's Δ-hierarchy semantics.
    """
    if isinstance(d, DenseDelta):
        return _derive(d.value, env, {})
    if d.is_zero():
        return LowRank.zero()
    cache: Dict[int, DeltaRep] = {}
    parts = []
    for l, r in zip(d.left, d.right):
        dl = _derive(l, env, cache)
        dr = _derive(r, env, cache)
        if dl.is_zero() and dr.is_zero():
            continue
        rt = ex.transpose(r)
        drt = dr if dr.is_zero() else dr.transpose()
        if isinstance(dl, DenseDelta) or isinstance(drt, DenseDelta):
            parts.append(_dense_matmul_rule_on(l, rt, dl, drt))
        else:
            parts.append(lowrank_matmul(dl, l, drt, rt))
    if not parts:
        return LowRank.zero()
    if any(isinstance(p, DenseDelta) for p in parts):
        shape = d.shape
        return DenseDelta(ex.add(*[_as_dense(p, shape) for p in parts]))
    return lowrank_add(*parts)


def _derive(e: Expr, env: DeltaEnv, cache: Dict[int, DeltaRep]) -> DeltaRep:
    hit = cache.get(id(e))
    if hit is not None:
        return hit
    out = _derive_impl(e, env, cache)
    cache[id(e)] = out
    return out


def _derive_impl(e: Expr, env: DeltaEnv, cache) -> DeltaRep:
    if isinstance(e, ex.Var):
        d = env.delta_of(e.name)
        return d if d is not None else LowRank.zero()

    if isinstance(e, (ex.Zero, ex.Identity, ex.Const)):
        return LowRank.zero()

    if isinstance(e, ex.Add):
        parts = [_derive(t, env, cache) for t in e.terms]
        if any(isinstance(p, DenseDelta) for p in parts):
            vals = [_as_dense(p, t.shape) for p, t in zip(parts, e.terms)]
            return DenseDelta(ex.add(*vals))
        return lowrank_add(*parts)

    if isinstance(e, ex.Scale):
        if not is_static(e.factor, env):
            # scalar factor with its own delta: treat as (1×1) product rule
            return _derive_scalar_product(e, env, cache)
        d = _derive(e.operand, env, cache)
        return d.scale(e.factor) if not d.is_zero() else d

    if isinstance(e, ex.Transpose):
        d = _derive(e.operand, env, cache)
        return d.transpose() if not d.is_zero() else d

    if isinstance(e, ex.MatMul):
        d1 = _derive(e.lhs, env, cache)
        d2 = _derive(e.rhs, env, cache)
        if d1.is_zero() and d2.is_zero():
            return LowRank.zero()
        if isinstance(d1, DenseDelta) or isinstance(d2, DenseDelta):
            return _dense_matmul_rule(e, d1, d2)
        return lowrank_matmul(d1, e.lhs, d2, e.rhs)

    if isinstance(e, ex.Inverse):
        d = _derive(e.operand, env, cache)
        if d.is_zero():
            return LowRank.zero()
        view = env.view_for(e)
        if view is None:
            raise IncrementalInverseError(
                f"inverse {e!r} is affected by updates but not materialized "
                f"as a view; run the auxiliary-view pass first")
        if isinstance(d, DenseDelta):
            # no factored structure to exploit: Δ(E⁻¹) = (E+ΔE)⁻¹ − E⁻¹
            new_op = ex.add(e.operand, d.value)
            return DenseDelta(ex.sub(ex.inverse(new_op), view))
        return lowrank_inverse_woodbury(view, d, sequential=env.sequential_sm)

    if isinstance(e, (HStack, ColSlice)):
        # these nodes exist only inside Woodbury / Sherman–Morrison
        # first-order reps; meeting one here means Δ is being applied
        # *through* an inverse rule, which does not extend past first
        # order without materializing the capacitance inverse
        if is_static(e, env):
            return LowRank.zero()
        raise IncrementalInverseError(
            f"Δ through a Woodbury/SM block operand "
            f"({type(e).__name__}) is unsupported: the inverse rule "
            f"does not extend past first order")

    raise TypeError(f"no delta rule for {type(e).__name__}")


class IncrementalInverseError(RuntimeError):
    pass


def _as_dense(d: DeltaRep, shape) -> Expr:
    if isinstance(d, DenseDelta):
        return d.value
    if d.is_zero():
        return ex.zero(shape)
    return d.to_expr()


def _dense_matmul_rule(e: ex.MatMul, d1: DeltaRep, d2: DeltaRep) -> DenseDelta:
    return _dense_matmul_rule_on(e.lhs, e.rhs, d1, d2)


def _dense_matmul_rule_on(lhs: Expr, rhs: Expr,
                          d1: DeltaRep, d2: DeltaRep) -> DenseDelta:
    """Hybrid product rule: keep the result as one matrix, but evaluate any
    factored operand in its cheap (skinny-first) association."""
    terms = []
    if not d1.is_zero():
        if isinstance(d1, LowRank):
            # (P1 Q1ᵀ) E2  →  P1 (E2ᵀ Q1)ᵀ — still O(k·n²)
            terms.extend(ex.matmul(l, ex.transpose(ex.matmul(ex.transpose(rhs), r)))
                         for l, r in zip(d1.left, d1.right))
        else:
            terms.append(ex.matmul(d1.value, rhs))
    if not d2.is_zero():
        if isinstance(d2, LowRank):
            terms.extend(ex.matmul(ex.matmul(lhs, l), ex.transpose(r))
                         for l, r in zip(d2.left, d2.right))
        else:
            terms.append(ex.matmul(lhs, d2.value))
    if not d1.is_zero() and not d2.is_zero():
        a = _as_dense(d1, lhs.shape)
        b = _as_dense(d2, rhs.shape)
        terms.append(ex.matmul(a, b))
    return DenseDelta(ex.add(*terms))


def _derive_scalar_product(e: ex.Scale, env: DeltaEnv, cache) -> DeltaRep:
    """Δ(λ·E) when the scalar λ itself changes: product rule on (1×1)·E.

    λ is (1,1) so Δλ is rank ≤ 1; the result stays factored if ΔE does.
    """
    dl = _derive(e.factor, env, cache)
    dE = _derive(e.operand, env, cache)
    lam = e.factor
    terms = []
    # Δλ · E  — dense rank equal to rank(E); represent dense
    if not dl.is_zero():
        dl_expr = _as_dense(dl, (1, 1))
        terms.append(ex.scale(dl_expr, e.operand))
        if not dE.is_zero():
            terms.append(ex.scale(dl_expr, _as_dense(dE, e.operand.shape)))
    if not dE.is_zero():
        terms.append(ex.scale(lam, _as_dense(dE, e.operand.shape)))
    if not terms:
        return LowRank.zero()
    return DenseDelta(ex.add(*terms))


# ---------------------------------------------------------------------------
# row-support closure analysis (sparsity-aware carriers, §3–§5)
# ---------------------------------------------------------------------------


def row_support_preserved(e: Expr, u_names) -> bool:
    """Whether ``e``'s row support is contained in the update's rows.

    ``e`` is a compiled trigger's left factor-block expression;
    ``u_names`` the set of factor Vars already known row-contained (the
    input's own ``dU_…`` plus any upstream view factor the compiler has
    proved preserving — containment composes down the chain).  The §4
    delta rules preserve row-locality under exactly these constructors:

      * the update factor itself (``ΔA`` rows ARE the affected rows);
      * ``Zero`` (empty support is contained in anything);
      * ``Scale`` — any scalar factor, row support untouched;
      * ``MatMul`` with a preserving *left* operand — right-
        multiplication mixes columns, never rows (this is the
        ``ΔE1 · E2`` term of the product rule and every capacitance
        chain hanging off it);
      * ``Add`` / ``HStack`` / ``ColSlice`` of preserving parts.

    Everything else widens: a ``Transpose`` moves the support to the
    columns, an ``Inverse`` (Woodbury capacitance) is dense in general,
    and any view/const/other-var leaf carries its own full support —
    that includes the ``E1 · ΔE2`` product-rule term, whose left operand
    is a base view.  Sound but conservative: a ``False`` only costs the
    dense sweep we run today.
    """
    if isinstance(u_names, str):
        u_names = {u_names}
    if isinstance(e, ex.Var):
        return e.name in u_names
    if isinstance(e, ex.Zero):
        return True
    if isinstance(e, ex.Scale):
        return row_support_preserved(e.operand, u_names)
    if isinstance(e, ex.MatMul):
        return row_support_preserved(e.lhs, u_names)
    if isinstance(e, ex.Add):
        return all(row_support_preserved(t, u_names) for t in e.terms)
    if isinstance(e, HStack):
        return all(row_support_preserved(b, u_names) for b in e.blocks)
    if isinstance(e, ColSlice):
        return row_support_preserved(e.operand, u_names)
    return False
