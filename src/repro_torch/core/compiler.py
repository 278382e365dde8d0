"""LINVIEW compiler (paper Alg. 1 + §6 optimizer).

``compile_program`` turns a :class:`Program` into one :class:`Trigger` per
dynamic input.  Each trigger is a straight-line list of factor-block
assignments followed by ``+=`` view updates — exactly the paper's trigger
shape (Example 4.6), with three optimizer passes:

1. **auxiliary-view extraction** — nested ``E⁻¹`` nodes are materialized as
   views so the Woodbury/Sherman–Morrison rule can reference their old
   value (§6 "the optimizer might define a number of auxiliary views");
2. **common-factor extraction** — inside the delta derivation
   (:func:`repro.core.factored.combine_blocks`);
3. **representation choice** — per statement, the factored (incremental)
   and single-matrix (hybrid, §5.3) delta representations are priced with
   the cost model and the cheaper one is materialized.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Literal, Optional, Sequence, Tuple

from . import expr as ex
from .cost import Cost, dense_delta_cost, expr_cost, lowrank_cost, shape_of
from .delta import (DeltaEnv, IncrementalInverseError, derive, derive_delta,
                    row_support_preserved)
from .expr import Expr, Var
from .factored import DeltaRep, DenseDelta, HStack, LowRank, _hstack
from .program import Program, Statement


@dataclass(frozen=True)
class Assign:
    """``name := expr`` inside a trigger body."""

    name: str
    expr: Expr


@dataclass(frozen=True)
class ViewUpdate:
    """``view += delta`` — factored (U·Vᵀ) or dense."""

    view: str
    kind: Literal["lowrank", "dense"]
    u: Optional[str] = None   # factored: U name
    v: Optional[str] = None   # factored: V name
    d: Optional[str] = None   # dense: delta name


@dataclass
class Trigger:
    """ON UPDATE <input> BY (U, V): <assigns>; <updates>."""

    input_name: str
    rank: int
    u_var: Var
    v_var: Var
    assigns: List[Assign] = field(default_factory=list)
    updates: List[ViewUpdate] = field(default_factory=list)
    cost: Cost = Cost.zero()
    reps: Dict[str, str] = field(default_factory=dict)  # view -> chosen rep
    # view -> carrier kind a row-local input update propagates to it:
    # "row_local" (delta's row support provably ⊆ the update's affected
    # rows — §4 closure, see repro.core.delta.row_support_preserved),
    # "low_rank" (factored but support widens), "dense" (hybrid rep).
    # The input's own += is always row-local.
    carriers: Dict[str, str] = field(default_factory=dict)

    def __repr__(self) -> str:
        lines = [f"ON UPDATE {self.input_name} BY ({self.u_var.name}, "
                 f"{self.v_var.name}):  # rank {self.rank}"]
        lines += [f"  {a.name} := {a.expr!r}" for a in self.assigns]
        for up in self.updates:
            if up.kind == "lowrank":
                lines.append(f"  {up.view} += {up.u} {up.v}^T")
            else:
                lines.append(f"  {up.view} += {up.d}")
        return "\n".join(lines)


def delta_view_name(view: str, depth: int) -> str:
    """Canonical name of the materialized ΔᵈV auxiliary view."""
    return f"__d{depth}__{view}"


@dataclass(frozen=True)
class DeltaView:
    """A materialized k-th order delta view ΔᵈV (auxiliary view, §6 /
    DBToaster's recursive delta hierarchy).

    ``rank`` is the factored rank of the Δᵈ representation at the compile
    update rank (0 for a dense rep); ``flops`` prices one evaluation of the
    rep's blocks — the trigger cost of maintaining the view.
    """

    name: str          # "__d{depth}__{view}"
    view: str          # the base view this is a delta of
    input_name: str
    depth: int
    kind: Literal["lowrank", "dense"]
    rank: int
    flops: float


@dataclass
class CompiledProgram:
    program: Program
    triggers: Dict[str, Trigger]
    # statements after the auxiliary-view pass (what the runtime evaluates)
    statements: List[Statement] = field(default_factory=list)
    # compile options, retained so batched triggers (compiled lazily per
    # batch-size bucket) share the same derivation choices
    force_rep: Optional[str] = None
    sequential_sm: bool = False
    # maximum delta depth derived at compile time (1 = classic first order)
    order: int = 1
    # (input, depth) -> {view -> DeltaView}: the ΔᵈV materialization
    # candidates registered when order >= 2 (absent views have Δᵈ ≡ 0)
    delta_views: Dict[Tuple[str, int], Dict[str, DeltaView]] = \
        field(default_factory=dict)
    # (input, depth) -> views whose Δᵈ derivation is unsupported (the
    # Woodbury capacitance inverse has no materialized view at depth >= 2)
    delta_unsupported: Dict[Tuple[str, int], Tuple[str, ...]] = \
        field(default_factory=dict)


# ---------------------------------------------------------------------------
# pass 1: auxiliary views for nested inverses
# ---------------------------------------------------------------------------


def extract_inverse_views(program: Program) -> Program:
    """Materialize every ``Inverse`` node as its own view.

    A statement ``W := E⁻¹`` already materializes the inverse; a nested
    inverse inside a larger expression is hoisted into ``__auxK := E⁻¹``
    and substituted, preserving program semantics.
    """
    counter = itertools.count()
    out = Program(name=program.name, inputs=dict(program.inputs),
                  outputs=list(program.outputs), dims=dict(program.dims))
    known: Dict[int, Var] = {}

    def hoist(e: Expr) -> Expr:
        if isinstance(e, ex.Inverse):
            inner = hoist(e.operand)
            node = ex.inverse(inner)
            if id(node) in known:
                return known[id(node)]
            aux = out.let(f"__aux{next(counter)}", node)
            known[id(node)] = aux
            return aux
        if isinstance(e, ex.MatMul):
            return ex.matmul(hoist(e.lhs), hoist(e.rhs))
        if isinstance(e, ex.Add):
            return ex.add(*[hoist(t) for t in e.terms])
        if isinstance(e, ex.Scale):
            return ex.scale(hoist(e.factor), hoist(e.operand))
        if isinstance(e, ex.Transpose):
            return ex.transpose(hoist(e.operand))
        return e

    for st in program.statements:
        if isinstance(st.expr, ex.Inverse):
            # top-level inverse: keep, but register as a known inverse view
            inner = hoist(st.expr.operand)
            node = ex.inverse(inner)
            v = out.let(st.target.name, node)
            known[id(node)] = v
        else:
            out.let(st.target.name, hoist(st.expr))
    return out


# ---------------------------------------------------------------------------
# pass 2+3: delta derivation + representation choice  (Alg. 1)
# ---------------------------------------------------------------------------


def compile_program(
    program: Program,
    update_ranks: Optional[Dict[str, int]] = None,
    *,
    force_rep: Optional[str] = None,      # "lowrank" | "dense" | None=cost-based
    sequential_sm: bool = False,          # paper-faithful SM chain vs Woodbury
    order: int = 1,                       # max delta depth to derive (>= 1)
) -> CompiledProgram:
    """Alg. 1: one trigger per dynamic input matrix.

    ``order >= 2`` additionally derives the ΔᵈV hierarchy per input for
    depths 2..order and registers each non-zero ΔᵈV as a first-class
    materialization candidate (:class:`DeltaView`); the depth-d trigger
    itself is compiled on demand by :func:`compile_delta_trigger`.  Views
    whose Δᵈ cannot be derived (the inverse error path) are recorded in
    ``delta_unsupported`` instead of failing the whole program.
    """
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    program = extract_inverse_views(program)
    update_ranks = update_ranks or {name: 1 for name in program.inputs}
    binding = dict(program.dims)

    # views map for the inverse rule: expr-id -> var, for materialized views
    views: Dict[int, Expr] = {}
    for st in program.statements:
        views[id(st.expr)] = st.target

    triggers: Dict[str, Trigger] = {}
    for input_name, rank in update_ranks.items():
        if input_name not in program.inputs:
            raise KeyError(f"{input_name} is not an input of {program.name}")
        triggers[input_name] = _compile_trigger(
            program, input_name, rank, views, binding,
            force_rep=force_rep, sequential_sm=sequential_sm)
    compiled = CompiledProgram(program=program, triggers=triggers,
                               statements=list(program.statements),
                               force_rep=force_rep, sequential_sm=sequential_sm,
                               order=order)
    if order >= 2:
        for input_name, rank in update_ranks.items():
            _register_delta_views(compiled, input_name, rank, binding)
    return compiled


def _raw_delta_reps(program: Program, input_name: str, rank: int,
                    *, sequential_sm: bool):
    """Per-statement *raw* first-order reps with view deltas inlined.

    Unlike :func:`_compile_trigger`, downstream statements see the full
    factor expressions of upstream deltas (not renamed ``dU_V`` vars), so
    the result can be differentiated again by :func:`derive_delta`.
    """
    views: Dict[int, Expr] = {id(st.expr): st.target
                              for st in program.statements}
    x = program.inputs[input_name]
    u = ex.var(f"dU_{input_name}", (x.shape[0], rank))
    v = ex.var(f"dV_{input_name}", (x.shape[1], rank))
    env = DeltaEnv(views=views, sequential_sm=sequential_sm)
    env.deltas[input_name] = LowRank.outer(u, v)
    reps: Dict[str, DeltaRep] = {}
    for st in program.statements:
        d = derive(st.expr, env)
        if not d.is_zero():
            env.deltas[st.target.name] = d
        reps[st.target.name] = d
    return env, reps, u, v


def _register_delta_views(compiled: CompiledProgram, input_name: str,
                          rank: int, binding: Dict[str, int]) -> None:
    program = compiled.program
    env, reps, _, _ = _raw_delta_reps(
        program, input_name, rank, sequential_sm=compiled.sequential_sm)
    current: Dict[str, DeltaRep] = dict(reps)
    for depth in range(2, compiled.order + 1):
        registry: Dict[str, DeltaView] = {}
        unsupported: List[str] = []
        nxt: Dict[str, DeltaRep] = {}
        for st in program.statements:
            name = st.target.name
            d = current.get(name)
            if d is None or d.is_zero():
                continue
            try:
                dd = derive_delta(d, env)
            except IncrementalInverseError:
                unsupported.append(name)
                continue
            nxt[name] = dd
            if dd.is_zero():
                continue  # Δᵈ ≡ 0: hierarchy exhausted for this view
            if isinstance(dd, DenseDelta):
                kind, k = "dense", 0
                flops = expr_cost(dd.value, binding).flops
            else:
                kind, k = "lowrank", dd.rank
                flops = lowrank_cost(dd, binding).flops
            registry[name] = DeltaView(
                name=delta_view_name(name, depth), view=name,
                input_name=input_name, depth=depth, kind=kind,
                rank=k, flops=flops)
        compiled.delta_views[(input_name, depth)] = registry
        if unsupported:
            compiled.delta_unsupported[(input_name, depth)] = tuple(unsupported)
        current = nxt


def compile_delta_trigger(compiled: CompiledProgram, input_name: str,
                          depth: int, rank: Optional[int] = None) -> Trigger:
    """Compile the trigger maintaining the ΔᵈV views for one input.

    The trigger reads the *pre-update* base views plus the update factors
    (same ``dU_*``/``dV_*`` signature as the base trigger — every level of
    the diagonal hierarchy is driven by the same update) and writes the
    ``__d{depth}__V`` auxiliary views.  Raises
    :class:`IncrementalInverseError` if any view's Δᵈ is unsupported at
    this depth — the inverse error path is a hard error here because a
    partial hierarchy cannot be folded.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    program = compiled.program
    if input_name not in program.inputs:
        raise KeyError(f"{input_name} is not an input of {program.name}")
    if rank is None:
        rank = compiled.triggers[input_name].rank
    if depth == 1:
        return compile_batched_trigger(compiled, input_name, rank)
    env, reps, u, v = _raw_delta_reps(
        program, input_name, rank, sequential_sm=compiled.sequential_sm)
    binding = dict(program.dims)

    trig = Trigger(input_name=input_name, rank=rank, u_var=u, v_var=v)
    total = Cost.zero()
    for st in program.statements:
        name = st.target.name
        d = reps.get(name)
        if d is None or d.is_zero():
            continue
        try:
            for _ in range(depth - 1):
                d = derive_delta(d, env)
                if d.is_zero():
                    break
        except IncrementalInverseError as err:
            raise IncrementalInverseError(
                f"Δ^{depth} of view {name!r} is unsupported: {err}") from err
        if d.is_zero():
            continue
        dview = delta_view_name(name, depth)
        rep = _choose_rep(d, st, binding, compiled.force_rep)
        if rep == "dense" or isinstance(d, DenseDelta):
            dname = f"dD_{dview}"
            dexpr = d.value if isinstance(d, DenseDelta) else d.to_expr()
            trig.assigns.append(Assign(dname, dexpr))
            trig.updates.append(ViewUpdate(view=dview, kind="dense", d=dname))
            total = total + expr_cost(dexpr, binding)
            trig.reps[dview] = "dense"
        else:
            uname, vname = f"dU_{dview}", f"dV_{dview}"
            trig.assigns.append(Assign(uname, _hstack(d.left)))
            trig.assigns.append(Assign(vname, _hstack(d.right)))
            trig.updates.append(ViewUpdate(view=dview, kind="lowrank",
                                           u=uname, v=vname))
            total = total + lowrank_cost(d, binding)
            trig.reps[dview] = "lowrank"
    trig.cost = total
    return trig


# ---------------------------------------------------------------------------
# batched triggers (§6 batching, one trigger firing per T-update batch)
# ---------------------------------------------------------------------------


def batch_bucket(rank: int) -> int:
    """Static batch-size bucket: the next power of two ≥ rank.

    Stacked batch factors are zero-padded up to the bucket rank, so one
    jitted trigger per bucket serves every batch size in (bucket/2, bucket]
    and the jit cache stays warm across ragged batches.
    """
    if rank < 1:
        raise ValueError(f"rank must be ≥ 1, got {rank}")
    return 1 << (rank - 1).bit_length()


def compile_batched_trigger(compiled: CompiledProgram, input_name: str,
                            rank: int) -> Trigger:
    """Compile the trigger for a *stacked* batch of updates to one input.

    A batch of T rank-k updates {(U_t, V_t)} is the single factored update
    ``P Qᵀ`` with P = [U_1 … U_T], Q = [V_1 … V_T] (rank k·T), so the
    derivation is identical to the per-update trigger at the stacked rank —
    the entire batch flows through each maintained view in ONE pass.
    Representation choice re-runs per rank: wide batches flip skinny views
    to the dense/hybrid path exactly as §5.3 prescribes.
    """
    program = compiled.program  # already aux-extracted by compile_program
    if input_name not in program.inputs:
        raise KeyError(f"{input_name} is not an input of {program.name}")
    views: Dict[int, Expr] = {id(st.expr): st.target
                              for st in program.statements}
    return _compile_trigger(
        program, input_name, rank, views, dict(program.dims),
        force_rep=compiled.force_rep, sequential_sm=compiled.sequential_sm)


def _compile_trigger(program: Program, input_name: str, rank: int,
                     views: Dict[int, Expr], binding: Dict[str, int],
                     *, force_rep: Optional[str],
                     sequential_sm: bool) -> Trigger:
    x = program.inputs[input_name]
    u = ex.var(f"dU_{input_name}", (x.shape[0], rank))
    v = ex.var(f"dV_{input_name}", (x.shape[1], rank))

    env = DeltaEnv(views=views, sequential_sm=sequential_sm)
    env.deltas[input_name] = LowRank.outer(u, v)

    trig = Trigger(input_name=input_name, rank=rank, u_var=u, v_var=v)
    trig.updates.append(ViewUpdate(view=input_name, kind="lowrank",
                                   u=u.name, v=v.name))
    # carrier-kind propagation: which maintained views a row-local input
    # update reaches without leaving its affected rows.  The input's own
    # += trivially stays row-local; a view's does iff its left factor
    # expression is row-support-preserving over the already-preserving
    # factor vars (containment composes down the delta chain).
    trig.carriers[input_name] = "row_local"
    preserving = {u.name}
    total = Cost.zero()

    for st in program.statements:
        d = derive(st.expr, env)
        if isinstance(d, LowRank) and d.is_zero():
            continue
        rep = _choose_rep(d, st, binding, force_rep)
        if rep == "dense":
            dname = f"dD_{st.target.name}"
            dexpr = d.value if isinstance(d, DenseDelta) else d.to_expr()
            trig.assigns.append(Assign(dname, dexpr))
            trig.updates.append(ViewUpdate(view=st.target.name, kind="dense",
                                           d=dname))
            env.deltas[st.target.name] = DenseDelta(
                ex.var(dname, st.target.shape))
            total = total + expr_cost(dexpr, binding)
            trig.carriers[st.target.name] = "dense"
        else:
            lr = d if isinstance(d, LowRank) else _refactor_dense(d)
            uname = f"dU_{st.target.name}"
            vname = f"dV_{st.target.name}"
            uexpr = _hstack(lr.left)
            vexpr = _hstack(lr.right)
            trig.assigns.append(Assign(uname, uexpr))
            trig.assigns.append(Assign(vname, vexpr))
            trig.updates.append(ViewUpdate(view=st.target.name,
                                           kind="lowrank", u=uname, v=vname))
            k = lr.rank
            env.deltas[st.target.name] = LowRank.outer(
                ex.var(uname, (st.target.shape[0], k)),
                ex.var(vname, (st.target.shape[1], k)))
            total = total + lowrank_cost(lr, binding)
            if row_support_preserved(uexpr, preserving):
                trig.carriers[st.target.name] = "row_local"
                preserving.add(uname)
            else:
                trig.carriers[st.target.name] = "low_rank"
        trig.reps[st.target.name] = rep
    trig.cost = total
    return trig


def _refactor_dense(d: DenseDelta) -> LowRank:
    raise NotImplementedError(
        "a dense delta cannot be re-factored without value inspection "
        "(paper §4.3); once a statement goes hybrid, downstream statements "
        "must either stay dense or be cost-priced as dense")


def _choose_rep(d: DeltaRep, st: Statement, binding: Dict[str, int],
                force_rep: Optional[str]) -> str:
    """Representation choice (§5.3 hybrid evaluation).

    The factored form wins when rank ≪ min(n, m); when the view itself is
    skinny (p comparable to the rank, e.g. p = 1 in the paper's extreme),
    a single dense delta is cheaper.  We price both and pick.
    """
    if isinstance(d, DenseDelta):
        return "dense"
    if force_rep is not None:
        return force_rep
    n, m = shape_of(st.target, binding)
    if d.rank >= min(n, m):
        return "dense"
    fact = lowrank_cost(d, binding).flops
    dense = expr_cost(d.to_expr(), binding).flops
    # materializing U,V then applying U Vᵀ touches the view once more than
    # the dense path; fold the apply cost into the comparison.
    fact += 2.0 * d.rank * n * m
    dense += 2.0 * n * m
    return "lowrank" if fact <= dense else "dense"
