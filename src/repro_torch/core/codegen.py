"""Codegen: symbolic expressions / triggers → eager PyTorch callables.

A trigger body is a chain of (big × skinny) or (skinny × skinny) matmuls
that build the factor blocks, followed by one rank-k apply ``M += U Vᵀ``
per written view.  Every apply goes through
:func:`repro_torch.kernels.ops.rank_update_batched`, which runs the CUDA
kernel on the card and its plain version on the CPU, in place on the
view's own storage.  Under a row-local delta carrier, the views the
compiler proved row-local take
:func:`repro_torch.kernels.ops.rank_update_rows` instead
(:func:`build_rowlocal_trigger_fn`).

In-place applies make aliasing matter where the reference (immutable JAX
arrays) never had to care: a factor block that shares storage with a
view written in the same firing would be read after the apply changed it,
so such a factor is cloned before any apply runs.

A firing under a maintenance plan (:func:`build_trigger_fn` with
``reeval_views`` / ``lazy_views``) keeps that contract and adds one
more: a view re-evaluated inside the firing gets storage of its own, as
every view of :func:`build_evaluator` does.

A guarded (transactional) firing is built with ``out_of_place=True``:
every dense low-rank apply goes through
:func:`repro_torch.kernels.ops.rank_update_batched_out`, which leaves the
view alone and returns the updated one in new storage.  Then no apply of
the firing writes a tensor that existed before it, as no apply of the
reference's immutable arrays does, and the pre-firing store survives as
the firing's rollback (:mod:`repro_torch.guard.txn`).  Row-local views
stay on the in-place row kernel; the guard saves their touched rows.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.rank_update_rows import RowSet
from . import expr as ex
from .compiler import Assign, Trigger
from .expr import Expr
from .factored import ColSlice, HStack, to_f32
from .program import Program

Env = Dict[str, torch.Tensor]


def _dim(d, binding: Dict[str, int]) -> int:
    return binding[d.name] if isinstance(d, ex.Dim) else int(d)


def evaluate(e: Expr, env: Env, binding: Dict[str, int],
             cache: Optional[Dict[int, torch.Tensor]] = None,
             device=None) -> torch.Tensor:
    """Evaluate a symbolic expression against concrete tensors.

    ``cache`` keyed by interned node id gives cross-expression CSE: blocks
    of the same trigger share subcomputations for free.  Constants
    (``Zero``, ``Identity``, ``Const``) are made on ``device``, by default
    the device of the tensors in ``env``.
    """
    if cache is None:
        cache = {}
    if device is None:
        device = next(iter(env.values())).device

    def go(x: Expr) -> torch.Tensor:
        hit = cache.get(id(x))
        if hit is not None:
            return hit
        out = _eval_node(x, env, binding, go, device)
        cache[id(x)] = out
        return out

    try:
        return go(e)
    finally:
        # ``go`` refers to itself through its closure: left in place, that
        # cycle keeps ``cache`` and ``env`` — every intermediate tensor —
        # alive until the garbage collector runs, not until the caller
        # drops them
        del go


def _eval_node(x: Expr, env: Env, binding, go, device) -> torch.Tensor:
    if isinstance(x, ex.Var):
        try:
            return env[x.name]
        except KeyError:
            raise KeyError(f"unbound variable {x.name}; have {sorted(env)}")
    if isinstance(x, ex.Zero):
        return torch.zeros((_dim(x.shape[0], binding),
                            _dim(x.shape[1], binding)),
                           dtype=torch.float32, device=device)
    if isinstance(x, ex.Identity):
        return torch.eye(_dim(x.shape[0], binding), dtype=torch.float32,
                         device=device)
    if isinstance(x, ex.Const):
        return torch.full((1, 1), x.value, dtype=torch.float32, device=device)
    if isinstance(x, ex.MatMul):
        return go(x.lhs) @ go(x.rhs)
    if isinstance(x, ex.Add):
        return functools.reduce(torch.add, [go(t) for t in x.terms])
    if isinstance(x, ex.Scale):
        f = go(x.factor)
        if f.dim() == 2:  # (1,1) scalar view
            f = f[0, 0]
        return f * go(x.operand)
    if isinstance(x, ex.Transpose):
        return go(x.operand).T
    if isinstance(x, ex.Inverse):
        a = go(x.operand)
        if a.shape == (1, 1):
            return 1.0 / a
        # as jnp.linalg.inv: a singular or non-finite operand gives
        # non-finite entries, never an error (and no host sync to check)
        return torch.linalg.inv_ex(a).inverse
    if isinstance(x, HStack):
        return torch.cat([go(b) for b in x.blocks], dim=1)
    if isinstance(x, ColSlice):
        return go(x.operand)[:, x.col:x.col + 1]
    raise TypeError(f"cannot evaluate {type(x).__name__}")


@functools.lru_cache(maxsize=256)
def _finite_check(names: Tuple[str, ...]) -> Callable:
    def check(views: Env, rows: Optional[Dict[str, torch.Tensor]] = None):
        ends = []
        for name in names:
            x = views[name]
            if rows and name in rows:
                x = x.index_select(0, rows[name])
            # one read of x; a NaN reaches both ends, ±inf one of them
            ends.append(torch.stack(torch.aminmax(x)) if x.numel() else
                        torch.zeros(2, device=x.device))
        ends = torch.stack(ends).cpu().numpy()
        return np.isfinite(ends).all(axis=1)
    return check


def build_finite_check(names) -> Callable:
    """Finiteness probe over the views in ``names``.

    Returns ``fn(views, rows=None) -> bool[len(names)]`` (True =
    all-finite) as a host array: one ``aminmax`` a view, queued back to
    back, and one device sync that reads their ends for the whole set —
    the post-firing output
    validation (:func:`repro_torch.guard.txn.check_finite`) runs this on
    every guarded snapshot-path firing.  ``rows`` maps a view name to an
    int64 row index: that view is probed on those rows only (a row-local
    firing's touched rows).  Cached on the name tuple; views may hold
    extra keys.
    """
    return _finite_check(tuple(names))


def _shares_storage(x: torch.Tensor, others) -> bool:
    ptr = x.untyped_storage().data_ptr()
    return any(o.untyped_storage().data_ptr() == ptr for o in others)


def _own(val: torch.Tensor, others) -> torch.Tensor:
    """``val`` as contiguous storage that no tensor of ``others`` shares:
    a statement that evaluates to an input, another view, or a transpose
    of one (``.T`` is a torch view) is copied, so later in-place applies
    never write through to a second name."""
    if not val.is_contiguous() or _shares_storage(val, others):
        val = val.contiguous().clone()
    return val


def recompute(statements, views: Env, binding: Dict[str, int],
              device=None) -> Env:
    """Re-evaluate ``statements`` in program order against ``views`` and
    store each result in ``views`` (updated and returned), so a statement
    sees the values its predecessors just recomputed.  One fresh CSE
    cache serves the whole pass; each result gets storage of its own, so
    a later in-place apply to one view never writes through to another.
    """
    cache: Dict[int, torch.Tensor] = {}
    for st in statements:
        name = st.target.name
        val = evaluate(st.expr, views, binding, cache, device)
        views[name] = _own(val, [t for k, t in views.items() if k != name])
    return views


# ---------------------------------------------------------------------------
# program re-evaluation (the paper's baseline strategy)
# ---------------------------------------------------------------------------


def build_evaluator(program: Program,
                    binding: Optional[Dict[str, int]] = None,
                    device=None) -> Callable[[Env], Env]:
    """Full re-evaluation: returns {view name: value} for all statements.

    Every returned view owns contiguous storage of its own
    (:func:`recompute`), so the in-place applies of a later firing never
    write through to a second name.
    """
    binding = dict(program.dims if binding is None else binding)

    def run(inputs: Env) -> Env:
        env = recompute(program.statements, dict(inputs), binding, device)
        return {st.target.name: env[st.target.name]
                for st in program.statements}

    return run


# ---------------------------------------------------------------------------
# trigger execution (incremental, or per view under a maintenance plan)
# ---------------------------------------------------------------------------


def trigger_touched_views(trigger: Trigger) -> Tuple[Tuple[str, ...],
                                                     Tuple[str, ...]]:
    """(written, read-only) view names a trigger actually touches.

    ``written`` are the ``+=`` targets; ``read-only`` are views referenced
    by the factor-block assigns but never updated.
    """
    local = {trigger.u_var.name, trigger.v_var.name}
    local.update(a.name for a in trigger.assigns)
    written = tuple(dict.fromkeys(up.view for up in trigger.updates))
    read = set()
    for a in trigger.assigns:
        read |= set(a.expr.free_vars())
    read -= local
    read -= set(written)
    return written, tuple(sorted(read))


def _firing_factors(updates, env: Env, views: Env, written,
                    place=None) -> List[Tuple[torch.Tensor, ...]]:
    """The contiguous factor blocks of each of a firing's ``updates``:
    ``(U, V)`` for a low-rank one, ``(D,)`` for a dense one.  ``place(up,
    side, f)``, when given, first maps each factor to the layout its apply
    takes (side 0 is the view's rows, side 1 a low-rank V; a mesh rank's
    blocks, :mod:`repro_torch.dist.ivm_shard`).  The kernels take
    contiguous factors; a factor that shares storage with a view written
    in the same firing must not see an earlier update of that firing, so
    it gets its own copy, made once for every update that names it."""
    targets = [views[name] for name in written]
    made: Dict[Tuple[str, int], torch.Tensor] = {}
    factors = []
    for up in updates:
        names = (up.u, up.v) if up.kind == "lowrank" else (up.d,)
        for side, name in enumerate(names):
            if (name, side) not in made:
                f = env[name] if place is None else place(up, side, env[name])
                if _shares_storage(f, targets):
                    f = f.clone(memory_format=torch.contiguous_format)
                made[name, side] = f.contiguous()
        factors.append(tuple(made[name, side]
                             for side, name in enumerate(names)))
    return factors


def _set_run_attrs(run, updates, statements, skipped, reeval_views,
                   written) -> None:
    """The run attributes of a trigger fn (:func:`build_trigger_fn`)."""
    run.reeval_views = tuple(sorted(reeval_views))
    run.recomputes = tuple(st.target.name for st in statements)
    run.skipped = skipped
    run.incr_views = tuple(up.view for up in updates)
    run.lowrank_applies = sum(up.kind == "lowrank" for up in updates)
    run.written = tuple(dict.fromkeys(written + run.recomputes))
    flagged = {up.view for up in updates if up.kind == "lowrank"}
    run.unflagged = tuple(n for n in run.written
                          if n not in flagged or n in run.recomputes)


def planned_trigger_sets(trigger: Trigger, program: Program,
                         reeval_views=(), lazy_views=()):
    """Partition a trigger's work under a maintenance plan.

    ``reeval_views`` are re-evaluated from their defining statements
    inside the firing (the §7 fallback for views whose delta lost to
    recomputation); ``lazy_views`` are skipped entirely (unmaterialized
    intermediates, recomputed on read) — unless a re-evaluated view's
    statement reads them, in which case they are pulled into the
    recompute closure so re-evaluation stays exact.

    Returns ``(kept_assigns, kept_updates, recompute_stmts, skipped)``:
    the dead-code-eliminated factor-block assigns and ``+=`` updates
    that still run incrementally, the statements to re-evaluate in
    program order, and the lazy views this firing leaves stale.
    """
    reeval = set(reeval_views)
    lazy = set(lazy_views) - reeval
    if trigger.input_name in reeval or trigger.input_name in lazy:
        raise ValueError(
            f"input {trigger.input_name!r} is the base fact: it cannot be "
            f"re-evaluated or left unmaterialized")
    kept_updates = [up for up in trigger.updates
                    if up.view not in reeval and up.view not in lazy]
    # recompute closure, discovered right-to-left: a lazy view is
    # recomputed only if a later recomputed statement reads it
    needed: set = set()
    recompute_names: set = set()
    for st in reversed(program.statements):
        name = st.target.name
        if name in reeval or (name in lazy and name in needed):
            recompute_names.add(name)
            needed |= set(st.expr.free_vars())
    recompute = [st for st in program.statements
                 if st.target.name in recompute_names]
    skipped = tuple(sorted(lazy - recompute_names))
    # assign DCE, same direction: keep only blocks the kept updates
    # (transitively) reference
    need: set = set()
    for up in kept_updates:
        need |= {x for x in (up.u, up.v, up.d) if x}
    kept_assigns: List[Assign] = []
    for a in reversed(trigger.assigns):
        if a.name in need:
            kept_assigns.append(a)
            need |= set(a.expr.free_vars())
    kept_assigns.reverse()
    return kept_assigns, kept_updates, recompute, skipped


def build_trigger_fn(trigger: Trigger, program: Program,
                     binding: Optional[Dict[str, int]] = None,
                     device=None, *, reeval_views=(), lazy_views=(),
                     out_of_place: bool = False
                     ) -> Callable[[Env, torch.Tensor, torch.Tensor], Env]:
    """Stage a trigger into ``(views, U, V) -> views``.

    ``views`` must contain the input matrices and every maintained view;
    the dict is updated and returned.  Under a maintenance plan,
    ``reeval_views`` are re-evaluated inside the firing and
    ``lazy_views`` skipped (:func:`planned_trigger_sets`); with both
    empty every view is maintained incrementally.

    Execution order keeps the firing exact with in-place applies:

    1. every kept factor block is evaluated against the *old* views (the
       delta derivation's contract), and a factor that shares storage
       with a view the firing writes is copied — all before any apply;
    2. the surviving updates land: a low-rank one through
       ``ops.rank_update_batched`` in place on its view, a dense (hybrid)
       one as ``view + D``;
    3. the re-evaluated statements run through :func:`recompute` against
       the updated store (the assign-phase cache holds pre-update
       values).

    With ``out_of_place`` every low-rank apply is
    ``views[name] = ops.rank_update_batched_out(views[name], U, V,
    nonfinite)`` instead: the firing then writes no tensor that existed
    before it, so no factor needs a copy, and ``run(views, U, V,
    nonfinite)`` takes an optional one-element int32 flag on the views'
    device that the applies set when a value they store is not finite.

    Run attributes: ``reeval_views``, ``recomputes`` (re-evaluated plus
    pulled-in lazy views), ``skipped`` (lazy views left stale),
    ``incr_views`` and ``lowrank_applies`` (the incremental views'
    rank-k applies — the kernel launches of one firing on the card),
    ``written`` (every view the firing stores, in order) and
    ``unflagged`` (those of them that no flagged apply stores: dense and
    re-evaluated views).
    """
    binding = dict(program.dims if binding is None else binding)
    assigns, updates, statements, skipped = planned_trigger_sets(
        trigger, program, reeval_views, lazy_views)
    written = tuple(dict.fromkeys(up.view for up in updates))

    def run(views: Env, u: torch.Tensor, v: torch.Tensor,
            nonfinite: Optional[torch.Tensor] = None) -> Env:
        env: Env = dict(views)
        env[trigger.u_var.name] = u
        env[trigger.v_var.name] = v
        cache: Dict[int, torch.Tensor] = {}
        for a in assigns:
            env[a.name] = evaluate(a.expr, env, binding, cache, device)
        factors = _firing_factors(updates, env, views,
                                  () if out_of_place else written)
        del env, cache
        for up, fs in zip(updates, factors):
            if up.kind != "lowrank":
                views[up.view] = views[up.view] + fs[0]
            elif out_of_place:
                views[up.view] = ops.rank_update_batched_out(
                    views[up.view], fs[0], fs[1], nonfinite)
            else:
                ops.rank_update_batched(views[up.view], fs[0], fs[1])
        del factors
        return recompute(statements, views, binding, device)

    _set_run_attrs(run, updates, statements, skipped, reeval_views, written)
    return run


# the reference's name for a firing built under a plan
build_planned_trigger_fn = build_trigger_fn


# ---------------------------------------------------------------------------
# row-local trigger execution (row-local carriers, §3–§5 containment)
# ---------------------------------------------------------------------------


def _expr_refs(e: Expr, names) -> bool:
    """Whether ``e`` references any :class:`~repro_torch.core.expr.Var`
    in ``names`` (iterative — factor chains can be deep)."""
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, ex.Var) and x.name in names:
            return True
        stack.extend(x.children)
    return False


def _compact_left_safe(e: Expr, left) -> bool:
    """Whether a left factor-block expression can be evaluated with the
    update's **compact** ``(r, k)`` row block bound in place of the dense
    ``(n, k)`` scattered factor.

    Every constructor that preserves row support also commutes with the
    row gather — ``(α·L)[rows] = α·L[rows]``, ``(L @ B)[rows] =
    L[rows] @ B``, and ``Add`` / ``HStack`` / ``ColSlice`` act per row or
    per column — provided no compact-shaped value reaches a dense
    position (a ``MatMul`` right operand, a ``Scale`` factor).  ``Zero``
    is excluded: its shape comes from the binding's dense dims.
    """
    if isinstance(e, ex.Var):
        return e.name in left
    if isinstance(e, ex.Scale):
        return (not _expr_refs(e.factor, left)
                and _compact_left_safe(e.operand, left))
    if isinstance(e, ex.MatMul):
        return (_compact_left_safe(e.lhs, left)
                and not _expr_refs(e.rhs, left))
    if isinstance(e, ex.Add):
        return all(_compact_left_safe(t, left) for t in e.terms)
    if isinstance(e, HStack):
        return all(_compact_left_safe(b, left) for b in e.blocks)
    if isinstance(e, ColSlice):
        return _compact_left_safe(e.operand, left)
    return False


def compact_chain_names(trigger: Trigger):
    """The trigger's left-factor vars that stay compact end to end, or
    ``None`` if this trigger cannot run its factor chain compactly.

    A trigger qualifies when every maintained view is a row-local
    low-rank update and every assign that (transitively) consumes the
    update's left factor is :func:`_compact_left_safe`: then the whole
    chain runs on the ``(r, k)`` row block and no dense ``(n, k)``
    factor is ever made."""
    if any(up.kind != "lowrank" for up in trigger.updates):
        return None
    if any(trigger.carriers.get(up.view) != "row_local"
           for up in trigger.updates):
        return None
    left = {trigger.u_var.name}
    for a in trigger.assigns:
        if not _expr_refs(a.expr, left):
            continue
        if not _compact_left_safe(a.expr, left):
            return None
        left.add(a.name)
    for up in trigger.updates:
        if up.u not in left or up.v in left:
            return None
    return left


def build_rowlocal_trigger_fn(trigger: Trigger, program: Program,
                              binding: Optional[Dict[str, int]] = None,
                              device=None, max_fraction: float = 0.25,
                              out_of_place: bool = False) -> Callable:
    """Stage a trigger for row-local carriers: ``(views, rows, block, V)
    -> views``, where ``rows`` (r,) are the update's affected rows
    (strictly increasing), ``block`` its compact ``(r, k)`` left factor
    and ``V`` its ``(m, k)`` right factor.

    Two regimes:

    * **compact** — when :func:`compact_chain_names` qualifies, ``block``
      is bound as the update's left factor and the whole chain runs on
      compact factors; each view is updated by
      ``ops.rank_update_rows(view, rows, L, R)``.  No dense ``(n, k)``
      factor is ever made.
    * **mixed** — otherwise ``block`` is scattered into a dense ``u`` and
      the chain runs as in :func:`build_trigger_fn`.  Each view the
      compiler proved row-local takes ``ops.rank_update_rows(view, rows,
      L[rows], R)``, every other low-rank view the dense
      ``ops.rank_update_batched``, and a dense update ``view + D``.

    Rows stay exact (no padding).  Every factor is evaluated against the
    pre-update views before any apply runs, and a factor that shares
    storage with a written view is copied first, as in
    :func:`build_trigger_fn`.  The sum ``view[rows] += L Rᵀ`` may round
    differently from the dense ``view + u vᵀ`` by an ulp.
    ``run.row_applies`` and ``run.dense_applies`` count the row-kernel
    and dense-kernel applies per firing; ``run.row_views`` names the views
    the row kernel updates in place.  With ``out_of_place`` the dense
    applies go through ``ops.rank_update_batched_out`` (as in
    :func:`build_trigger_fn`); the row applies stay in place.
    """
    binding = dict(program.dims if binding is None else binding)
    written, _ = trigger_touched_views(trigger)
    x = program.inputs[trigger.input_name]
    n_in = _dim(x.shape[0], binding)
    compact = compact_chain_names(trigger) is not None
    row_views = {up.view for up in trigger.updates if up.kind == "lowrank"
                 and trigger.carriers.get(up.view) == "row_local"}

    def run(views: Env, rows, block, v) -> Env:
        dev = views[trigger.input_name].device if device is None else device
        rows = RowSet.of(rows, n_in)
        # copies, never views of the caller's arrays
        block = to_f32(block, dev, copy=True)
        env: Env = dict(views)
        if compact:
            env[trigger.u_var.name] = block
        else:
            u = torch.zeros((n_in, block.shape[1]), dtype=torch.float32,
                            device=dev)
            u[rows.index(dev)] = block
            env[trigger.u_var.name] = u
        env[trigger.v_var.name] = to_f32(v, dev, copy=True)
        cache: Dict[int, torch.Tensor] = {}
        for a in trigger.assigns:
            env[a.name] = evaluate(a.expr, env, binding, cache, dev)
        factors = _firing_factors(trigger.updates, env, views, written)
        for up, fs in zip(trigger.updates, factors):
            if up.kind != "lowrank":
                views[up.view] = views[up.view] + fs[0]
            elif up.view in row_views:
                L = fs[0]
                if not compact:
                    L = L[rows.index(dev)]
                ops.rank_update_rows(views[up.view], rows, L, fs[1],
                                     max_fraction=max_fraction)
            elif out_of_place:
                views[up.view] = ops.rank_update_batched_out(
                    views[up.view], fs[0], fs[1])
            else:
                ops.rank_update_batched(views[up.view], fs[0], fs[1])
        return views

    run.compact = compact
    run.row_views = tuple(sorted(row_views))
    run.row_applies = len([up for up in trigger.updates
                           if up.view in row_views])
    run.dense_applies = sum(up.kind == "lowrank" for up in trigger.updates) \
        - run.row_applies
    return run


def trigger_flops(trigger: Trigger, program: Program,
                  binding: Optional[Dict[str, int]] = None) -> float:
    """Analytic FLOP count of one trigger firing (cost-model §3)."""
    from .cost import _expr_cost_shared, apply_update_cost, shape_of
    binding = dict(program.dims if binding is None else binding)
    total = 0.0
    seen: Dict[int, bool] = {}
    for a in trigger.assigns:
        total += _expr_cost_shared(a.expr, binding, seen).flops
    name_to_var = {**{k: v for k, v in program.inputs.items()},
                   **{s.target.name: s.target for s in program.statements}}
    for up in trigger.updates:
        base = up.view
        if base not in name_to_var and base.startswith("__d"):
            # ΔᵈV auxiliary views share the base view's shape
            base = base.split("__", 2)[-1]
        view = name_to_var[base]
        n, m = shape_of(view, binding)
        if up.kind == "lowrank":
            k = next(a.expr for a in trigger.assigns if a.name == up.u).shape[1] \
                if any(a.name == up.u for a in trigger.assigns) else trigger.rank
            k = k if isinstance(k, int) else binding[k.name]
            total += apply_update_cost((n, m), k).flops
        else:
            total += n * m
    return total
