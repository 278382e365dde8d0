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
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels import ops
from ..kernels.rank_update_rows import RowSet
from . import expr as ex
from .compiler import Trigger
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
        return torch.linalg.inv(a)
    if isinstance(x, HStack):
        return torch.cat([go(b) for b in x.blocks], dim=1)
    if isinstance(x, ColSlice):
        return go(x.operand)[:, x.col:x.col + 1]
    raise TypeError(f"cannot evaluate {type(x).__name__}")


def _shares_storage(x: torch.Tensor, others) -> bool:
    ptr = x.untyped_storage().data_ptr()
    return any(o.untyped_storage().data_ptr() == ptr for o in others)


# ---------------------------------------------------------------------------
# program re-evaluation (the paper's baseline strategy)
# ---------------------------------------------------------------------------


def build_evaluator(program: Program,
                    binding: Optional[Dict[str, int]] = None,
                    device=None) -> Callable[[Env], Env]:
    """Full re-evaluation: returns {view name: value} for all statements.

    Every returned view owns contiguous storage of its own: a statement
    that evaluates to an input, another view, or a transpose of one
    (``.T`` is a torch view) is copied, so the in-place applies of a
    later firing never write through to a second name.
    """
    binding = dict(program.dims if binding is None else binding)

    def run(inputs: Env) -> Env:
        env: Env = dict(inputs)
        cache: Dict[int, torch.Tensor] = {}
        out: Env = {}
        for st in program.statements:
            val = evaluate(st.expr, env, binding, cache, device)
            if not val.is_contiguous() or _shares_storage(
                    val, list(inputs.values()) + list(out.values())):
                val = val.contiguous().clone()
            env[st.target.name] = val
            out[st.target.name] = val
        return out

    return run


# ---------------------------------------------------------------------------
# trigger execution (the incremental strategy)
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


def _firing_factors(trigger: Trigger, env: Env, views: Env,
                    written) -> Env:
    """The contiguous factor blocks of a firing's updates.  The kernels
    take contiguous factors; a factor that shares storage with a view
    written in the same firing must not see an earlier update of that
    firing, so it gets its own copy."""
    targets = [views[name] for name in written]
    factors = {}
    for up in trigger.updates:
        for name in (up.u, up.v) if up.kind == "lowrank" else (up.d,):
            f = env[name]
            if _shares_storage(f, targets):
                f = f.clone(memory_format=torch.contiguous_format)
            factors[name] = f.contiguous()
    return factors


def build_trigger_fn(trigger: Trigger, program: Program,
                     binding: Optional[Dict[str, int]] = None,
                     device=None) -> Callable[[Env, torch.Tensor,
                                               torch.Tensor], Env]:
    """Stage a trigger into ``(views, U, V) -> views``.

    ``views`` must contain the input matrices and every maintained view.
    All factor blocks are evaluated against the pre-update views (the
    delta derivation's contract), then each low-rank update runs the
    rank-k kernel in place on its view; a dense (hybrid) update replaces
    the view with ``view + D``.  The dict is updated and returned.
    ``run.lowrank_applies`` is the number of rank-k applies per firing.
    """
    binding = dict(program.dims if binding is None else binding)
    written, _ = trigger_touched_views(trigger)

    def run(views: Env, u: torch.Tensor, v: torch.Tensor) -> Env:
        env: Env = dict(views)
        env[trigger.u_var.name] = u
        env[trigger.v_var.name] = v
        cache: Dict[int, torch.Tensor] = {}
        for a in trigger.assigns:
            env[a.name] = evaluate(a.expr, env, binding, cache, device)
        factors = _firing_factors(trigger, env, views, written)
        for up in trigger.updates:
            if up.kind == "lowrank":
                ops.rank_update_batched(views[up.view], factors[up.u],
                                        factors[up.v])
            else:
                views[up.view] = views[up.view] + factors[up.d]
        return views

    run.lowrank_applies = sum(up.kind == "lowrank" for up in trigger.updates)
    return run


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
                              device=None, max_fraction: float = 0.25
                              ) -> Callable:
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
    and dense-kernel applies per firing.
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
        factors = _firing_factors(trigger, env, views, written)
        for up in trigger.updates:
            if up.kind != "lowrank":
                views[up.view] = views[up.view] + factors[up.d]
            elif up.view in row_views:
                L = factors[up.u]
                if not compact:
                    L = L[rows.index(dev)]
                ops.rank_update_rows(views[up.view], rows, L, factors[up.v],
                                     max_fraction=max_fraction)
            else:
                ops.rank_update_batched(views[up.view], factors[up.u],
                                        factors[up.v])
        return views

    run.compact = compact
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
