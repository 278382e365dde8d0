"""Row-sharded IVM execution (paper §6, Data Partitioning / Fig. 3f).

The paper's parallelization claim, executed on ``torch.distributed``: a
compiled trigger is a straight-line chain of (big × skinny) products
followed by rank-k view sweeps, so placing every maintained n×m view
**row-sharded** across the ranks of a mesh axis makes each firing
embarrassingly parallel —

  * factor blocks like ``A·u`` read only local rows of ``A``;
  * transposed reads (``Aᵀ·q``) are local products summed by an
    all-reduce of a *skinny* intermediate, O(m·k) on the wire;
  * the ``M += U Vᵀ`` sweeps are local: each rank applies
    :func:`repro_torch.kernels.ops.rank_update_batched` (the rank-k CUDA
    kernel on the card) to its own contiguous (n/W)×m block.

Re-evaluation on the same layout moves whole matrices: one n×n product
between two row-sharded operands all-gathers O(n²) bytes
(:func:`distributed_reeval_matmul`).

A mesh is a 1-D (or wider) ``torch.distributed.device_mesh.DeviceMesh``
over a process group the caller set up; ``axis`` names the row axis (the
mesh's first by default).  Rank r of a ``"cuda"`` mesh works on
``cuda:(r % device_count)``, so several ranks may share one card; a
``"cpu"`` mesh runs the kernels' plain versions.

Every value of a firing carries a layout beside its local tensor:

  ``R``    row-sharded: the rank's row block of an (n, m) value
           (:func:`row_spec` decides which values can be);
  ``Rep``  replicated: the whole value, bit for bit equal on every rank;
  ``T``    the transpose of an ``R`` value (column-sharded), kept as the
           ``R`` block it transposes.

The product rules (:meth:`Shards.matmul`) keep every collective skinny where
the paper's argument allows it; anything else materialises a value by an
all-gather.  A replicated value is computed by the same operations on
the same bits on every rank, or comes out of a collective, so the ranks
never diverge.  Every collective adds its bytes to :data:`BYTES` by kind.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..core import expr as ex
from ..core.codegen import (_firing_factors, _own, _set_run_attrs,
                            planned_trigger_sets)
from ..core.compiler import Trigger
from ..core.factored import ColSlice, HStack
from ..core.program import Program
from ..kernels import ops
from ..roofline import kernel_work

Env = Dict[str, torch.Tensor]
R, REP, T = "R", "Rep", "T"

#: bytes each rank puts on the wire by collective kind, as a ring moves
#: them: an all-gather (W−1)·local, an all-reduce 2(W−1)/W of the tensor.
#: ``host_staged`` is the part of both that ran over gloo on card tensors,
#: which gloo copies through host memory.  ``calls`` counts collectives.
BYTES: Dict[str, int] = {"all_gather": 0, "all_reduce": 0,
                         "host_staged": 0, "calls": 0}


def reset_bytes() -> None:
    for key in BYTES:
        BYTES[key] = 0


def mesh_axis_name(mesh, axis: Optional[str] = None) -> str:
    return axis or mesh.mesh_dim_names[0]


def mesh_device(mesh) -> torch.device:
    """The device this rank works on: ``cuda:(rank % device_count)`` on
    a ``"cuda"`` mesh (raises without a card), the CPU on a ``"cpu"``
    one."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if mesh.device_type != "cuda":
        raise ValueError(f"unsupported mesh device type "
                         f"{mesh.device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a \"cuda\" mesh needs a CUDA device; build a "
                           "\"cpu\" mesh to run on the CPU")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def _shardable(world: int, shape) -> bool:
    return len(shape) == 2 and shape[0] >= world and shape[0] % world == 0


def row_spec(mesh, axis: Optional[str], shape) -> Tuple:
    """``(axis, None)`` when a value of ``shape`` is row-sharded on the
    mesh axis — 2-D with a leading dim that the axis divides — else
    ``()``, replicated (skinny factors, scalars, ragged views)."""
    axis = mesh_axis_name(mesh, axis)
    world = mesh.shape[mesh.mesh_dim_names.index(axis)]
    return (axis, None) if _shardable(world, tuple(shape)) else ()


def _owned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous storage of exactly its own size: a row block
    sliced from a whole tensor would otherwise keep the whole alive."""
    if (t.is_contiguous() and t.storage_offset() == 0
            and t.untyped_storage().nbytes() == t.numel() * t.element_size()):
        return t
    return t.contiguous().clone()


@dataclass
class _V:
    """A value of a sharded firing: its layout and this rank's tensor."""
    kind: str
    t: torch.Tensor


class Shards:
    """One rank's view of a mesh axis: the group, the world size W along
    the axis, this rank's coordinate, its device, and the counted
    collectives and layout moves of the sharded evaluation."""

    def __init__(self, mesh, axis: Optional[str] = None):
        self.axis = mesh_axis_name(mesh, axis)
        self.group = mesh.get_group(self.axis)
        self.world = mesh.shape[mesh.mesh_dim_names.index(self.axis)]
        self.rank = mesh.get_local_rank(self.axis)
        self.device = mesh_device(mesh)
        self._staged = (self.device.type == "cuda"
                        and dist.get_backend(self.group) == "gloo")

    # -- collectives ------------------------------------------------------
    def _count(self, kind: str, operand: torch.Tensor) -> None:
        """Count one collective of ``operand`` (this rank's block): its
        ring-counted wire bytes, also to an active roofline walk."""
        nbytes = kernel_work.collective(kind, self.axis, self.world,
                                        operand)
        BYTES[kind] += nbytes
        BYTES["calls"] += 1
        if self._staged:
            BYTES["host_staged"] += nbytes

    def all_gather(self, local: torch.Tensor) -> torch.Tensor:
        """The row blocks of every rank stacked in rank order."""
        local = local.contiguous()
        parts = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(parts, local, group=self.group)
        self._count("all_gather", local)
        return torch.cat(parts, dim=0)

    def all_reduce(self, t: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        t = t.contiguous()
        dist.all_reduce(t, op=op, group=self.group)
        self._count("all_reduce", t)
        return t

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (every rank learns it)."""
        x = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        return bool(self.all_reduce(x, dist.ReduceOp.MAX).item())

    # -- layouts ----------------------------------------------------------
    def kind_of(self, shape) -> str:
        """``R`` for a row-shardable shape, else ``Rep``."""
        return R if _shardable(self.world, tuple(shape)) else REP

    def block_shape(self, shape) -> Tuple[int, ...]:
        """The shape of this rank's block of a whole ``shape``."""
        if self.kind_of(shape) == R:
            return (shape[0] // self.world,) + tuple(shape[1:])
        return tuple(shape)

    def rows(self, n: int) -> slice:
        size = n // self.world
        return slice(self.rank * size, (self.rank + 1) * size)

    def rep(self, v: _V) -> _V:
        if v.kind == R:
            return _V(REP, self.all_gather(v.t))
        if v.kind == T:
            return _V(REP, self.all_gather(v.t).T)
        return v

    def local(self, v: _V) -> torch.Tensor:
        """``v``'s row block (``v`` has a row-shardable shape)."""
        if v.kind == T:
            v = self.rep(v)
        if v.kind == REP:
            return v.t[self.rows(v.t.shape[0])]
        return v.t

    def local_t(self, v: _V) -> torch.Tensor:
        """The R block whose transpose is ``v``'s column block."""
        if v.kind == R:
            v = self.rep(v)
        if v.kind == REP:
            return v.t[:, self.rows(v.t.shape[1])].T
        return v.t

    def as_kind(self, v: _V, kind: str) -> torch.Tensor:
        return self.local(v) if kind == R else self.rep(v).t

    # -- products ---------------------------------------------------------
    def matmul(self, a: _V, b: _V) -> _V:
        if a.kind == T and b.kind == T:
            a = self.rep(a)
        if a.kind == REP and b.kind == REP:
            return _V(REP, a.t @ b.t)
        if a.kind == R and b.kind == REP:
            return _V(R, a.t @ b.t)
        if a.kind == T:
            # Aᵀ·B summed over the row blocks: the skinny transposed read
            rows = b.t if b.kind == R else b.t[self.rows(b.t.shape[0])]
            return _V(REP, self.all_reduce(a.t.T @ rows))
        if a.kind == REP and b.kind == T:
            # a·Bᵀ = (B·aᵀ)ᵀ, row-local
            return _V(T, b.t @ a.t.T)
        if a.kind == REP and b.kind == R and 2 * a.t.shape[0] < b.t.shape[0] \
                * self.world:
            # a short left operand: reduce the (p, s) partials instead
            # of gathering the (n, s) right one
            cols = a.t[:, self.rows(a.t.shape[1])]
            return _V(REP, self.all_reduce(cols @ b.t))
        # the right operand must be whole: R·R, R·T, Rep·R
        whole = self.rep(b).t
        return _V(a.kind, a.t @ whole)


# ---------------------------------------------------------------------------
# the sharded evaluate (mirrors repro_torch.core.codegen._eval_node)
# ---------------------------------------------------------------------------


def _dim(d, binding: Dict[str, int]) -> int:
    return binding[d.name] if isinstance(d, ex.Dim) else int(d)


def _combine(vals, sh: Shards):
    """The terms of a sum or a stack in one layout, and that layout."""
    kinds = {v.kind for v in vals}
    if kinds == {REP}:
        return REP, [v.t for v in vals]
    if T in kinds and R not in kinds:
        return T, [sh.local_t(v) for v in vals]
    return R, [sh.local(v) for v in vals]


def _eval_node(x, env: Dict[str, _V], binding, go, sh: Shards) -> _V:
    dev = sh.device
    if isinstance(x, ex.Var):
        try:
            return env[x.name]
        except KeyError:
            raise KeyError(f"unbound variable {x.name}; have {sorted(env)}")
    if isinstance(x, (ex.Zero, ex.Identity)):
        shape = tuple(_dim(d, binding) for d in x.shape)
        kind = sh.kind_of(shape)
        rows = sh.rows(shape[0]) if kind == R else slice(0, shape[0])
        t = torch.zeros((rows.stop - rows.start, shape[1]),
                        dtype=torch.float32, device=dev)
        if isinstance(x, ex.Identity):
            i = torch.arange(rows.start, rows.stop, device=dev)
            t[i - rows.start, i] = 1.0
        return _V(kind, t)
    if isinstance(x, ex.Const):
        return _V(REP, torch.full((1, 1), x.value, dtype=torch.float32,
                                  device=dev))
    if isinstance(x, ex.MatMul):
        return sh.matmul(go(x.lhs), go(x.rhs))
    if isinstance(x, ex.Add):
        kind, terms = _combine([go(t) for t in x.terms], sh)
        return _V(kind, functools.reduce(torch.add, terms))
    if isinstance(x, ex.Scale):
        f = sh.rep(go(x.factor)).t
        if f.dim() == 2:  # (1,1) scalar view
            f = f[0, 0]
        o = go(x.operand)
        return _V(o.kind, f * o.t)
    if isinstance(x, ex.Transpose):
        o = go(x.operand)
        return _V({R: T, T: R, REP: REP}[o.kind],
                  o.t.T if o.kind == REP else o.t)
    if isinstance(x, ex.Inverse):
        a = sh.rep(go(x.operand)).t
        if a.shape == (1, 1):
            return _V(REP, 1.0 / a)
        return _V(REP, torch.linalg.inv_ex(a).inverse)
    if isinstance(x, HStack):
        vals = [go(b) for b in x.blocks]
        if any(v.kind == T for v in vals):
            vals = [sh.rep(v) for v in vals]
        kind, blocks = _combine(vals, sh)
        return _V(kind, torch.cat(blocks, dim=1))
    if isinstance(x, ColSlice):
        o = go(x.operand)
        if o.kind == T:
            o = sh.rep(o)
        return _V(o.kind, o.t[:, x.col:x.col + 1])
    raise TypeError(f"cannot evaluate {type(x).__name__}")


def evaluate(e, env: Dict[str, _V], binding: Dict[str, int], sh: Shards,
             cache: Optional[Dict[int, _V]] = None) -> _V:
    """Evaluate a symbolic expression against layout-tagged local values
    (:func:`repro_torch.core.codegen.evaluate` on a mesh).  ``cache``
    keyed by interned node id shares subcomputations across the blocks
    of one firing."""
    if cache is None:
        cache = {}

    def go(x) -> _V:
        hit = cache.get(id(x))
        if hit is not None:
            return hit
        out = _eval_node(x, env, binding, go, sh)
        cache[id(x)] = out
        return out

    try:
        return go(e)
    finally:
        del go   # break the closure's self-reference (see codegen.evaluate)


def matvec(e, env: Dict[str, _V], binding: Dict[str, int], sh: Shards,
           x: _V) -> _V:
    """``e @ x`` for a skinny probe block ``x`` without materialising
    ``e``: :func:`repro_torch.guard.sentinel.expr_matvec` on a mesh, the
    products by :meth:`Shards.matmul`'s rules (a row block times the
    replicated probe is local; a transposed read an all-reduce of a
    skinny partial; a skinny right operand gathered whole)."""
    if isinstance(e, ex.Var):
        return sh.matmul(env[e.name], x)
    if isinstance(e, ex.Identity):
        return x
    if isinstance(e, ex.Zero):
        return _zeros((_dim(e.shape[0], binding), x.t.shape[1]), sh)
    if isinstance(e, ex.MatMul):
        return matvec(e.lhs, env, binding, sh,
                      matvec(e.rhs, env, binding, sh, x))
    if isinstance(e, ex.Add):
        kind, terms = _combine([matvec(t, env, binding, sh, x)
                                for t in e.terms], sh)
        return _V(kind, functools.reduce(torch.add, terms))
    if isinstance(e, ex.Scale):
        return _scaled(e, env, binding, sh, matvec(e.operand, env, binding,
                                                   sh, x))
    if isinstance(e, ex.Transpose):
        return rmatvec(e.operand, env, binding, sh, x)
    if isinstance(e, ex.Inverse):
        return _solve(e, env, binding, sh, x, transpose=False)
    return sh.matmul(evaluate(e, env, binding, sh), x)


def rmatvec(e, env: Dict[str, _V], binding: Dict[str, int], sh: Shards,
            x: _V) -> _V:
    """``eᵀ @ x`` by the dual recursion (:func:`matvec`)."""
    if isinstance(e, ex.Identity):
        return x
    if isinstance(e, ex.Zero):
        return _zeros((_dim(e.shape[1], binding), x.t.shape[1]), sh)
    if isinstance(e, ex.MatMul):
        return rmatvec(e.rhs, env, binding, sh,
                       rmatvec(e.lhs, env, binding, sh, x))
    if isinstance(e, ex.Add):
        kind, terms = _combine([rmatvec(t, env, binding, sh, x)
                                for t in e.terms], sh)
        return _V(kind, functools.reduce(torch.add, terms))
    if isinstance(e, ex.Scale):
        return _scaled(e, env, binding, sh, rmatvec(e.operand, env, binding,
                                                    sh, x))
    if isinstance(e, ex.Transpose):
        return matvec(e.operand, env, binding, sh, x)
    if isinstance(e, ex.Inverse):
        return _solve(e, env, binding, sh, x, transpose=True)
    v = env[e.name] if isinstance(e, ex.Var) else evaluate(e, env, binding,
                                                           sh)
    return sh.matmul(_V({R: T, T: R, REP: REP}[v.kind],
                        v.t.T if v.kind == REP else v.t), x)


def _zeros(shape, sh: Shards) -> _V:
    kind = sh.kind_of(shape)
    return _V(kind, torch.zeros(sh.block_shape(shape), dtype=torch.float32,
                                device=sh.device))


def _scaled(e, env, binding, sh: Shards, o: _V) -> _V:
    f = sh.rep(evaluate(e.factor, env, binding, sh)).t
    if f.dim() == 2:
        f = f[0, 0]
    return _V(o.kind, f * o.t)


def _solve(e, env, binding, sh: Shards, x: _V, transpose: bool) -> _V:
    """``inv(a) @ x`` (``inv(a)ᵀ @ x``) by a solve against the replicated
    operand ``a``."""
    a = sh.rep(evaluate(e.operand, env, binding, sh)).t
    x = sh.rep(x).t
    if a.shape == (1, 1):
        return _V(REP, x / a)
    return _V(REP, torch.linalg.solve_ex(a.T if transpose else a, x).result)


def probe_sums(expr, view: _V, env: Dict[str, _V], binding: Dict[str, int],
               sh: Shards, x: torch.Tensor) -> Tuple[float, float]:
    """The drift sentinel's residual on a mesh, for one view with
    defining statement ``expr``: (‖expr·x‖², ‖expr·x − view·x‖²), the
    squares summed over the rank's rows and then over the ranks (one
    all-reduce) for a row-sharded view, local for a replicated one, so
    every rank reads the same pair.  ``x`` is the replicated probe."""
    xv = _V(REP, x)
    want = matvec(expr, env, binding, sh, xv)
    got = sh.matmul(view, xv)
    if view.kind == R:
        want, got = sh.local(want), got.t
    else:
        want, got = sh.rep(want).t, sh.rep(got).t
    sums = torch.stack([(want * want).sum(), ((want - got) ** 2).sum()])
    if view.kind == R:
        sums = sh.all_reduce(sums)
    den, num = sums.tolist()
    return den, num


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def view_kinds(program: Program, binding: Dict[str, int],
               world: int) -> Dict[str, str]:
    """``R`` or ``Rep`` for every input and view of ``program``."""
    from ..core.cost import shape_of
    names = {**program.inputs,
             **{st.target.name: st.target for st in program.statements}}
    return {name: R if _shardable(world, shape_of(var, binding)) else REP
            for name, var in names.items()}


def shard_views(views: Env, mesh, axis: Optional[str] = None) -> Env:
    """Keep each rank's row block of every row-shardable view
    (:func:`row_spec`), or the whole tensor when replicated, as owned
    contiguous storage on this rank's device.  Every rank passes the
    same whole views."""
    sh = Shards(mesh, axis)
    out = {}
    for name, x in views.items():
        x = torch.as_tensor(x, dtype=torch.float32).to(sh.device)
        if sh.kind_of(x.shape) == R:
            x = x[sh.rows(x.shape[0])]
        out[name] = _owned(x)
    return out


def gather_views(views: Env, mesh, kinds: Dict[str, str],
                 axis: Optional[str] = None) -> Env:
    """The whole tensors of ``views`` (this rank's blocks, as
    :func:`shard_views` keeps them), whose layouts are ``kinds``
    (:func:`view_kinds`; a Δᵈ view takes its view's, :func:`view_kind`).
    A collective: every rank calls it with the same names, in the same
    order, and every rank gets the whole views."""
    sh = Shards(mesh, axis)
    return {name: (sh.all_gather(x) if view_kind(kinds, name) == R else x)
            for name, x in views.items()}


# ---------------------------------------------------------------------------
# firings
# ---------------------------------------------------------------------------


def view_kind(kinds: Dict[str, str], name: str) -> str:
    """A view's layout; a Δᵈ view (``__d{depth}__V``) shares V's."""
    if name not in kinds and name.startswith("__d"):
        name = name.split("__", 2)[-1]
    return kinds.get(name, REP)


def tagged(views: Env, kinds: Dict[str, str]) -> Dict[str, _V]:
    """The local ``views`` tagged with their layouts (``kinds``)."""
    return {name: _V(view_kind(kinds, name), t) for name, t in views.items()}


def _factor_env(trigger: Trigger, assigns, views: Env, u: torch.Tensor,
                v: torch.Tensor, binding, sh: Shards,
                kinds: Dict[str, str]) -> Dict[str, _V]:
    """The layout-tagged values of a firing: the local views, the whole
    update factors (replicated) and every factor block of ``assigns``,
    evaluated in order against the views as they stand."""
    env = tagged(views, kinds)
    env[trigger.u_var.name] = _V(REP, u)
    env[trigger.v_var.name] = _V(REP, v)
    cache: Dict[int, _V] = {}
    for a in assigns:
        env[a.name] = evaluate(a.expr, env, binding, sh, cache)
    return env


def recompute(statements, views: Env, binding: Dict[str, int], sh: Shards,
              kinds: Dict[str, str]) -> Env:
    """Re-evaluate ``statements`` in program order against the local
    ``views`` (:func:`repro_torch.core.codegen.recompute` on a mesh):
    each result lands in its own layout (``kinds``) as storage of its
    own."""
    cache: Dict[int, _V] = {}
    env = tagged(views, kinds)
    for st in statements:
        name = st.target.name
        kind = view_kind(kinds, name)
        val = _owned(sh.as_kind(evaluate(st.expr, env, binding, sh, cache),
                                kind))
        views[name] = _own(val, [t for k, t in views.items() if k != name])
        env[name] = _V(kind, views[name])
    return views


def build_distributed_evaluator(program: Program, mesh, *,
                                axis: Optional[str] = None,
                                binding: Optional[Dict[str, int]] = None
                                ) -> Callable[[Env], Env]:
    """Full re-evaluation on the mesh: ``run(local inputs) -> {view:
    local block}`` (:func:`repro_torch.core.codegen.build_evaluator`)."""
    binding = dict(program.dims if binding is None else binding)
    sh = Shards(mesh, axis)
    kinds = view_kinds(program, binding, sh.world)

    def run(inputs: Env) -> Env:
        env = recompute(program.statements, dict(inputs), binding, sh, kinds)
        return {st.target.name: env[st.target.name]
                for st in program.statements}

    return run


def build_distributed_trigger(trigger: Trigger, program: Program, mesh, *,
                              axis: Optional[str] = None,
                              binding: Optional[Dict[str, int]] = None,
                              reeval_views=(), lazy_views=(),
                              out_of_place: bool = False) -> Callable:
    """Stage a compiled trigger for row-sharded execution on ``mesh``.

    Returns ``run(views, U, V, nonfinite=None) -> views`` with the
    contract and run attributes of
    :func:`repro_torch.core.codegen.build_trigger_fn`: ``views`` holds
    this rank's blocks (:func:`shard_views`), ``U`` and ``V`` the whole
    update factors, the same on every rank.  The same three-step order:

    1. every kept factor block is evaluated against the old views; each
       low-rank update's left factor is taken on the view's local rows
       (a row block of an ``R`` factor, or a slice of a replicated one)
       and its right factor whole (all-gathered when ``R``: O(m·k)); a
       factor that shares storage with a written view is copied;
    2. each update lands on the local rows: a low-rank one through
       ``ops.rank_update_batched`` in place, or
       ``ops.rank_update_batched_out`` with ``out_of_place``, a dense one
       as ``view + D``;
    3. the re-evaluated statements (``reeval_views``; ``lazy_views`` are
       skipped, :func:`repro_torch.core.codegen.planned_trigger_sets`)
       run through the sharded :func:`recompute`.

    With ``nonfinite`` (out of place) the flag is or-ed over the ranks
    after the applies, so a guarded firing commits or rolls back on
    every rank alike.  Each view's layout comes from the program's
    shapes (:func:`view_kinds`).
    """
    binding = dict(program.dims if binding is None else binding)
    sh = Shards(mesh, axis)
    kinds = view_kinds(program, binding, sh.world)
    assigns, updates, statements, skipped = planned_trigger_sets(
        trigger, program, reeval_views, lazy_views)
    written = tuple(dict.fromkeys(up.view for up in updates))

    def place(up, side: int, f: _V) -> torch.Tensor:
        # the rows of the view's block, or a whole right factor: O(m·k)
        # gathered when it is row-sharded
        return sh.as_kind(f, view_kind(kinds, up.view)) if side == 0 \
            else sh.rep(f).t

    def run(views: Env, u: torch.Tensor, v: torch.Tensor,
            nonfinite: Optional[torch.Tensor] = None) -> Env:
        env = _factor_env(trigger, assigns, views, u, v, binding, sh, kinds)
        factors = _firing_factors(updates, env, views,
                                  () if out_of_place else written,
                                  place=place)
        del env
        for up, fs in zip(updates, factors):
            if up.kind != "lowrank":
                views[up.view] = views[up.view] + fs[0]
            elif out_of_place:
                views[up.view] = ops.rank_update_batched_out(
                    views[up.view], fs[0], fs[1], nonfinite)
            else:
                ops.rank_update_batched(views[up.view], fs[0], fs[1])
        del factors
        views = recompute(statements, views, binding, sh, kinds)
        if nonfinite is not None:
            from ..guard.txn import nonfinite as any_nonfinite
            if run.unflagged:
                nonfinite.bitwise_or_(any_nonfinite(
                    *(views[n] for n in run.unflagged)).to(torch.int32))
            nonfinite.copy_(sh.all_reduce(nonfinite.clone(),
                                          dist.ReduceOp.MAX))
        return views

    _set_run_attrs(run, updates, statements, skipped, reeval_views, written)
    return run


def firing_values(trigger: Trigger, program: Program, views: Env,
                  u: torch.Tensor, v: torch.Tensor, mesh, *,
                  axis: Optional[str] = None,
                  binding: Optional[Dict[str, int]] = None
                  ) -> Dict[str, Tuple[str, torch.Tensor]]:
    """The factor blocks one firing of ``trigger`` computes, each with its
    layout (``R``, ``Rep`` or ``T``) and this rank's tensor, evaluated
    against ``views`` (this rank's blocks) without any apply: what a
    firing keeps replicated, for checking that every rank holds the same
    bits."""
    binding = dict(program.dims if binding is None else binding)
    sh = Shards(mesh, axis)
    env = _factor_env(trigger, trigger.assigns, views, u, v, binding, sh,
                      view_kinds(program, binding, sh.world))
    return {a.name: (env[a.name].kind, env[a.name].t)
            for a in trigger.assigns}


# the reference's name for a firing under a plan's partition (re-evaluated
# views are recomputed by the sharded evaluate, the same row-sharded
# product chain the re-evaluation baseline runs)
build_distributed_planned_trigger = build_distributed_trigger


def distributed_reeval_matmul(mesh, *, axis: Optional[str] = None
                              ) -> Callable[[torch.Tensor, torch.Tensor],
                                            torch.Tensor]:
    """The re-evaluation baseline on the same layout: ``fn(a, b)`` takes
    this rank's row blocks of ``A`` and ``B`` and returns its row block
    of ``A @ B``.  The right operand is all-gathered first — O(n·m) on
    the wire, the re-evaluation data movement the paper charges against
    REEVAL in §6."""
    sh = Shards(mesh, axis)

    def fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return sh.matmul(_V(R, a), _V(R, b)).t

    return fn
