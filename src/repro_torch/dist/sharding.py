"""Mesh-aware placement of the models: logical axes → mesh axes → each
rank's local block, and the collectives of explicit SPMD.

The port of the JAX package's ``dist/sharding.py``.  The models annotate
parameters with *logical* axis names (``axes_mlp() -> {"w_in": ("fsdp",
"ff"), ...}``); this module owns their translation to placement on a
``torch.distributed.device_mesh.DeviceMesh`` (``launch/mesh.py``):

  * a :class:`ShardingCtx` (mesh + logical→mesh rules) is installed with
    the :func:`use_sharding` context manager;
  * :func:`resolve_spec` is the reference's resolution, rule for rule, and
    returns the port's :class:`PartitionSpec` (a tuple);
    :func:`named_sharding` / :func:`tree_shardings` pair specs with the
    mesh, per leaf.

The reference relies on GSPMD: an annotation only constrains placement,
and the compiler inserts whatever collectives the layout needs.  The
port's kernels are raw CUDA entries that no tensor subclass dispatches
through, so the port runs *explicit* SPMD instead (Megatron-style): each
rank holds the local block of every parameter (:func:`shard_tree`),
computes on it, and calls the collectives below itself — tensor and
expert parallelism on the ``model`` axis, data parallelism on the
``batch`` axes (``pod``, ``data``).  The layers read from their local
shapes which dimensions are split, so the layout decides, and the
numbers stay the single-device numbers.  :func:`shard` is therefore the
identity.  A dimension that packs several parts (Mamba2's ``in_proj``:
z, x, B, C, dt) is placed part by part (:class:`Packed`), so that a
rank's block holds whole heads of each split part beside the replicated
ones.

Every rank must issue the same collectives in the same order (the remat
recompute re-runs the forward's reduces inside the backward, which is
correct only under that invariant).  An axis of size 1 issues none.
Every collective adds the bytes a rank puts on the wire, ring counted, to
:data:`BYTES`, and reports itself to an active roofline walk
(:mod:`repro_torch.roofline.op_walk`).
"""

from __future__ import annotations

import contextlib
import math
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..roofline import kernel_work

AxisName = Union[str, None]
# one logical name may map to several mesh axes (e.g. batch → (pod, data))
Rules = Dict[str, Union[str, Tuple[str, ...], None]]

# Default logical→mesh rules for the production meshes
# (("data", "model") single-pod, ("pod", "data", "model") multi-pod).
# "seq_sp" (Megatron-style sequence parallelism) and "fsdp" are off by
# default, as in the reference.
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "ff": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "fsdp": None,
    "seq_sp": None,
    "cache_seq": None,
}

#: the mesh axis that tensor and expert parallelism run on
MODEL = "model"

#: bytes each rank puts on the wire, ring counted: an all-reduce moves
#: 2(W−1)/W of its tensor, an all-gather (W−1) local blocks.  By kind
#: (``all_reduce``, ``all_gather``), by mesh axis (``on_<axis>``: the
#: model axis's tensor-parallel reduces and the batch axes' gradient
#: and loss means), ``host_staged`` (the part that gloo ran on card
#: tensors, which it copies through host memory) and ``calls``.
BYTES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "host_staged": 0,
                         "calls": 0}


def reset_bytes() -> None:
    BYTES.clear()
    BYTES.update(all_reduce=0, all_gather=0, host_staged=0, calls=0)


class Packed(tuple):
    """The placement of a *packed* dimension: parts laid end to end, each
    ``(width, entry)`` with ``entry`` None (replicated) or what splits it
    (mesh axes in a :class:`PartitionSpec`, a logical name in an axes
    tree).  A rank's block of the dimension is every part's block, in the
    parts' order: Mamba2's ``in_proj`` packs z, x, B, C and dt into one
    dimension, of which z, x and dt split by heads and B and C stay
    whole."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple((int(w), e) for w, e in parts))

    @property
    def width(self) -> int:
        return sum(w for w, _ in self)

    def __repr__(self) -> str:
        return f"Packed{tuple.__repr__(self)}"


class PartitionSpec(tuple):
    """One entry a dimension: a mesh axis name, a tuple of them, or None
    (replicated); trailing Nones are left out, as in JAX's."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class MeshShape:
    """A mesh's shape and axis names without a process group: what
    :func:`resolve_spec` reads, for planning placements (and testing
    them) on meshes larger than the world.  ``coords`` places this rank
    on the mesh ({axis: index}; 0 on an axis it does not name), which is
    what :func:`local_block` reads."""

    device_type = "cpu"

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 coords: Optional[Dict[str, int]] = None):
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axis_names)
        self.coords = dict(coords or {})

    def get_local_rank(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def get_group(self, axis: str):
        raise RuntimeError("a MeshShape has no process group")


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (or a :class:`MeshShape`)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class ShardingCtx:
    """Active placement context: a mesh plus logical→mesh axis rules."""

    mesh: Optional[Any] = None
    rules: Rules = field(default_factory=dict)

    def mesh_axes_for(self, logical: AxisName) -> Tuple[str, ...]:
        """Mesh axes a logical axis maps to on *this* mesh (may be ())."""
        if logical is None or self.mesh is None:
            return ()
        names = self.mesh.mesh_dim_names
        if logical in self.rules:
            mapped = self.rules[logical]
        elif logical in names:
            mapped = logical          # direct mesh-axis reference
        else:
            mapped = None
        if mapped is None:
            return ()
        if isinstance(mapped, str):
            mapped = (mapped,)
        return tuple(a for a in mapped if a in names)

    # -- the rank's place on the mesh (port-only) ---------------------------
    def size(self, axes: Union[str, Sequence[str]]) -> int:
        """Ranks along ``axes`` (1 for an axis the mesh lacks)."""
        if self.mesh is None:
            return 1
        sizes = axis_sizes(self.mesh)
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(sizes.get(a, 1) for a in axes)

    def coord(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's index along ``axes``, the first axis major."""
        if self.mesh is None:
            return 0
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        sizes = axis_sizes(self.mesh)
        idx = 0
        for a in axes:
            if a in sizes:
                idx = idx * sizes[a] + self.mesh.get_local_rank(a)
        return idx

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes the batch is split over (data parallelism)."""
        return self.mesh_axes_for("batch")

    @property
    def tp(self) -> int:
        """Ranks of the tensor / expert parallel (``model``) axis."""
        return self.size(MODEL)

    @property
    def fsdp_axes(self) -> Tuple[str, ...]:
        """The mesh axes the ``"fsdp"`` rule splits parameters over (()
        when it is off or its axes are all of size 1)."""
        axes = self.mesh_axes_for("fsdp")
        return axes if self.size(axes) > 1 else ()


_CTX: ContextVar[ShardingCtx] = ContextVar(
    "repro_torch_sharding_ctx",
    default=ShardingCtx(mesh=None, rules=DEFAULT_RULES))


def current_ctx() -> ShardingCtx:
    """The innermost active context (mesh is None outside use_sharding)."""
    return _CTX.get()


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[Rules] = None):
    """Install ``mesh`` (plus optional rule overrides) for the duration.

    >>> with use_sharding(make_local_mesh(2, device_type="cpu")) as ctx:
    ...     state = init_train_state(model, generator)   # local blocks
    ...     step = make_train_step(model)
    """
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    with installed(ShardingCtx(mesh=mesh, rules=merged)) as ctx:
        yield ctx


@contextlib.contextmanager
def installed(ctx: ShardingCtx):
    """Install ``ctx`` itself for the duration: code that runs in another
    thread, such as a remat recompute in autograd's device thread (which
    starts without the caller's context variables), runs under the
    placement its forward saw."""
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def resolve_spec(axes: Sequence[AxisName],
                 shape: Optional[Sequence[int]],
                 ctx: Optional[ShardingCtx] = None) -> PartitionSpec:
    """Logical axes (one per dimension) → a PartitionSpec valid on the
    active mesh.

    Drops (replicates) any dimension whose mapped mesh axes are absent,
    already claimed by an earlier dimension, or do not divide the
    dimension size (checked when ``shape`` is given).
    """
    ctx = ctx or current_ctx()
    if ctx.mesh is None:
        return P()
    sizes = axis_sizes(ctx.mesh)
    used: set = set()

    def entry(logical, dim: Optional[int], taken: set):
        mesh_axes = []
        for a in ctx.mesh_axes_for(logical):
            if a in used:
                continue
            size = sizes[a]
            if dim is not None:
                span = size * math.prod(sizes[x] for x in mesh_axes)
                if dim % span != 0 or span > dim:
                    continue
            mesh_axes.append(a)
            taken.add(a)
        if not mesh_axes:
            return None
        return mesh_axes[0] if len(mesh_axes) == 1 else tuple(mesh_axes)

    out = []
    for i, logical in enumerate(axes):
        if isinstance(logical, Packed):
            # each part resolves on its own width; the parts of one
            # dimension may share an axis, later dimensions may not
            taken: set = set()
            parts = [(w, entry(name, w, taken)) for w, name in logical]
            used.update(taken)
            out.append(Packed(*parts) if any(e for _, e in parts)
                       else None)
            continue
        dim = None if shape is None else int(shape[i])
        out.append(entry(logical, dim, used))
    while out and out[-1] is None:          # trailing Nones are implicit
        out.pop()
    return P(*out)


def aligned_spec(axes: Sequence[AxisName], shape: Sequence[int],
                 units: Sequence[int],
                 ctx: Optional[ShardingCtx] = None) -> PartitionSpec:
    """The port's placement: :func:`resolve_spec`, then every dimension
    whose split would cut one of its ``units`` (``units[i]`` consecutive
    entries that belong together, such as a head's ``head_dim`` columns of
    a flattened ``H·hd`` projection) replicated instead.  The reference
    checks divisibility on entries only, so it splits a single KV head of
    32 columns into two halves on ``model = 2``; the port never cuts a
    head (the standard GQA rule: KV heads are replicated when there are
    fewer of them than model ranks).  A :class:`Packed` dimension's
    units are one a part, and each part is held to its own."""
    ctx = ctx or current_ctx()
    spec = list(resolve_spec(axes, shape, ctx))

    def whole_units(width: int, unit: int, entry) -> bool:
        return unit <= 1 or (width // unit) % ctx.size(
            _entry_axes(entry)) == 0

    for i, entry in enumerate(spec):
        if isinstance(entry, Packed):
            # a packed dimension's units are its parts' (one a part)
            parts = [(w, e if e is None or whole_units(w, u, e) else None)
                     for (w, e), u in zip(entry, units[i])]
            spec[i] = Packed(*parts) if any(e for _, e in parts) else None
        elif entry is not None and not whole_units(int(shape[i]),
                                                   units[i], entry):
            spec[i] = None
    while spec and spec[-1] is None:
        spec.pop()
    return P(*spec)


def named_sharding(axes: Sequence[AxisName],
                   shape: Optional[Sequence[int]] = None,
                   ctx: Optional[ShardingCtx] = None):
    """(mesh, spec) on the active mesh for one tensor: the placement the
    reference's ``NamedSharding`` names.  ``named_sharding((), None)`` is
    the replicated placement (scalars, generators, step counters)."""
    ctx = ctx or current_ctx()
    if ctx.mesh is None:
        raise ValueError("named_sharding needs an active mesh "
                         "(wrap in use_sharding)")
    return ctx.mesh, resolve_spec(axes, shape, ctx)


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def is_axes_leaf(x: Any) -> bool:
    """A logical-axes tuple or a PartitionSpec: a leaf of an axes tree."""
    if isinstance(x, PartitionSpec):
        return True
    return (isinstance(x, tuple) and not _is_namedtuple(x)
            and not isinstance(x, Packed) and all(
                isinstance(e, (str, type(None), Packed)) for e in x))


def map_axes(fn: Callable, axes_tree: Any, *trees: Any) -> Any:
    """``fn(axes_leaf, *leaves)`` over an axes tree and like-shaped trees
    (nested dicts, NamedTuples, lists); a None leaf stays None."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if axes_tree is None:
        return None
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, axes_tree[k], *(t[k] for t in trees))
                for k in axes_tree}
    if _is_namedtuple(axes_tree):
        return type(axes_tree)(*(
            map_axes(fn, getattr(axes_tree, f),
                     *(getattr(t, f) for t in trees))
            for f in axes_tree._fields))
    if isinstance(axes_tree, (tuple, list)):
        return type(axes_tree)(map_axes(fn, a, *(t[i] for t in trees))
                               for i, a in enumerate(axes_tree))
    raise TypeError(f"not an axes tree: {axes_tree!r}")


def tree_shardings(axes_tree: Any, shapes_tree: Any,
                   ctx: Optional[ShardingCtx] = None) -> Any:
    """Map a logical-axes tree + matching tensors (or shapes) → per-leaf
    ``(mesh, PartitionSpec)`` placements."""
    ctx = ctx or current_ctx()
    return map_axes(lambda ax, s: named_sharding(
        ax, tuple(getattr(s, "shape", s)), ctx), axes_tree, shapes_tree)


def shard(x: torch.Tensor, *axes: AxisName) -> torch.Tensor:
    """The identity.  The reference constrains ``x``'s placement here and
    lets GSPMD insert collectives; in the port's explicit SPMD, ``x`` is
    already this rank's local block and the layers call their collectives
    themselves, so the annotation has nothing left to do."""
    return x


# -- local blocks -----------------------------------------------------------


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, Packed):
        out: Tuple[str, ...] = ()
        for _, e in entry:
            out += tuple(a for a in _entry_axes(e) if a not in out)
        return out
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Sequence) -> Tuple[str, ...]:
    """Every mesh axis a spec splits some dimension over."""
    return tuple(a for e in spec for a in _entry_axes(e))


def _as_spec(axes, shape, ctx: ShardingCtx) -> PartitionSpec:
    return axes if isinstance(axes, PartitionSpec) else resolve_spec(
        axes, shape, ctx)


def local_block(x: torch.Tensor, spec: Sequence,
                ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``: owned
    storage when anything was cut (a view would keep the whole alive),
    ``x`` itself when the spec replicates it."""
    ctx = ctx or current_ctx()
    out = x
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        if isinstance(entry, Packed):
            out = _packed_block(out, dim, entry, ctx)
            continue
        parts = ctx.size(axes)
        step = x.shape[dim] // parts
        out = out.narrow(dim, ctx.coord(axes) * step, step)
    return out if out is x else out.contiguous().clone()


def _packed_block(x: torch.Tensor, dim: int, packed: Packed,
                  ctx: ShardingCtx) -> torch.Tensor:
    """The rank's block of a packed dimension: each part's block, in the
    parts' order."""
    if x.shape[dim] != packed.width:
        raise ValueError(f"a packed dimension of {packed.width} entries "
                         f"has {x.shape[dim]}")
    pieces, lo = [], 0
    for width, entry in packed:
        piece = x.narrow(dim, lo, width)
        axes = _entry_axes(entry)
        if axes:
            step = width // ctx.size(axes)
            piece = piece.narrow(dim, ctx.coord(axes) * step, step)
        pieces.append(piece)
        lo += width
    return torch.cat(pieces, dim=dim)


def global_shape(shape: Sequence[int], spec: Sequence,
                 ctx: Optional[ShardingCtx] = None) -> Tuple[int, ...]:
    """The whole tensor's shape from a local block's ``shape`` under
    ``spec``."""
    ctx = ctx or current_ctx()
    out = list(shape)
    for dim, entry in enumerate(spec):
        if isinstance(entry, Packed):
            out[dim] = entry.width
        elif _entry_axes(entry):
            out[dim] *= ctx.size(_entry_axes(entry))
    return tuple(out)


def shard_tree(full_tree: Any, axes_tree: Any,
               ctx: Optional[ShardingCtx] = None) -> Any:
    """The rank's local blocks of a tree of whole tensors.  ``axes_tree``
    mirrors it with PartitionSpecs (:meth:`LM.param_specs`) or logical
    axes, resolved against each whole leaf's shape."""
    ctx = ctx or current_ctx()
    return map_axes(lambda ax, x: local_block(x, _as_spec(ax, x.shape, ctx),
                                              ctx), axes_tree, full_tree)


def gather(x: torch.Tensor, dim: int, axes: Union[str, Sequence[str]],
           ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """The blocks of every rank along ``axes`` concatenated along ``dim``
    in their order (no gradient): the inverse of :func:`local_block` for
    one dimension."""
    ctx = ctx or current_ctx()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for axis in reversed(axes):          # the minor axis first
        if ctx.size(axis) == 1:
            continue
        x = _all_gather(x.detach(), dim, axis, ctx)
    return x


def gather_tree(local_tree: Any, specs: Any,
                ctx: Optional[ShardingCtx] = None) -> Any:
    """Whole tensors from a tree of local blocks, by all-gathers along
    every split dimension.  ``specs`` mirrors the tree with
    PartitionSpecs (local shapes no longer say what divided); a
    collective over the spec's axes, so every rank on them calls it."""
    ctx = ctx or current_ctx()

    def one(spec, x):
        for dim, entry in enumerate(spec):
            if isinstance(entry, Packed):
                x = gather_packed(x, dim, entry, ctx)
            elif _entry_axes(entry):
                x = gather(x, dim, _entry_axes(entry), ctx)
        return x

    return map_axes(one, specs, local_tree)


def gather_packed(x: torch.Tensor, dim: int, packed: Packed,
                  ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """The whole packed dimension from every rank's block (no gradient):
    one all-gather of the blocks, then each split part's blocks in rank
    order and each replicated part from the first rank's block."""
    ctx = ctx or current_ctx()
    axes = _entry_axes(packed)
    if any(_entry_axes(e) not in ((), axes) for _, e in packed):
        raise ValueError(f"{packed!r}: its parts split over different axes")
    return assemble_packed(
        gather(x, dim, axes, ctx).split(x.shape[dim], dim=dim), dim, packed)


def assemble_packed(blocks: Sequence[torch.Tensor], dim: int,
                    packed: Packed) -> torch.Tensor:
    """The whole packed dimension from the blocks of every rank along its
    axes, in rank order: each split part's blocks concatenated, each
    replicated part from the first block."""
    world = len(blocks)
    pieces, lo = [], 0
    for width, entry in packed:
        if _entry_axes(entry):
            step = width // world
            pieces += [b.narrow(dim, lo, step) for b in blocks]
        else:
            step = width
            pieces.append(blocks[0].narrow(dim, lo, step))
        lo += step
    return torch.cat(pieces, dim=dim)


# -- collectives ------------------------------------------------------------


def _count(kind: str, axis: str, world: int, t: torch.Tensor,
           group) -> None:
    """Count one collective of ``t`` (the operand: a rank's block) over
    the ``world`` ranks of ``axis``."""
    nbytes = kernel_work.collective(kind, axis, world, t)
    BYTES[kind] += nbytes
    BYTES[f"on_{axis}"] = BYTES.get(f"on_{axis}", 0) + nbytes
    BYTES["calls"] += 1
    if t.is_cuda and dist.get_backend(group) == "gloo":
        BYTES["host_staged"] += nbytes


def all_reduce(t: torch.Tensor, axes: Union[str, Sequence[str]],
               ctx: Optional[ShardingCtx] = None, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``t`` reduced in place over every rank along ``axes`` (one
    all-reduce an axis of size > 1, in the given order); returns it."""
    ctx = ctx or current_ctx()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for axis in axes:
        world = ctx.size(axis)
        if world == 1:
            continue
        group = ctx.mesh.get_group(axis)
        dist.all_reduce(t, op=op, group=group)
        _count("all_reduce", axis, world, t, group)
    return t


def _all_gather(x: torch.Tensor, dim: int, axis: str,
                ctx: ShardingCtx) -> torch.Tensor:
    world = ctx.size(axis)
    group = ctx.mesh.get_group(axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    _count("all_gather", axis, world, x, group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward: the entry of a model-parallel
    region, whose ranks each send back part of the input's gradient.
    With ``cols`` (lo, hi) only those entries of the last dimension
    entered (the replicated part of a packed block); the rest of the
    gradient is the rank's own."""

    @staticmethod
    def forward(fctx, x, ctx, cols):
        fctx.ctx, fctx.cols = ctx, cols
        return x.view_as(x)

    @staticmethod
    def backward(fctx, grad):
        if fctx.cols is None:
            return all_reduce(grad.contiguous().clone(), MODEL,
                              fctx.ctx), None, None
        lo, hi = fctx.cols
        grad = grad.clone()
        grad[..., lo:hi] = all_reduce(grad[..., lo:hi].contiguous(), MODEL,
                                      fctx.ctx)
        return grad, None, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the exit of a model-parallel
    region, summing its ranks' partial outputs."""

    @staticmethod
    def forward(fctx, x, ctx):
        return all_reduce(x.contiguous().clone(), MODEL, ctx)

    @staticmethod
    def backward(fctx, grad):
        return grad, None


class _SumOverModel(torch.autograd.Function):
    """All-reduce forward and backward: a sum over the model ranks of which
    each rank then reads a part of its own (the split-width RMSNorm's sum
    of squares, the mLSTM's gate partials), so that the gradient of each
    rank's part is the sum of every rank's reads."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return all_reduce(x.contiguous().clone(), MODEL, ctx)

    @staticmethod
    def backward(fctx, grad):
        return all_reduce(grad.contiguous().clone(), MODEL, fctx.ctx), None


class _GatherFromModel(torch.autograd.Function):
    """All-gather forward along ``dim``, the rank's own slice backward."""

    @staticmethod
    def forward(fctx, x, dim, ctx):
        fctx.dim, fctx.ctx, fctx.width = dim, ctx, x.shape[dim]
        return _all_gather(x, dim, MODEL, ctx)

    @staticmethod
    def backward(fctx, grad):
        lo = fctx.ctx.coord(MODEL) * fctx.width
        return grad.narrow(fctx.dim, lo, fctx.width).contiguous(), None, None


def copy_to_model(x: torch.Tensor,
                  cols: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``x`` entering a model-parallel region (the identity without one);
    with ``cols`` (lo, hi) only ``x[..., lo:hi]`` enters, the replicated
    part of a rank's packed block.

    Not ``torch.distributed.nn.functional.all_reduce``: its backward
    all-reduces the gradient again, which would make every gradient
    upstream ``model``× too large."""
    ctx = current_ctx()
    return x if ctx.tp == 1 else _CopyToModel.apply(x, ctx, cols)


def params_to_model(params: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Each of a block's replicated ``params`` entering the model region
    (:func:`copy_to_model`): where every rank reads them on its part of
    the work only (its positions under the ``"seq_sp"`` rule), their
    gradients are summed over the model ranks."""
    return {name: copy_to_model(w) for name, w in params.items()}


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model ranks' ``x``, which each rank reads only in
    part (see :class:`_SumOverModel`; the identity without a model
    axis)."""
    ctx = current_ctx()
    return x if ctx.tp == 1 else _SumOverModel.apply(x, ctx)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model ranks' partial ``x`` (the identity without a
    model axis)."""
    ctx = current_ctx()
    return x if ctx.tp == 1 else _ReduceFromModel.apply(x, ctx)


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model ranks' blocks of ``x`` concatenated along ``dim``."""
    ctx = current_ctx()
    if ctx.tp == 1:
        return x
    return _GatherFromModel.apply(x, dim % x.dim(), ctx)


class _GatherFromData(torch.autograd.Function):
    """All-gather forward along ``dim`` over ``axes`` (the ``"fsdp"``
    rule's), a reduce-scatter backward: the gradient summed over those
    axes, of which the rank keeps its own block.  gloo has no
    reduce-scatter, so the sum is an all-reduce (counted as one, under
    each axis) followed by the rank's slice."""

    @staticmethod
    def forward(fctx, x, dim, axes, ctx):
        fctx.dim, fctx.axes, fctx.ctx = dim, axes, ctx
        fctx.width = x.shape[dim]
        return gather(x, dim, axes, ctx)

    @staticmethod
    def backward(fctx, grad):
        ctx, width = fctx.ctx, fctx.width
        summed = all_reduce(grad.contiguous().clone(), fctx.axes, ctx)
        lo = ctx.coord(fctx.axes) * width
        return (summed.narrow(fctx.dim, lo, width).contiguous(), None, None,
                None)


def gather_from_data(x: torch.Tensor, dim: int,
                     axes: Union[str, Sequence[str]]) -> torch.Tensor:
    """The whole of a parameter block split along ``dim`` over ``axes``
    (the ``"fsdp"`` rule's mesh axes), for one layer's use: the blocks of
    every rank on those axes concatenated in their order; its gradient
    is summed over them and each rank keeps its block (see
    :class:`_GatherFromData`).  The identity when the axes hold one
    rank."""
    ctx = current_ctx()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if ctx.size(axes) == 1:
        return x
    return _GatherFromData.apply(x, dim % x.dim(), axes, ctx)


# -- the sequence axes: "cache_seq" (decode) and "seq_sp" (training) ----------


def merge_decode_partials(out: torch.Tensor, lse: torch.Tensor,
                          axes: Union[str, Sequence[str]]) -> torch.Tensor:
    """One decode step's attention from every rank's partial over its
    slots of a cache split along ``axes`` (the ``"cache_seq"`` rule's):
    ``out`` (B, H, hd) f32 and ``lse`` (B, H), as
    :func:`repro_torch.kernels.ops.flash_decode_lse` gives them.  One
    all-gather of both (packed), then the merge in rank order: M = max_r
    lse_r, w_r = exp(lse_r - M) (0 for a rank with no valid slot, lse
    -inf), out = sum_r w_r out_r / sum_r w_r.  Every rank gets the whole
    merge.  Forward only: a decode step takes no gradient."""
    ctx = current_ctx()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if ctx.size(axes) == 1:
        return out
    packed = torch.cat([out, lse[..., None]], dim=-1)[None]
    parts = gather(packed, 0, axes, ctx)          # (n, B, H, hd + 1)
    return merge_partials(parts[..., :-1], parts[..., -1])


def merge_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The merge of :func:`merge_decode_partials` on stacked partials,
    outs (n, ..., hd) and lses (n, ...), summed in their order; rows with
    no valid slot anywhere give 0."""
    top = lses.max(dim=0).values
    w = torch.exp(lses - torch.where(torch.isfinite(top), top, 0.0))
    num, den = w[0, ..., None] * outs[0], w[0]
    for r in range(1, outs.shape[0]):
        num = num + w[r, ..., None] * outs[r]
        den = den + w[r]
    return torch.where(den[..., None] > 0, num / den[..., None], 0.0)


def _reduce_scatter(x: torch.Tensor, dim: int, axes: Tuple[str, ...],
                    ctx: ShardingCtx) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, of which this rank
    keeps its block along ``dim``: gloo has no reduce-scatter, so an
    all-reduce (counted as one, under each axis) and the rank's slice,
    as :class:`_GatherFromData`'s backward."""
    summed = all_reduce(x.contiguous().clone(), axes, ctx)
    width = x.shape[dim] // ctx.size(axes)
    return summed.narrow(dim, ctx.coord(axes) * width,
                         width).contiguous()


def _own_block(x: torch.Tensor, dim: int, axes: Tuple[str, ...],
               ctx: ShardingCtx) -> torch.Tensor:
    width = x.shape[dim] // ctx.size(axes)
    return x.narrow(dim, ctx.coord(axes) * width, width).contiguous()


class _ScatterToSeq(torch.autograd.Function):
    """The rank's block along ``dim`` forward, all-gather backward: where
    a whole sequence, the same on every rank, splits over the ``seq_sp``
    axes (the residual stream entering the first block)."""

    @staticmethod
    def forward(fctx, x, dim, axes, ctx):
        fctx.dim, fctx.axes, fctx.ctx = dim, axes, ctx
        return _own_block(x, dim, axes, ctx)

    @staticmethod
    def backward(fctx, grad):
        return gather(grad, fctx.dim, fctx.axes, fctx.ctx), None, None, None


class _GatherFromSeq(torch.autograd.Function):
    """All-gather forward along ``dim``; backward a reduce-scatter when
    the ranks' gradients are partial (``summed``: a sequence entering a
    tensor-parallel region, whose ranks each send back their part), else
    the rank's slice (the gradient is whole and the same on every rank:
    the sequence gathered after the last block)."""

    @staticmethod
    def forward(fctx, x, dim, axes, ctx, summed):
        fctx.dim, fctx.axes, fctx.ctx, fctx.summed = dim, axes, ctx, summed
        return gather(x, dim, axes, ctx)

    @staticmethod
    def backward(fctx, grad):
        take = _reduce_scatter if fctx.summed else _own_block
        return (take(grad, fctx.dim, fctx.axes, fctx.ctx), None, None, None,
                None)


class _ReduceScatterToSeq(torch.autograd.Function):
    """Reduce-scatter forward along ``dim`` (the ranks' partial outputs
    of a row-parallel product summed, each rank keeping its block of the
    sequence), all-gather backward."""

    @staticmethod
    def forward(fctx, x, dim, axes, ctx):
        fctx.dim, fctx.axes, fctx.ctx = dim, axes, ctx
        return _reduce_scatter(x, dim, axes, ctx)

    @staticmethod
    def backward(fctx, grad):
        return gather(grad, fctx.dim, fctx.axes, fctx.ctx), None, None, None


def seq_block(x: torch.Tensor, dim: int,
              axes: Union[str, Sequence[str]] = MODEL) -> torch.Tensor:
    """This rank's block along ``dim`` of a sequence every rank computed
    whole (a sub-block that the model axis does not split), by a plain
    slice: its gradient is zero outside the block, so each rank's
    gradient upstream is its part, summed where the sequence was
    gathered (:func:`gather_from_seq`)."""
    axes, ctx = _seq(axes)
    if ctx.size(axes) == 1:
        return x
    width = x.shape[dim] // ctx.size(axes)
    return x.narrow(dim, ctx.coord(axes) * width, width)


def _seq(axes) -> Tuple[Tuple[str, ...], ShardingCtx]:
    ctx = current_ctx()
    return ((axes,) if isinstance(axes, str) else tuple(axes)), ctx


def scatter_to_seq(x: torch.Tensor, dim: int,
                   axes: Union[str, Sequence[str]] = MODEL) -> torch.Tensor:
    """This rank's block along ``dim`` of a sequence whole on every rank,
    split over ``axes`` (the ``"seq_sp"`` rule's); its gradient is
    gathered whole (see :class:`_ScatterToSeq`)."""
    axes, ctx = _seq(axes)
    if ctx.size(axes) == 1:
        return x
    return _ScatterToSeq.apply(x, dim % x.dim(), axes, ctx)


def gather_from_seq(x: torch.Tensor, dim: int,
                    axes: Union[str, Sequence[str]] = MODEL,
                    summed: bool = True) -> torch.Tensor:
    """The whole sequence from every rank's block along ``dim`` (split
    over ``axes``).  Its gradient: reduce-scattered when ``summed`` (the
    ranks' gradients are partial sums, as where the sequence enters a
    tensor-parallel block), else the rank's slice (see
    :class:`_GatherFromSeq`)."""
    axes, ctx = _seq(axes)
    if ctx.size(axes) == 1:
        return x
    return _GatherFromSeq.apply(x, dim % x.dim(), axes, ctx, summed)


def reduce_scatter_to_seq(x: torch.Tensor, dim: int,
                          axes: Union[str, Sequence[str]] = MODEL
                          ) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (a row-parallel output) over
    ``axes``, this rank keeping its block of the sequence along ``dim``;
    its gradient gathered whole (see :class:`_ReduceScatterToSeq`)."""
    axes, ctx = _seq(axes)
    if ctx.size(axes) == 1:
        return x
    return _ReduceScatterToSeq.apply(x, dim % x.dim(), axes, ctx)


class _BatchMean(torch.autograd.Function):
    """All-reduce mean over the batch axes forward, identity backward:
    each rank's gradient is its own shard's term, and the train step's
    one mean all-reduce of the gradients completes it."""

    @staticmethod
    def forward(fctx, x, ctx):
        out = all_reduce(x.contiguous().clone(), ctx.batch_axes, ctx)
        return out / ctx.size(ctx.batch_axes)

    @staticmethod
    def backward(fctx, grad):
        return grad, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data-parallel ranks (see
    :class:`_BatchMean` for its gradient)."""
    ctx = current_ctx()
    return x if ctx.size(ctx.batch_axes) == 1 else _BatchMean.apply(x, ctx)


def split_offset(local: int, full: int, axis: str = MODEL,
                 ctx: Optional[ShardingCtx] = None) -> Tuple[int, int]:
    """(parts, this rank's offset) of a dimension of ``full`` entries that
    this rank holds ``local`` of: (1, 0) when whole, (size of ``axis``,
    coord · local) when split over it."""
    ctx = ctx or current_ctx()
    if local == full:
        return 1, 0
    parts = ctx.size(axis)
    if local * parts != full:
        raise ValueError(f"a local block of {local} of {full} entries is "
                         f"not 1/{parts} of it")
    return parts, ctx.coord(axis) * local


def mesh_barrier(ctx: Optional[ShardingCtx] = None) -> None:
    """Wait for every rank of the mesh: an all-reduce of one int over
    each axis in turn (sequential axes make it a barrier of the whole
    mesh)."""
    ctx = ctx or current_ctx()
    device = "cuda" if ctx.mesh.device_type == "cuda" else "cpu"
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    all_reduce(flag, ctx.mesh.mesh_dim_names, ctx)
