"""FLOPs, HBM bytes, live memory and collectives of one eager step: the
port's counterpart of the JAX package's ``roofline/hlo_walk.py``.

The reference walks optimized HLO, where fusions hide their interiors
and while loops carry trip counts.  Eager PyTorch runs every aten op as
a kernel of its own, so each op is an HBM boundary, and loops over
layers and microbatches run in Python: there is no trip count to
recover.  :class:`Walk` is a ``TorchDispatchMode`` over the step; per op
it counts

- FLOPs by ``torch.utils.flop_counter``'s registered formulas (matmuls,
  convolutions, attention; elementwise ops count 0);
- bytes as each distinct input storage read once (the bytes its views
  span) plus each output written once.  An in-place op reads and writes
  ``self``; an ``out=`` argument is written.  Views and metadata ops
  (outputs that alias an input), allocations without a fill
  (``empty``...) and the collectives' own ops count 0;
- live bytes: every storage an op makes is live until it dies (a weak
  reference's callback), the step's arguments' storages from the start;
  the peak of their sum is the step's peak.

Each kernel entry of :mod:`repro_torch.kernels.ops`, and K1 in the
``FlashAttention`` Function, reports its own work instead
(:mod:`.kernel_work`): the walk hides the aten ops inside the entry --
the plain version's on the CPU, the binding's on the card, the shapes'
on meta -- so one step counts the same on all three.  The collectives
of :mod:`repro_torch.dist.sharding` and :mod:`repro_torch.dist.ivm_shard`
report their kind, mesh axis, group size and operand bytes (in the type
that goes on the wire), priced by the ring formulas of :mod:`.analysis`.

One walk is active at a time in a process (:func:`active`), found from
any thread: autograd runs a card step's backward on its own thread,
which inherits the dispatch mode but not the caller's context
variables.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .analysis import CollectiveOp, CollectiveSummary, _wire_bytes

_ACTIVE: Optional["Walk"] = None

# allocations that write nothing
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}


def active() -> Optional["Walk"]:
    """The walk in progress, or None."""
    return _ACTIVE


@dataclass
class EntryCount:
    """A kernel entry's calls and the work its formula gave them."""
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def _span_bytes(t: torch.Tensor) -> int:
    """Bytes a view spans: its elements, a broadcast (stride 0) dimension
    counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x: Any) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class Walk(TorchDispatchMode):
    """Counts one step run under ``with Walk(args) as walk:``.  ``args``
    (any tree of tensors) are the step's arguments: their storages are
    live from the start (``argument_bytes``).  After the step,
    :meth:`finish` with its outputs gives ``output_bytes``.

    ``flops``, ``bytes``: the step's totals; ``ops``: aten ops counted
    (outside entries); ``entries``: {entry: :class:`EntryCount`};
    ``collectives``: a :class:`~.analysis.CollectiveSummary`, one
    :class:`~.analysis.CollectiveOp` a call (``line`` its mesh axis);
    ``by_op``: {aten
    op: [calls, flops, bytes]}."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.flops = self.bytes = 0.0
        self.ops = 0
        self.entries: Dict[str, EntryCount] = {}
        self.collectives = CollectiveSummary()
        self.by_op: Dict[str, List[float]] = {}
        self.output_bytes = self.live_bytes = self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._hidden = 0
        self._lock = threading.Lock()
        for t in _tensors(args):
            self._register(t)
        self.argument_bytes = self.live_bytes
        self._arguments = set(self._live)

    # -- live memory --------------------------------------------------------
    def _free(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(key, 0)

    def _register(self, t: torch.Tensor) -> None:
        st = _storage(t)
        key = st._cdata
        if key in self._live:
            return
        nbytes = st.nbytes()
        with self._lock:
            self._live[key] = nbytes
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def finish(self, outputs: Any) -> None:
        """The step's outputs: their storages made during the step are
        ``output_bytes``."""
        seen = set()
        for t in _tensors(outputs):
            key = _storage(t)._cdata
            if key in seen or key in self._arguments:
                continue
            seen.add(key)
            self.output_bytes += self._live.get(key, 0)

    @property
    def temp_bytes(self) -> int:
        """The peak beyond the arguments."""
        return self.peak_bytes - self.argument_bytes

    # -- the mode -----------------------------------------------------------
    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a walk is already active")
        _ACTIVE = self
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self._register(t)
        if not self._hidden:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        schema = func._schema
        name = schema.name.split("::")[-1]
        if func.namespace in ("c10d", "_c10d_functional") \
                or name in _ALLOC:
            nbytes = 0
        else:
            nbytes = self._op_bytes(schema, args, kwargs, out)
        flops = 0
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
        self.ops += 1
        self.flops += flops
        self.bytes += nbytes
        rec = self.by_op.setdefault(str(func.overloadpacket), [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes

    @staticmethod
    def _op_bytes(schema, args, kwargs, out) -> int:
        reads: Dict[int, int] = {}
        writes: Dict[int, int] = {}
        params = schema.arguments
        values = list(args) + [kwargs.get(a.name) for a in
                               params[len(args):]]
        for arg, value in zip(params, values):
            written = arg.alias_info is not None and arg.alias_info.is_write
            for t in _tensors(value):
                key, span = _storage(t)._cdata, _span_bytes(t)
                if written:
                    writes[key] = max(writes.get(key, 0), span)
                if not (written and arg.kwarg_only):   # out= is not read
                    reads[key] = max(reads.get(key, 0), span)
        mutates = bool(writes)
        inputs = set(reads) | set(writes)
        fresh = False
        for t in _tensors(out):
            key = _storage(t)._cdata
            if key not in inputs:          # a view of an input moves nothing
                writes[key] = max(writes.get(key, 0), _span_bytes(t))
                fresh = True
        if not (fresh or mutates):
            return 0                       # views and metadata ops
        return sum(reads.values()) + sum(writes.values())

    # -- reports ------------------------------------------------------------
    def kernel(self, name: str, flops: float, nbytes: float):
        """Context for one kernel entry's call: count ``flops`` and
        ``nbytes`` under ``name`` and hide the ops inside."""
        return _Hidden(self, name, flops, nbytes)

    def collective(self, kind: str, axis: str, group_size: int,
                   operand_bytes: int, result_bytes: int) -> None:
        """One collective (the reference's kind names: ``all-reduce``,
        ``all-gather``) over ``group_size`` ranks of mesh axis ``axis``."""
        with self._lock:
            self.collectives.ops.append(CollectiveOp(
                kind=kind, result_bytes=result_bytes,
                operand_bytes=operand_bytes, group_size=group_size,
                wire_bytes=_wire_bytes(kind, result_bytes, operand_bytes,
                                       group_size), line=axis))

    def entry_counts(self) -> Dict[str, Tuple[int, float, float]]:
        """{entry: (calls, flops, bytes)}."""
        return {k: (e.calls, e.flops, e.bytes)
                for k, e in sorted(self.entries.items())}

    def summary(self) -> Dict[str, Any]:
        """The counts as plain data (what two walks of one step compare)."""
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "entries": {k: list(v)
                            for k, v in self.entry_counts().items()},
                "collective_wire_bytes": self.collectives.total_wire_bytes,
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "peak_bytes": self.peak_bytes}


class _Hidden:
    def __init__(self, walk: Walk, name: str, flops: float, nbytes: float):
        self.walk, self.name = walk, name
        self.flops, self.nbytes = float(flops), float(nbytes)

    def __enter__(self):
        self.walk._hidden += 1

    def __exit__(self, exc_type, *exc):
        walk = self.walk
        walk._hidden -= 1
        if exc_type is not None or walk._hidden:
            return False                 # an entry inside an entry: hidden
        e = walk.entries.setdefault(self.name, EntryCount())
        e.calls += 1
        e.flops += self.flops
        e.bytes += self.nbytes
        walk.flops += self.flops
        walk.bytes += self.nbytes
        return False
