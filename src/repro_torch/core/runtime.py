"""LINVIEW runtime: materialized-view store + incremental engine.

The engine owns the compiled program, the re-evaluator, and one trigger
per dynamic input.  ``apply_update`` fires a trigger; ``apply_updates``
coalesces a whole update stream into one batched trigger firing (stacked
factors, §6 batching); ``enqueue_update`` + ``flush`` queue updates and
fire them in coalesced batches; ``reevaluate`` is the paper's baseline
strategy for comparison and validation.

Views are float32 tensors on the engine's device, updated in place by the
rank-k kernel.  Engines run on the card (``device=None`` means
``"cuda"``) unless the caller passes ``device="cpu"``; they never move to
the CPU on their own.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .codegen import build_evaluator, build_trigger_fn, trigger_flops
from .compiler import (CompiledProgram, batch_bucket, compile_batched_trigger,
                       compile_program)
from .factored import (pad_factors_to_rank, recompress_factors,
                       stack_update_arrays, to_f32)
from .program import Program

Tensor = torch.Tensor


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``None`` means the card, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the engine runs on the card by default; "
                "pass device=\"cpu\" to run it on the CPU")
        device = "cuda"
    return torch.device(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _factor(x, device) -> Tensor:
    """An update factor as a contiguous float32 (n, k) tensor."""
    t = to_f32(x, device)
    if t.dim() == 1:
        t = t[:, None]
    return t.contiguous()


def _owned_views(values: Dict[str, object], device) -> Dict[str, Tensor]:
    """Copies of ``values`` as float32 tensors on ``device``: in-place
    applies must never write through to a caller's array."""
    return {k: to_f32(v, device, copy=True).contiguous()
            for k, v in values.items()}


@dataclass
class EngineStats:
    """Engine counters.

    ``trigger_seconds`` only accumulates for *blocked* firings (an async
    launch has no meaningful wall time), so per-update timings divide by
    ``updates_timed`` — counting them against ``updates_applied`` silently
    under-reports whenever any caller passes ``block=False``.
    """

    updates_applied: int = 0      # logical updates (a T-batch counts T)
    triggers_fired: int = 0       # trigger firings (a T-batch counts 1)
    updates_timed: int = 0        # logical updates included in trigger_seconds
    trigger_seconds: float = 0.0
    batches_applied: int = 0
    lowrank_applies: int = 0      # rank-k view applies (kernel launches on
                                  # the card) over all firings
    recompressions: int = 0
    reevals: int = 0
    reeval_seconds: float = 0.0

    def per_update_seconds(self) -> float:
        return self.trigger_seconds / max(self.updates_timed, 1)


class IncrementalEngine:
    """Maintains all program views under factored updates to the inputs."""

    def __init__(self, program: Program,
                 update_ranks: Optional[Dict[str, int]] = None,
                 *, force_rep: Optional[str] = None,
                 sequential_sm: bool = False,
                 max_batch_rank: Optional[int] = None,
                 recompress_tol: float = 1e-6,
                 flush_size: int = 16,
                 flush_age: float = 0.1,
                 device=None):
        """``max_batch_rank`` caps the stacked rank of a batch (QR/SVD
        re-compression past it); ``flush_size`` (stacked rank) and
        ``flush_age`` (seconds since the oldest queued update) are the
        thresholds at which :meth:`enqueue_update` flushes its queue.
        ``device`` holds every view; ``None`` means the card."""
        self.device = resolve_device(device)
        self.compiled: CompiledProgram = compile_program(
            program, update_ranks, force_rep=force_rep,
            sequential_sm=sequential_sm)
        self.program = self.compiled.program
        self.binding = dict(self.program.dims)
        self._evaluator = build_evaluator(self.program, self.binding,
                                          self.device)
        self._trigger_fns: Dict[str, Callable] = {
            name: build_trigger_fn(trig, self.program, self.binding,
                                   self.device)
            for name, trig in self.compiled.triggers.items()
        }
        # batched triggers, keyed by (input, bucket rank); built lazily
        self._batched_triggers: Dict[Tuple[str, int], Callable] = {}
        self.max_batch_rank = max_batch_rank
        self.recompress_tol = recompress_tol
        self.flush_size = flush_size
        self.flush_age = flush_age
        self._pending: Dict[str, List[Tuple[Tensor, Tensor]]] = {}
        self._pending_since: Dict[str, float] = {}
        self.views: Dict[str, Tensor] = {}
        self.stats = EngineStats()

    # -- lifecycle -----------------------------------------------------------
    def initialize(self, inputs: Dict[str, object]) -> Dict[str, Tensor]:
        """Full evaluation of the program; materializes every view.  The
        inputs are copied, so later in-place applies leave the caller's
        arrays alone."""
        missing = set(self.program.inputs) - set(inputs)
        if missing:
            raise KeyError(f"missing inputs: {sorted(missing)}")
        owned = _owned_views(inputs, self.device)
        computed = self._evaluator(owned)
        self.views = {**owned, **computed}
        self._pending.clear()
        self._pending_since.clear()
        return dict(computed)

    def load_views(self, views: Dict[str, object]) -> Dict[str, Tensor]:
        """Adopt materialized views (e.g. another engine's, as numpy
        arrays) as this engine's state, copied onto its device.  Every
        input and every view of the program must be present."""
        required = set(self.program.inputs) | {
            st.target.name for st in self.program.statements}
        missing = required - set(views)
        if missing:
            raise KeyError(f"missing views: {sorted(missing)}")
        self.views = _owned_views({k: views[k] for k in required},
                                  self.device)
        self._pending.clear()
        self._pending_since.clear()
        return self.views

    def views_numpy(self) -> Dict[str, np.ndarray]:
        """Every view as a host numpy array (the :meth:`load_views`
        counterpart)."""
        return {k: v.detach().cpu().numpy() for k, v in self.views.items()}

    # -- incremental path ------------------------------------------------------
    def apply_update(self, input_name: str, u, v,
                     block: bool = False) -> Dict[str, Tensor]:
        """Fire the trigger for ``input_name += u @ v.T``."""
        fn = self._trigger_fns.get(input_name)
        if fn is None:
            raise KeyError(f"no trigger for input {input_name!r}; have "
                           f"{sorted(self.compiled.triggers)}")
        t0 = time.perf_counter()
        u, v = _factor(u, self.device), _factor(v, self.device)
        self.views = fn(self.views, u, v)
        self.stats.lowrank_applies += fn.lowrank_applies
        if block:
            _sync(self.device)
            self.stats.trigger_seconds += time.perf_counter() - t0
            self.stats.updates_timed += 1
        self.stats.updates_applied += 1
        self.stats.triggers_fired += 1
        return self.views

    def apply_updates(self, input_name: str, updates: Sequence[Tuple],
                      block: bool = False) -> Dict[str, Tensor]:
        """Apply a whole update stream ``[(u_1, v_1) … (u_T, v_T)]`` to one
        input in a single batched trigger firing (§6 batching).

        The factors are stacked into ``P = [u_1 … u_T]``, ``Q = [v_1 … v_T]``
        (one rank-ΣkT update), re-compressed when the stacked rank exceeds
        ``max_batch_rank``, then zero-padded up to the next power-of-two
        bucket so ragged batch sizes share one trigger per bucket.  Every
        maintained view is swept ONCE per batch instead of once per update.
        """
        if input_name not in self.compiled.triggers:
            raise KeyError(f"no trigger for input {input_name!r}; have "
                           f"{sorted(self.compiled.triggers)}")
        updates = list(updates)
        if not updates:
            return self.views
        t0 = time.perf_counter()  # stacking is part of the batch's cost
        t_count = len(updates)
        P, Q = stack_update_arrays(updates, self.device)
        if self.max_batch_rank is not None and P.shape[1] > self.max_batch_rank:
            P, Q = recompress_factors(P, Q, max_rank=self.max_batch_rank,
                                      tol=self.recompress_tol)
            self.stats.recompressions += 1
        bucket = batch_bucket(P.shape[1])
        P, Q = pad_factors_to_rank(P, Q, bucket)
        fn = self._batched_trigger_fn(input_name, bucket)
        self.views = fn(self.views, P, Q)
        self.stats.lowrank_applies += fn.lowrank_applies
        if block:
            _sync(self.device)
            self.stats.trigger_seconds += time.perf_counter() - t0
            self.stats.updates_timed += t_count
        self.stats.updates_applied += t_count
        self.stats.triggers_fired += 1
        self.stats.batches_applied += 1
        return self.views

    def _batched_trigger_fn(self, input_name: str, bucket: int) -> Callable:
        """The trigger for (input, bucket), built on first use."""
        key = (input_name, bucket)
        fn = self._batched_triggers.get(key)
        if fn is None:
            if bucket == self.compiled.triggers[input_name].rank:
                fn = self._trigger_fns[input_name]
            else:
                trig = compile_batched_trigger(self.compiled, input_name,
                                               bucket)
                fn = build_trigger_fn(trig, self.program, self.binding,
                                      self.device)
            self._batched_triggers[key] = fn
        return fn

    # -- update queue (serving-path coalescing) --------------------------------
    def enqueue_update(self, input_name: str, u, v
                       ) -> Optional[Dict[str, Tensor]]:
        """Queue ``input_name += u @ v.T`` for the next coalesced flush.

        Flushes automatically when the pending stacked rank reaches
        ``flush_size`` or the oldest queued update is older than
        ``flush_age`` seconds.  Returns the refreshed views on flush, else
        ``None`` (views are stale until the next :meth:`flush`).
        """
        if input_name not in self.compiled.triggers:
            raise KeyError(f"no trigger for input {input_name!r}; have "
                           f"{sorted(self.compiled.triggers)}")
        u, v = _factor(u, self.device), _factor(v, self.device)
        q = self._pending.setdefault(input_name, [])
        if not q:
            self._pending_since[input_name] = time.perf_counter()
        q.append((u, v))
        return self.maybe_flush(input_name)

    def pending_rank(self, input_name: str) -> int:
        return sum(u.shape[1] for u, _ in self._pending.get(input_name, ()))

    def pending_age(self, input_name: str) -> float:
        if not self._pending.get(input_name):
            return 0.0
        return time.perf_counter() - self._pending_since[input_name]

    def maybe_flush(self, input_name: str) -> Optional[Dict[str, Tensor]]:
        """Flush one input's queue if its rank or age threshold is met."""
        if self.pending_age(input_name) >= self.flush_age \
                or self.pending_rank(input_name) >= self.flush_size:
            return self.flush(input_name)
        return None

    def flush(self, input_name: Optional[str] = None,
              block: bool = False) -> Dict[str, Tensor]:
        """Apply all pending updates (for one input, or every input)."""
        names = [input_name] if input_name is not None else \
            [n for n, q in self._pending.items() if q]
        for name in names:
            q = self._pending.get(name)
            if q:
                # apply before popping: if the trigger raises, the queue
                # survives for a retry instead of silently vanishing
                self.apply_updates(name, q, block=block)
            self._pending.pop(name, None)
            self._pending_since.pop(name, None)
        return self.views

    # -- baseline path ---------------------------------------------------------
    def reevaluate(self, block: bool = False) -> Dict[str, Tensor]:
        """The paper's re-evaluation strategy: recompute from the current
        inputs (which the triggers have been keeping up to date)."""
        inputs = {k: self.views[k] for k in self.program.inputs}
        t0 = time.perf_counter()
        computed = self._evaluator(inputs)
        if block:
            _sync(self.device)
            self.stats.reeval_seconds += time.perf_counter() - t0
        self.views.update(computed)
        self.stats.reevals += 1
        return dict(computed)

    # -- introspection -----------------------------------------------------------
    def output(self, name: Optional[str] = None) -> Tensor:
        name = name or self.program.output_names()[0]
        return self.views[name]

    def trigger_flops(self, input_name: str) -> float:
        return trigger_flops(self.compiled.triggers[input_name], self.program,
                             self.binding)

    def reeval_flops(self) -> float:
        from .cost import _expr_cost_shared
        seen: Dict[int, bool] = {}
        return sum(_expr_cost_shared(s.expr, self.binding, seen).flops
                   for s in self.program.statements)


class ReevalEngine:
    """Pure re-evaluation baseline: applies the update to the input, then
    recomputes every view from scratch (paper's REEVAL strategy)."""

    def __init__(self, program: Program, device=None):
        self.device = resolve_device(device)
        self.program = program
        self.binding = dict(program.dims)
        self._evaluator = build_evaluator(program, self.binding, self.device)
        self.views: Dict[str, Tensor] = {}

    def initialize(self, inputs: Dict[str, object]) -> Dict[str, Tensor]:
        owned = _owned_views(inputs, self.device)
        computed = self._evaluator(owned)
        self.views = {**owned, **computed}
        return dict(computed)

    def apply_update(self, input_name: str, u, v,
                     block: bool = False) -> Dict[str, Tensor]:
        ops.rank_update(self.views[input_name], _factor(u, self.device),
                        _factor(v, self.device))
        inputs = {k: self.views[k] for k in self.program.inputs}
        computed = self._evaluator(inputs)
        if block:
            _sync(self.device)
        self.views.update(computed)
        return self.views

    def output(self, name: Optional[str] = None) -> Tensor:
        name = name or self.program.output_names()[0]
        return self.views[name]


def max_abs_diff(a: Dict[str, Tensor], b: Dict[str, Tensor],
                 keys: Optional[Tuple[str, ...]] = None) -> float:
    keys = keys or tuple(set(a) & set(b))
    worst = 0.0
    for k in keys:
        diff = a[k] - b[k].to(a[k].device)
        worst = max(worst, float(diff.abs().max()))
    return worst
