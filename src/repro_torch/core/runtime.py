"""LINVIEW runtime: materialized-view store + incremental engine.

The engine owns the compiled program, the re-evaluator, and one trigger
per dynamic input.  ``apply_update`` fires a trigger; ``apply_updates``
coalesces a whole update stream into one batched trigger firing (stacked
factors, §6 batching); ``enqueue_update`` + ``flush`` queue updates and
fire them in coalesced batches; ``reevaluate`` is the paper's baseline
strategy for comparison and validation.  ``apply_update`` and
``apply_updates`` also take delta carriers (:mod:`.factored`): a no-op
carrier skips its firing, a contained row-local carrier fires the
row-local trigger (:func:`~.codegen.build_rowlocal_trigger_fn`), and any
other carrier widens to the dense path.

With ``plan=`` (:mod:`repro_torch.plan`) every firing executes a
cost-based **maintenance plan**: per view, factored delta propagation
while it wins, in-firing re-evaluation past the §7 crossover, a
rank/staleness hybrid in between, and lazy (recompute-on-read) refresh
for unmaterialized intermediates.  Built triggers are shared across
engine instances through the plan trigger cache.  Engines with
``flush_policy="cost"`` and no plan still get the per-view re-evaluation
fallback: a firing whose stacked rank puts some view past its crossover
re-evaluates that view instead of sweeping it.  Only the incremental
views of a planned firing go through the rank-k kernel; a re-evaluated
view is recomputed by the program's own products (``torch.matmul``,
``torch.linalg.inv_ex``), as the reference recomputes it outside any Pallas
kernel.

Views are float32 tensors on the engine's device, updated in place by the
rank-k kernel.  Engines run on the card (``device=None`` means
``"cuda"``) unless the caller passes ``device="cpu"``; they never move to
the CPU on their own.

With ``guard=`` (:mod:`repro_torch.guard`) every admission point
validates and quarantines updates, and every firing is transactional:
a guarded engine writes out of place (the rank-k kernel's out-of-place
entry), so a failed firing rolls back to the very pre-firing tensors.
``chaos=`` injects seeded faults so those paths run.

With ``order=`` views of depth >= 2 are maintained by the **deferred
cascade**: their window of updates is banked in factored form and folded
— one stacked sweep from the window-start store, or a re-evaluation —
every ``fold_window**(depth-1)`` firings or at the next read.  The window
base is a reference snapshot of the store, so an engine with a deferred
view writes out of place, as a guarded one does: no later firing moves a
tensor the base holds.

With ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``) every view that
its mesh axis divides is kept row-sharded, and every firing runs through
the row-sharded trigger (:mod:`repro_torch.dist.ivm_shard`): each rank
sweeps its own rows with the rank-k kernel, and the factor chain moves
skinny blocks between the ranks.  Every rank makes the same calls with
the same updates; ``output`` and ``views_numpy`` gather whole views.  A
guard's drift sentinel probes the row blocks and sums the residuals over
the ranks (:mod:`repro_torch.guard.sentinel`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .codegen import (build_evaluator, build_rowlocal_trigger_fn,
                      build_trigger_fn, recompute, trigger_flops)
from .compiler import (CompiledProgram, Trigger, batch_bucket,
                       compile_batched_trigger, compile_delta_trigger,
                       compile_program)
from .factored import (DeltaCarrier, RowLocalCarrier, as_carrier,
                       pad_factors_to_rank, recompress_factors,
                       stack_carriers, stack_update_arrays, to_f32)
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


def _queued(x, device):
    """An update factor as the queue keeps it: a tensor moves to the
    engine's device, anything else stays on the host as a float32 numpy
    array (as the reference queues it); both (n, k)."""
    if isinstance(x, torch.Tensor):
        return _factor(x, device)
    x = np.asarray(x, dtype=np.float32)
    return x[:, None] if x.ndim == 1 else x


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
    lowrank_applies: int = 0      # dense rank-k view applies (kernel
                                  # launches on the card) over all firings
    row_applies: int = 0          # row-local view applies (row-kernel
                                  # launches on the card)
    noop_skips: int = 0           # no-op carriers dropped before any firing
    rowlocal_firings: int = 0     # firings that swept only touched rows
    widened_carriers: int = 0     # row-local carriers that fell back dense
    recompressions: int = 0
    reevals: int = 0
    reeval_seconds: float = 0.0
    plan_reevals: int = 0         # views re-evaluated inside planned firings
    lazy_skips: int = 0           # unmaterialized views left stale by firings
    replans: int = 0              # adaptive plan hot-swaps
    # FLOPs behind the timed seconds above — the observed wall-clock
    # rates (trigger_seconds/sweep_flops_timed vs
    # reeval_seconds/reeval_flops_timed) are what
    # AdaptivePlanner.refit_from_stats turns into an online cost_scale
    sweep_flops_timed: float = 0.0
    reeval_flops_timed: float = 0.0
    # deferred-cascade (depth >= 2) maintenance counters
    folds: int = 0                # window folds (all tiers folded = 1)
    fold_sweeps: int = 0          # views folded via one stacked sweep
    fold_reevals: int = 0         # views folded via re-evaluation
    fold_aborts: int = 0          # folds rolled back, then redone
    reads: int = 0                # output() calls (the read-rate signal)

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
                 flush_policy: str = "fixed",
                 rowlocal_fraction: float = 0.25,
                 plan=None,
                 trigger_cache=None,
                 guard=None,
                 chaos=None,
                 order=None,
                 fold_window: int = 8,
                 max_fold_rank: Optional[int] = 64,
                 mesh=None,
                 mesh_axis: Optional[str] = None,
                 device=None):
        """``max_batch_rank`` caps the stacked rank of a batch (QR/SVD
        re-compression past it).  ``flush_policy`` picks how
        :meth:`enqueue_update` decides to flush: ``"fixed"`` trips on
        ``flush_size`` (stacked rank); ``"cost"`` asks the §4/§7 cost
        model instead — the queue flushes at :meth:`cost_flush_rank`, the
        first stacked rank where some maintained view stops answering
        ``"stacked"``, and the flushed firing re-evaluates any view whose
        crossover the stacked rank did pass.  Under both, ``flush_age``
        (seconds since the oldest queued update) bounds the latency.
        ``rowlocal_fraction`` is the affected-fraction crossover for
        row-local carriers: one touching at most this fraction of its
        input's rows fires the row-local trigger, a wider one widens to
        the dense path.

        ``plan`` attaches a :class:`repro_torch.plan.MaintenancePlan`
        (or a :class:`~repro_torch.plan.WorkloadDescriptor` to plan here,
        or an :class:`~repro_torch.plan.AdaptivePlanner` for online
        re-planning); planned engines share built triggers through
        ``trigger_cache`` (default: the process-global
        :func:`repro_torch.plan.global_trigger_cache`).  ``device`` holds
        every view; ``None`` means the card.

        ``guard`` attaches the :mod:`repro_torch.guard` failure-containment
        layer (a :class:`~repro_torch.guard.GuardConfig`, or ``True`` for
        the defaults): update validation + quarantine at every admission
        point, transactional firings (out-of-place applies, output
        validation, atomic rollback), and an optional drift sentinel.
        ``chaos`` (a :class:`~repro_torch.guard.ChaosConfig` or a shared
        :class:`~repro_torch.guard.ChaosMonkey`) injects deterministic
        faults — update poisoning and in-trigger raises — so the guard's
        recovery paths are exercised, not trusted.

        ``order`` turns on higher-order (deferred-cascade) maintenance:
        an int applies the depth to every view, a ``{view: depth}`` dict
        assigns per view.  Views of effective depth ``o >= 2`` are not
        swept per firing; their window of updates accumulates in factored
        form and is **folded** — one stacked sweep (or re-evaluation,
        whichever the §7 crossover prefers) from the window-start base —
        every ``fold_window**(o-1)`` firings or at the next read.  Depth
        assignments are resolved so a producer view is never staler than
        its consumers.  ``max_fold_rank`` caps the stacked window rank by
        QR/SVD re-compression (lossy past the window's numerical rank).
        When a maintenance ``plan`` carries per-view ``order`` fields,
        the plan's depths are authoritative.

        ``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh`` over a
        process group the caller set up) row-shards the views over the
        ranks of its axis ``mesh_axis`` (default: the mesh's first) and
        runs every firing through
        :func:`repro_torch.dist.ivm_shard.build_distributed_trigger`.
        The mesh picks the device (``cuda:(rank % device_count)`` on a
        ``"cuda"`` mesh); a ``device`` that disagrees raises.  Row-local
        carriers widen to the dense path and no input is banked, as in
        the reference."""
        if flush_policy not in ("fixed", "cost"):
            raise ValueError(f"unknown flush_policy {flush_policy!r}")
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self._shards = None
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from ..dist.ivm_shard import Shards
            self._shards = Shards(mesh, mesh_axis)
            self.device = self._shards.device
            want = None if device is None else torch.device(device)
            if want is not None and (want.type != self.device.type or (
                    want.index is not None
                    and want.index != self.device.index)):
                raise ValueError(f"device {want} disagrees with the mesh's "
                                 f"{self.device} for this rank")
        if isinstance(order, dict):
            requested_orders = {k: int(v) for k, v in order.items()}
            compile_order = max([1, *requested_orders.values()])
        elif order is not None:
            compile_order = max(1, int(order))
            requested_orders = None   # every view, filled after compile
        else:
            compile_order, requested_orders = 1, {}
        self.compiled: CompiledProgram = compile_program(
            program, update_ranks, force_rep=force_rep,
            sequential_sm=sequential_sm, order=compile_order)
        self.program = self.compiled.program
        self.binding = dict(self.program.dims)
        names = {st.target.name for st in self.program.statements}
        if requested_orders is None:
            requested_orders = dict.fromkeys(names, compile_order)
        elif set(requested_orders) - names:
            raise KeyError(f"order assigns unknown views: "
                           f"{sorted(set(requested_orders) - names)}")
        self._evaluator = build_evaluator(self.program, self.binding,
                                          self.device)
        self._kinds: Dict[str, str] = {}
        if mesh is not None:
            from ..dist.ivm_shard import (build_distributed_evaluator,
                                          view_kinds)
            self._kinds = view_kinds(self.program, self.binding,
                                     self._shards.world)
            self._mesh_evaluator = build_distributed_evaluator(
                self.program, mesh, axis=mesh_axis, binding=self.binding)
        self.rowlocal_fraction = float(rowlocal_fraction)
        self.flush_policy = flush_policy
        # failure containment (repro_torch.guard), imported lazily so the
        # core <-> guard layering stays one-directional at module load.
        # A transactional guard builds every firing out of place
        # (codegen.build_trigger_fn): its rollback is the pre-firing store.
        self.chaos = None
        self.guard = None
        self._out_of_place = False
        self._cow_rows = False     # copy row-local views before a row apply
        if chaos is not None:
            from ..guard import as_monkey
            self.chaos = as_monkey(chaos)
        if guard is not None:
            from ..guard import EngineGuard, GuardConfig
            if guard is True:
                guard = GuardConfig()
            self.guard = EngineGuard(guard, self)
            self._out_of_place = guard.transactional
        # planned execution state (repro_torch.plan)
        self.plan = None
        self.planner = None
        self._cache_ns: Optional[Tuple] = None
        self._trigger_cache = trigger_cache
        self._accum_rank: Dict[str, int] = {}   # hybrid staleness counters
        self._stale: set = set()                # lazy views awaiting refresh
        self._view_costs: Dict[str, List[Tuple[str, Tuple[int, int],
                                               float]]] = {}
        # trigger IR per (input, bucket rank) and trigger fns per (input,
        # bucket, reeval, lazy); built lazily, the base ranks' up front
        self._bucket_triggers: Dict[Tuple[str, int], Trigger] = {}
        self._planned_fns: Dict[Tuple, Callable] = {}
        # row-local triggers, keyed by (input, bucket rank); built lazily
        self._rowlocal_fns: Dict[Tuple[str, int], Callable] = {}
        # Δᵈ triggers, keyed by (input, depth, bucket)
        self._delta_fns: Dict[Tuple[str, int, int], Callable] = {}
        self.max_batch_rank = max_batch_rank
        self.recompress_tol = recompress_tol
        self.flush_size = flush_size
        self.flush_age = flush_age
        self._cost_flush_rank: Dict[str, int] = {}
        self._pending: Dict[str, List[Tuple[Tensor, Tensor]]] = {}
        self._pending_since: Dict[str, float] = {}
        self.views: Dict[str, Tensor] = {}
        self.stats = EngineStats()
        # deferred-cascade state (_adopt_orders fills it; a plan with
        # depths replaces it)
        self.fold_window = max(2, int(fold_window))
        self.max_fold_rank = max_fold_rank
        self._view_orders: Dict[str, int] = {}
        self._deferred: FrozenSet[str] = frozenset()
        self._tiers: Tuple[int, ...] = ()
        self._adopt_orders(requested_orders)
        if plan is not None:
            self._attach_plan(plan)
        self._trigger_fns: Dict[str, Callable] = {
            name: self._planned_trigger_fn(name, trig.rank)
            for name, trig in self.compiled.triggers.items()
        }
        self._set_fast_path()

    def _set_fast_path(self) -> None:
        """Whether guarded firings take the fused path (out-of-place
        applies, device flags and the select-commit kernel, no host sync)
        — admission can then defer its own finite screen into it.
        Planned and cost-policy firings, and engines with deferred views
        (their window state lives on the host), take the snapshot path,
        as in the reference."""
        self._guard_fast_path = (
            self.guard is not None and self.guard.fused_path_ok
            and self.plan is None and self.flush_policy != "cost"
            and not self._deferred)

    def _write_out_of_place(self) -> None:
        """Build every firing out of place from now on, and copy each
        row-local view before its in-place row apply, so no firing writes
        a tensor that existed before it: a reference to a view is then a
        snapshot no later firing moves
        (:class:`~repro_torch.guard.GuardedView`)."""
        self._apply_out_of_place()
        self._cow_rows = True

    def _apply_out_of_place(self) -> None:
        """Build every dense apply out of place from now on (the guard,
        the fleet and the deferred cascade need it; nothing turns it
        back off)."""
        if not self._out_of_place:
            self._out_of_place = True
            self._planned_fns.clear()
            self._rowlocal_fns.clear()

    # -- higher-order (deferred-cascade) maintenance --------------------------
    def _resolve_view_orders(self, requested: Dict[str, int]
                             ) -> Dict[str, int]:
        """Effective per-view depth: a producer may never be staler than
        its consumers, so each view's requested depth is clamped to the
        minimum effective depth of the views that read it (inputs are
        always first-order)."""
        names = {st.target.name for st in self.program.statements}
        consumers: Dict[str, List[str]] = {}
        for st in self.program.statements:
            for vname in st.expr.free_vars():
                if vname in names and vname != st.target.name:
                    consumers.setdefault(vname, []).append(st.target.name)
        eff: Dict[str, int] = {}
        for st in reversed(self.program.statements):
            name = st.target.name
            o = max(1, int(requested.get(name, 1)))
            for c in consumers.get(name, ()):
                o = min(o, eff[c])
            eff[name] = o
        return eff

    def _window(self, o: int) -> int:
        return max(1, self.fold_window ** (o - 1))

    def _adopt_orders(self, requested: Dict[str, int]) -> None:
        """Set (or hot-swap) the per-view depth assignment.

        Pending windows are folded under the OLD depths first so no
        accumulated update is lost, then the cascade state and the
        trigger-cache namespace (which carries the order signature) are
        rebuilt.  An engine with a deferred view writes out of place:
        the window base is a reference snapshot of the store."""
        eff = self._resolve_view_orders(requested)
        if self._view_orders == eff:
            return
        if self._tiers and self.views and self._cascade_pending():
            self._fold(self._tiers[-1])
        self._view_orders = eff
        self._deferred = frozenset(n for n, o in eff.items() if o >= 2)
        self._tiers = tuple(sorted({o for o in eff.values() if o >= 2}))
        self._cascade_rebase_all()
        self._cache_ns = None
        if self._tiers:
            self._apply_out_of_place()

    def _cascade_pending(self) -> bool:
        return any(fs for o in self._tiers
                   for fs in self._tier_factors[o].values())

    def _cascade_rebase_all(self) -> None:
        """Empty every window and rebase it on the current store."""
        self._pending_input: Dict[str, List[Tuple[Tensor, Tensor]]] = {}
        self._fold_prestacked: Dict[str, Tuple] = {}
        self._tier_factors: Dict[int, Dict[str, List]] = \
            {o: {} for o in self._tiers}
        self._tier_firings: Dict[int, int] = dict.fromkeys(self._tiers, 0)
        self._tier_base: Dict[int, Dict[str, Tensor]] = \
            {o: dict(self.views) for o in self._tiers}

    def _cascade_snapshot(self):
        """Cascade state for transactional rollback (window factors,
        window-start bases, firing counters, banked input factors) —
        reference copies only.  The banked inputs are part of it (the
        reference's snapshot leaves them out): a rolled-back claim of an
        unguarded deferred fleet tenant would otherwise bank its updates
        twice."""
        if not self._tiers:
            return None
        return ({o: {k: list(v) for k, v in self._tier_factors[o].items()}
                 for o in self._tiers},
                {o: dict(self._tier_base[o]) for o in self._tiers},
                dict(self._tier_firings),
                {k: list(v) for k, v in self._pending_input.items()})

    def _cascade_restore(self, snap) -> None:
        if snap is None:
            return
        factors, base, firings, pending = snap
        self._tier_factors = {o: {k: list(v) for k, v in factors[o].items()}
                              for o in factors}
        self._tier_base = {o: dict(base[o]) for o in base}
        self._tier_firings = dict(firings)
        self._pending_input = {k: list(v) for k, v in pending.items()}

    def _cascade_accumulate(self, input_name: str, pairs,
                            defer_input: bool = False) -> None:
        """Append one admitted firing's (pre-padding) factors to every
        tier's window, re-compressing at the rank cap on the device, then
        fold any tier whose window is due.  ``pairs`` is the firing's
        update list (a whole batch still ticks each window once).  With
        ``defer_input`` the factors are also banked — exactly, outside
        any rank cap — for :meth:`_apply_pending_inputs` to apply to the
        input at the next fold."""
        norm = [(_factor(u, self.device), _factor(v, self.device))
                for u, v in pairs]
        if defer_input:
            self._pending_input.setdefault(input_name, []).extend(norm)
        for o in self._tiers:
            fs = self._tier_factors[o].setdefault(input_name, [])
            fs.extend(norm)
            self._tier_firings[o] += 1
            if (self.max_fold_rank is not None
                    and sum(a.shape[1] for a, _ in fs) > self.max_fold_rank):
                P, Q = stack_update_arrays(fs, self.device)
                self._tier_factors[o][input_name] = [recompress_factors(
                    P, Q, max_rank=self.max_fold_rank,
                    tol=self.recompress_tol)]
                self.stats.recompressions += 1
        self._maybe_fold()

    def _inputs_deferrable(self, input_name: str) -> bool:
        """True when nothing this trigger maintains needs to be current
        between folds: every maintained target is a deferred (depth >= 2)
        view and no guard, chaos or plan expects a per-firing transaction
        or partition.  The firing then banks its factors — no stacking,
        no padding, no kernel launch — and the input apply itself becomes
        part of the fold."""
        if not self._tiers or self.guard is not None \
                or self.chaos is not None or self.plan is not None \
                or self.planner is not None or self.mesh is not None:
            return False
        targets = {up.view for up in
                   self.compiled.triggers[input_name].updates}
        return (targets - {input_name}) <= self._deferred

    def _apply_pending_inputs(self) -> Dict[str, Tuple]:
        """Materialize deferred input state: one out-of-place apply of
        the dense kernel per input stacks everything banked since the
        last fold.  The banked factors are exact (never rank-capped), so
        the input is bitwise a function of the update stream alone —
        replay engines folding on the same cadence reproduce it.  Returns
        the stacked factors per input (``(P, Q, pairs)``) so the fold's
        sweep can reuse them instead of re-stacking the same window."""
        stacked: Dict[str, Tuple] = {}
        for input_name, pairs in self._pending_input.items():
            if not pairs:
                continue
            P, Q = stack_update_arrays(pairs, self.device)
            self.views[input_name] = ops.rank_update_batched_out(
                self.views[input_name], P, Q)
            self.stats.lowrank_applies += 1
            stacked[input_name] = (P, Q, list(pairs))
            pairs.clear()
        return stacked

    def _maybe_fold(self) -> None:
        due = [o for o in self._tiers
               if self._tier_firings[o] >= self._window(o)]
        if due:
            self._fold(max(due))

    def _fold(self, upto: int) -> None:
        """Fold the pending windows of every tier <= ``upto``, lowest
        first (a tier's fold reads its ancestors' *current* values, and
        lower tiers are never staler than higher ones).

        Guarded engines run the fold transactionally: snapshot → (chaos)
        → fold → finite-check, with rollback and an exact re-evaluation
        fallback on failure — a fold is a firing as far as containment
        is concerned."""
        tiers = [o for o in self._tiers if o <= upto]
        if not tiers:
            return
        # deferred-input engines bank the raw input factors per firing;
        # the fold is where the input state materializes
        self._fold_prestacked = self._apply_pending_inputs()
        guarded = self.guard is not None and self.guard.config.transactional
        if guarded or self.chaos is not None:
            from ..guard.txn import (FiringAborted, check_finite,
                                     restore_snapshot, take_snapshot)
            snap = take_snapshot(self) if guarded else None
            try:
                if self.chaos is not None:
                    self.chaos.maybe_raise_in_trigger()
                folded: set = set()
                for o in tiers:
                    folded |= self._fold_tier(o)
                if guarded and folded:
                    reason = self._agreed(check_finite(self.views, folded))
                    if reason is not None:
                        raise FiringAborted(reason, "<fold>", "validate")
            except Exception:
                if snap is None:
                    raise  # unguarded chaos: propagate like a kernel error
                restore_snapshot(self, snap)
                self.stats.fold_aborts += 1
                self.guard.stats.rollbacks += 1
                # exact, chaos-free fallback: re-evaluate the deferred
                # views from their (current) ancestors
                for o in tiers:
                    self._fold_tier(o, force_reeval=True)
        else:
            for o in tiers:
                self._fold_tier(o)
        self._fold_prestacked = {}
        self.stats.folds += 1

    def _fold_tier(self, o: int, force_reeval: bool = False) -> set:
        """Fold one tier's window and rebase it on the resulting store.
        Returns the set of view names the fold wrote."""
        targets = {n for n, oo in self._view_orders.items() if oo == o}
        touched = [n for n, fs in self._tier_factors.get(o, {}).items()
                   if fs]
        folded: set = set()
        if targets and touched:
            affected: set = set()
            for input_name in touched:
                affected |= {up.view for up in
                             self.compiled.triggers[input_name].updates}
            affected &= targets
            if affected:
                if force_reeval or len(touched) > 1:
                    # a window over several inputs interleaves their
                    # updates; re-evaluation from the current ancestors
                    # is the always-exact fold for any mix
                    folded = self._fold_reeval(affected)
                else:
                    folded = self._fold_sweep(o, touched[0], affected)
        self._tier_factors[o] = {}
        self._tier_firings[o] = 0
        self._tier_base[o] = dict(self.views)
        self._stale -= targets
        return folded

    def _fold_reeval(self, affected: set) -> set:
        """Re-evaluate the program from the current inputs and write back
        the ``affected`` views only (replay engines fold through the same
        path, so their stores stay bit for bit)."""
        computed = self._evaluate({k: self.views[k]
                                   for k in self.program.inputs})
        for name in affected:
            self.views[name] = computed[name]
        self.stats.fold_reevals += len(affected)
        return set(affected)

    def _fold_sweep(self, o: int, input_name: str, affected: set) -> set:
        """Single-input window fold: stack the window's factors and sweep
        each affected view ONCE from the tier's window-start base (the
        trigger's pre-update contract makes this exact), falling back to
        re-evaluation per view past its §7 crossover at the window rank."""
        from .cost import batched_strategy
        fs = self._tier_factors[o][input_name]
        pre = self._fold_prestacked.get(input_name)
        if pre is not None and len(pre[2]) == len(fs) and all(
                a is pa and b is pb
                for (a, b), (pa, pb) in zip(fs, pre[2])):
            # this tier's window holds the very factors the fold just
            # applied to the input.  Equal length alone is not enough: a
            # window re-compressed at the rank cap, or older than the
            # last fold of a lower tier, can count as many entries
            P, Q = pre[0], pre[1]
        else:
            P, Q = stack_update_arrays(fs, self.device)
        r = int(P.shape[1])
        costs = {name: (shape, re) for name, shape, re
                 in self._factored_view_costs(input_name)}
        sweep: set = set()
        reeval: set = set()
        for name in affected:
            info = costs.get(name)
            if info is not None and \
                    batched_strategy(info[0], r, r, info[1]) == "stacked":
                sweep.add(name)
            else:
                reeval.add(name)   # dense-rep views have no factored sweep
        if sweep:
            bucket = batch_bucket(r)
            Pb, Qb = pad_factors_to_rank(P, Q, bucket)
            trig_targets = {up.view for up in
                            self.compiled.triggers[input_name].updates}
            maintained = {st.target.name for st in self.program.statements}
            lazy = frozenset((maintained & trig_targets) - sweep)
            fn = self._planned_trigger_fn(input_name, bucket,
                                          frozenset(), lazy)
            out = fn(dict(self._tier_base[o]), Pb, Qb)
            self.stats.lowrank_applies += fn.lowrank_applies
            for name in sweep:
                self.views[name] = out[name]
            self.stats.fold_sweeps += len(sweep)
        if reeval:
            self._fold_reeval(reeval)
        return sweep | reeval

    # -- the mesh (repro_torch.dist.ivm_shard) --------------------------------
    def _evaluate(self, inputs: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Every view from ``inputs``: on a mesh, from the local row
        blocks by the sharded evaluate."""
        if self.mesh is not None:
            return self._mesh_evaluator(inputs)
        return self._evaluator(inputs)

    def _recompute(self, statements) -> None:
        if self.mesh is not None:
            from ..dist.ivm_shard import recompute as mesh_recompute
            mesh_recompute(statements, self.views, self.binding,
                           self._shards, self._kinds)
        else:
            recompute(statements, self.views, self.binding, self.device)

    def _agreed(self, reason: Optional[str]) -> Optional[str]:
        """A validation verdict every rank of the mesh shares: a firing
        that failed on one rank's rows rolls back on all of them."""
        if self.mesh is not None and self._shards.any_rank(reason is not None):
            return reason or "non-finite output on another rank"
        return reason

    def _shard(self, views: Dict[str, Tensor]) -> Dict[str, Tensor]:
        if self.mesh is None:
            return views
        from ..dist.ivm_shard import shard_views
        return shard_views(views, self.mesh, self.mesh_axis)

    def _gather(self, names) -> Dict[str, Tensor]:
        """Whole views, gathered on a mesh (a collective: every rank
        calls it with the same names)."""
        views = {k: self.views[k] for k in names}
        if self.mesh is None:
            return views
        from ..dist.ivm_shard import gather_views
        return gather_views(views, self.mesh, self._kinds, self.mesh_axis)

    # -- maintenance plans (repro_torch.plan) ----------------------------------
    def _attach_plan(self, plan) -> None:
        from ..plan import AdaptivePlanner, WorkloadDescriptor, plan_for_engine
        if isinstance(plan, WorkloadDescriptor):
            plan = plan_for_engine(self, plan)
        if isinstance(plan, AdaptivePlanner):
            self.planner = plan
            plan = plan.bind(self.compiled, self.binding, mesh=self.mesh,
                             mesh_axis=self.mesh_axis)
        self.set_plan(plan)

    def set_plan(self, plan) -> None:
        """Hot-swap the maintenance plan.

        Pending queues, hybrid staleness counters and lazy-view staleness
        all survive the swap — a re-plan changes how future firings
        refresh views, never the values they produce — so a serving
        engine can adopt a re-plan mid-stream without dropping its
        staleness contract.  A plan with per-view depths is authoritative
        for the deferred cascade: its orders are adopted (pending windows
        fold under the old depths first).  Raises ``ValueError`` if the
        plan was priced for a different (program, dims) fingerprint, for
        another mesh than this engine's (its ``mesh_key`` is not
        ``mesh_cache_key(self.mesh, self.mesh_axis)``; ``None`` without
        a mesh), or assigns depth >= 2 while leaving a view
        unmaterialized.
        """
        from ..plan import (global_trigger_cache, mesh_cache_key,
                            program_fingerprint)
        fp = program_fingerprint(self.program, self.binding)
        if plan.fingerprint != fp:
            raise ValueError(
                f"plan fingerprint {plan.fingerprint} does not match this "
                f"engine's program ({fp}); plans are not portable across "
                f"program structures or dimension bindings")
        key = mesh_cache_key(self.mesh, self.mesh_axis)
        if plan.mesh_key != key:
            raise ValueError(
                f"plan mesh key {plan.mesh_key} is not this engine's "
                f"({key}); a plan runs on the mesh it was priced for")
        plan_orders = {name: int(vp.order or 1)
                       for name, vp in plan.views.items()}
        deep = any(o > 1 for o in plan_orders.values())
        if deep and any(not vp.materialize for vp in plan.views.values()):
            raise ValueError(
                "a plan assigning depth >= 2 must materialize every view: "
                "deferred folds sweep from window-start base snapshots, "
                "which lazy (recompute-on-read) views would leave "
                "inconsistent")
        if self._trigger_cache is None:
            self._trigger_cache = global_trigger_cache()
        self.plan = plan
        if deep:
            self._adopt_orders(plan_orders)
        elif self._deferred:
            self._adopt_orders({})   # re-plan back down to first order
        self._set_fast_path()   # planned firings leave the fused path
        if self.planner is not None and self.planner.plan is not plan:
            # keep the attached adaptive planner's baseline in sync so
            # its next drift check does not silently revert a hot-swap
            self.planner.adopt(plan)

    def _cache_key(self, tail: Tuple) -> Tuple:
        """A shared-cache key: the program's fingerprint, the device (a
        trigger fn closes over it), the mesh key and the process group
        (a sharded fn closes over the group, which lives only until it
        is destroyed), the compile options, the compiled delta depth and
        the per-view deferral signature (an order-2 engine must never
        reuse, or poison, a first-order engine's fns in a shared cache),
        then ``tail``."""
        if self._cache_ns is None:
            from ..plan import mesh_cache_key, program_fingerprint
            dev = self.device
            index = dev.index
            if index is None and dev.type == "cuda":
                index = torch.cuda.current_device()
            self._cache_ns = (
                program_fingerprint(self.program, self.binding),
                dev.type, index,
                mesh_cache_key(self.mesh, self.mesh_axis),
                None if self.mesh is None else id(self._shards.group),
                self.compiled.force_rep,
                self.compiled.sequential_sm, self.compiled.order,
                tuple(sorted((n, o) for n, o in self._view_orders.items()
                             if o > 1)))
        return self._cache_ns + tail

    def _cached_build(self, tail: Tuple, builder: Callable) -> Callable:
        """Build a trigger fn through the shared cache (identical keys
        across engine instances reuse the callable); without a cache,
        just build it."""
        if self._trigger_cache is None:
            return builder()
        return self._trigger_cache.get_or_build(self._cache_key(tail),
                                                builder)

    def _factored_view_costs(self, input_name: str
                             ) -> List[Tuple[str, Tuple[int, int], float]]:
        """(view, shape, reeval FLOPs) per factored-maintained view of
        one trigger; cached per input (used on every cost-policy
        firing)."""
        cached = self._view_costs.get(input_name)
        if cached is None:
            from .cost import expr_cost, shape_of
            trig = self.compiled.triggers[input_name]
            by_name = {s.target.name: s for s in self.program.statements}
            cached = []
            for up in trig.updates:
                st = by_name.get(up.view)
                if up.kind != "lowrank" or st is None:
                    continue
                cached.append((up.view, shape_of(st.target, self.binding),
                               expr_cost(st.expr, self.binding).flops))
            self._view_costs[input_name] = cached
        return cached

    def _plan_decision(self, input_name: str, rank: int
                       ) -> Tuple[FrozenSet[str], FrozenSet[str]]:
        """(views to re-evaluate, views to lazily skip) for a firing of
        ``input_name`` at stacked rank ``rank``."""
        if self.plan is not None:
            reeval, lazy = self.plan.decide(rank, self._accum_rank)
        elif self.flush_policy == "cost":
            # planless cost-policy engines still get the per-view §7
            # fallback: re-evaluate any view the stacked rank pushed past
            # its crossover instead of sweeping it
            from .cost import batched_strategy
            reeval = frozenset(
                name for name, shape, re in
                self._factored_view_costs(input_name)
                if batched_strategy(shape, rank, rank, re) == "reeval")
            lazy = frozenset()
        elif not self._deferred:
            return frozenset(), frozenset()
        else:
            reeval, lazy = frozenset(), frozenset()
        if self._deferred:
            # deferred (depth >= 2) views are never swept per firing:
            # they skip like lazy views and are refreshed by window folds
            reeval = reeval - self._deferred
            lazy = lazy | self._deferred
        targets = {up.view
                   for up in self.compiled.triggers[input_name].updates}
        # keep the partition scoped to this trigger's targets, EXCEPT
        # that a lazy view left stale by an earlier firing (possibly of a
        # different input's trigger) must stay visible so the planned
        # codegen pulls it into the recompute closure when a view
        # re-evaluated here reads it — otherwise the in-firing reeval
        # would silently consume the stale value
        return reeval & targets, (lazy & targets) | (self._stale & lazy)

    def _planned_trigger_fn(self, input_name: str, bucket: int,
                            reeval: FrozenSet[str] = frozenset(),
                            lazy: FrozenSet[str] = frozenset()
                            ) -> Callable:
        """The trigger fn for (input, bucket, partition), built on first
        use through the shared cache.  An empty partition maintains every
        view incrementally.  A guarded or deferred engine's fns write out
        of place.  On a mesh the fn is the row-sharded trigger."""
        key = (input_name, bucket, tuple(sorted(reeval)),
               tuple(sorted(lazy)))
        fn = self._planned_fns.get(key)
        if fn is None:
            fn = self._cached_build(
                ("trigger",) + key + (self._out_of_place,),
                lambda: self._build_trigger(
                    self._bucket_trigger(input_name, bucket), reeval, lazy,
                    self._out_of_place))
            self._planned_fns[key] = fn
        return fn

    def _build_trigger(self, trig: Trigger, reeval=(), lazy=(),
                       out_of_place: bool = False) -> Callable:
        """The single-device trigger fn, or the row-sharded one on a
        mesh."""
        if self.mesh is not None:
            from ..dist.ivm_shard import build_distributed_trigger
            return build_distributed_trigger(
                trig, self.program, self.mesh, axis=self.mesh_axis,
                binding=self.binding, reeval_views=reeval, lazy_views=lazy,
                out_of_place=out_of_place)
        return build_trigger_fn(trig, self.program, self.binding,
                                self.device, reeval_views=reeval,
                                lazy_views=lazy, out_of_place=out_of_place)

    def _accumulate(self, views, rank: int) -> None:
        """Hybrid staleness: ``views`` took an incremental update of
        stacked rank ``rank``."""
        for name in views:
            self._accum_rank[name] = self._accum_rank.get(name, 0) + rank

    def _fire(self, input_name: str, bucket: int, P: Tensor, Q: Tensor,
              screened: bool = False) -> None:
        """One trigger firing, transactional when the engine is guarded
        (:meth:`repro_torch.guard.EngineGuard.fire`: the fused fast path,
        or snapshot → (chaos) → execute → validate outputs → commit, with
        an atomic rollback on any failure).  ``screened=True`` promises
        the factors already passed the host NaN/Inf screen (batch
        admission), so the fast path drops its device screen of them."""
        if self.guard is not None:
            return self.guard.fire(self, input_name, bucket, P, Q,
                                   screened=screened)
        if self.chaos is not None:
            # unguarded chaos: the injected fault propagates, exactly as
            # a real kernel error would without the guard layer
            self.chaos.maybe_raise_in_trigger()
        return self._fire_inner(input_name, bucket, P, Q)

    def _fire_inner(self, input_name: str, bucket: int, P: Tensor,
                    Q: Tensor) -> None:
        """One (possibly planned) trigger firing at stacked rank
        ``bucket``: partition the views per the plan (or the cost
        policy), execute, and keep the hybrid and lazy bookkeeping
        current.  Only the fn's incremental applies count as
        ``lowrank_applies``."""
        reeval, lazy = self._plan_decision(input_name, bucket)
        fn = self._planned_trigger_fn(input_name, bucket, reeval, lazy)
        self.views = fn(self.views, P, Q)
        self.stats.lowrank_applies += fn.lowrank_applies
        recomputed = set(fn.recomputes)
        # count only plan-DIRECTED re-evaluations; recomputed also holds
        # lazy views pulled into the recompute closure for exactness
        self.stats.plan_reevals += len(reeval)
        self.stats.lazy_skips += len(fn.skipped)
        self._stale |= set(fn.skipped)
        self._stale -= recomputed
        # hybrid staleness is kept under a plan or a partition, as in
        # the reference: a plain unplanned firing leaves it alone
        if self.plan is not None or reeval or lazy:
            self._accumulate(fn.incr_views, bucket)
        for name in recomputed:
            self._accum_rank[name] = 0

    def refresh(self, block: bool = False) -> Dict[str, Tensor]:
        """Recompute lazily-materialized views left stale by planned
        firings, in program order so stale ancestors refresh first; each
        gets storage of its own.  On a deferred-cascade engine this is a
        read point: any pending window is folded first, so every deferred
        view is exact on return."""
        if self._tiers and self._cascade_pending():
            self._fold(self._tiers[-1])
        if not self._stale:
            return self.views
        self._recompute([st for st in self.program.statements
                         if st.target.name in self._stale])
        if block:
            _sync(self.device)
        self._stale.clear()
        return self.views

    # -- lifecycle -----------------------------------------------------------
    def initialize(self, inputs: Dict[str, object]) -> Dict[str, Tensor]:
        """Full evaluation of the program; materializes every view.  The
        inputs are copied, so later in-place applies leave the caller's
        arrays alone.  On a mesh every rank evaluates the whole program
        from the same whole inputs, then keeps its row blocks
        (:func:`repro_torch.dist.ivm_shard.shard_views`); the returned
        views are this rank's."""
        missing = set(self.program.inputs) - set(inputs)
        if missing:
            raise KeyError(f"missing inputs: {sorted(missing)}")
        owned = _owned_views(inputs, self.device)
        computed = self._evaluator(owned)
        self.views = self._shard({**owned, **computed})
        del owned
        computed = {k: self.views[k] for k in computed}
        self._pending.clear()
        self._pending_since.clear()
        self._stale.clear()
        self._accum_rank.clear()
        self._cascade_rebase_all()
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
        self.views = self._shard(_owned_views(
            {k: views[k] for k in required}, self.device))
        self._pending.clear()
        self._pending_since.clear()
        self._stale.clear()
        self._accum_rank.clear()
        self._cascade_rebase_all()
        return self.views

    def views_numpy(self) -> Dict[str, np.ndarray]:
        """Every view as a host numpy array (the :meth:`load_views`
        counterpart); whole views, gathered on a mesh."""
        return {k: v.detach().cpu().numpy()
                for k, v in self._gather(self.views).items()}

    # -- incremental path ------------------------------------------------------
    def apply_update(self, input_name: str, u, v=None,
                     block: bool = False) -> Dict[str, Tensor]:
        """Fire the trigger for ``input_name += u @ v.T``.

        ``u`` may be a :class:`~.factored.DeltaCarrier` instead of a raw
        left factor (``v`` then stays ``None``): a no-op carrier skips the
        firing, a row-local carrier under ``rowlocal_fraction`` fires the
        row-local trigger, and everything else widens to this dense path.
        On a planned (or cost-policy) engine the firing executes the
        plan's per-view partition.
        """
        if isinstance(u, DeltaCarrier) or v is None:
            return self._apply_carrier(input_name, as_carrier(u, v),
                                       block=block)
        self._check_input(input_name)
        rank = self.compiled.triggers[input_name].rank
        if self._tiers and self._inputs_deferrable(input_name):
            # deferred-input fast path: bank the factors and return — the
            # fold materializes the input along with the views
            self._cascade_accumulate(input_name, [(u, v)],
                                     defer_input=True)
            self.stats.updates_applied += 1
            self.stats.triggers_fired += 1
            if block:
                _sync(self.device)
            return self.views
        if self.chaos is not None:
            u, v = self.chaos.poison_update(u, v)
        if self.guard is not None:
            admitted = self.guard.admit(input_name, u, v,
                                        defer_finite=self._guard_fast_path)
            if admitted is None:
                return self.views
            u, v = admitted
        t0 = time.perf_counter()
        u0, v0 = u, v
        u, v = _factor(u, self.device), _factor(v, self.device)
        if not self._fire_guarded(input_name, rank, u, v, u0, v0):
            return self.views
        if self._tiers:
            self._cascade_accumulate(input_name, [(u, v)])
        if block:
            _sync(self.device)
            self.stats.trigger_seconds += time.perf_counter() - t0
            self.stats.updates_timed += 1
            self.stats.sweep_flops_timed += self._sweep_flops(input_name,
                                                              rank)
        self.stats.updates_applied += 1
        self.stats.triggers_fired += 1
        self._observe_firing(input_name, rank, 1)
        if self.guard is not None:
            self.guard.after_firing(self)
        return self.views

    def _fire_guarded(self, input_name: str, bucket: int, P: Tensor,
                      Q: Tensor, P0, Q0, screened: bool = False) -> bool:
        """:meth:`_fire`; on a guarded engine a rolled-back firing's
        factors (``P0``, ``Q0``: as admitted, before padding) go to the
        guard's quarantine and False is returned."""
        if self.guard is None:
            self._fire(input_name, bucket, P, Q)
            return True
        from ..guard.txn import FiringAborted
        try:
            self._fire(input_name, bucket, P, Q, screened=screened)
        except FiringAborted as e:
            self.guard.on_abort(input_name, P0, Q0, e.reason)
            return False
        return True

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
        self._check_input(input_name)
        updates = list(updates)
        if any(isinstance(x, DeltaCarrier) for x in updates):
            return self._apply_carrier_batch(input_name, updates,
                                             block=block)
        if self.chaos is not None:
            updates = [self.chaos.poison_update(u, v) for u, v in updates]
        if not updates:
            return self.views
        if self._tiers and self._inputs_deferrable(input_name):
            # deferred-input fast path: every maintained target of this
            # trigger is folded from the window anyway, so the firing banks
            # its factors and launches nothing; a read (or a due fold)
            # first materializes the pending input state
            self._cascade_accumulate(input_name, updates, defer_input=True)
            self.stats.updates_applied += len(updates)
            self.stats.triggers_fired += 1
            self.stats.batches_applied += 1
            if block:
                _sync(self.device)
            return self.views
        t0 = time.perf_counter()  # admission and stacking are part of the
        # batch's cost: the guard's fast path stacks once, as it screens
        P = Q = None
        if self.guard is not None:
            stacked = self.guard.admit_batch_stacked(input_name, updates)
            if stacked is not None:
                P, Q = (_factor(x, self.device) for x in stacked)
            else:
                # careful walk: one poisoned update quarantines alone and
                # the healthy remainder still batches
                updates = self.guard.admit_batch(input_name, updates)
                if not updates:
                    return self.views
        t_count = len(updates)
        if P is None:
            P, Q = stack_update_arrays(updates, self.device)
        stacked_rank = P.shape[1]
        if self.max_batch_rank is not None and P.shape[1] > self.max_batch_rank:
            P, Q = recompress_factors(P, Q, max_rank=self.max_batch_rank,
                                      tol=self.recompress_tol)
            self.stats.recompressions += 1
        P0, Q0 = P, Q  # pre-padding factors (what a rollback quarantines)
        bucket = batch_bucket(P.shape[1])
        P, Q = pad_factors_to_rank(P, Q, bucket)
        # batch admission already screened the factors
        if not self._fire_guarded(input_name, bucket, P, Q, P0, Q0,
                                  screened=True):
            return self.views
        if self._tiers:
            self._cascade_accumulate(input_name, [(P0, Q0)])
        if block:
            _sync(self.device)
            self.stats.trigger_seconds += time.perf_counter() - t0
            self.stats.updates_timed += t_count
            self.stats.sweep_flops_timed += self._sweep_flops(input_name,
                                                              bucket)
        self.stats.updates_applied += t_count
        self.stats.triggers_fired += 1
        self.stats.batches_applied += 1
        self._observe_firing(input_name, stacked_rank, t_count)
        if self.guard is not None:
            self.guard.after_firing(self)
        return self.views

    def _sweep_flops(self, input_name: str, rank: int) -> float:
        """FLOPs of one factored sweep over this trigger's maintained
        views at stacked rank ``rank`` — the denominator behind
        ``stats.trigger_seconds`` that online cost_scale refitting
        (:meth:`repro_torch.plan.AdaptivePlanner.refit_from_stats`)
        divides by."""
        return sum(2.0 * rank * n * m for _, (n, m), _
                   in self._factored_view_costs(input_name))

    def _observe_firing(self, input_name: str, stacked_rank: int,
                        t_count: int,
                        affected_fraction: Optional[float] = None) -> None:
        """Report one firing to the attached adaptive planner (every
        path: single, batched, row-local), adopting a re-plan if due.
        Row-local firings also report their affected fraction."""
        if self.planner is None:
            return
        self.planner.observe(input_name, stacked_rank, t_count,
                             affected_fraction=affected_fraction)
        self.planner.refit_from_stats(self.stats)
        new_plan = self.planner.maybe_replan()
        if new_plan is not None:
            self.set_plan(new_plan)
            self.stats.replans += 1

    def _bucket_trigger(self, input_name: str, bucket: int) -> Trigger:
        """The trigger IR for (input, stacked-rank bucket)."""
        base = self.compiled.triggers[input_name]
        if bucket == base.rank:
            return base
        key = (input_name, bucket)
        trig = self._bucket_triggers.get(key)
        if trig is None:
            trig = compile_batched_trigger(self.compiled, input_name, bucket)
            self._bucket_triggers[key] = trig
        return trig

    # -- sparsity-aware carrier path (factored.DeltaCarrier) ------------------
    def _check_input(self, input_name: str) -> None:
        if input_name not in self.compiled.triggers:
            raise KeyError(f"no trigger for input {input_name!r}; have "
                           f"{sorted(self.compiled.triggers)}")

    def _rowlocal_ok(self, input_name: str, carrier: DeltaCarrier) -> bool:
        """Whether a row-local carrier may fire the row-local trigger: its
        affected fraction is under ``rowlocal_fraction``, at least one
        maintained view (not the input itself) is one the compiler proved
        row-local — otherwise every view widens and the row trigger buys
        nothing over the dense sweep — and the plan's partition is empty
        (a firing the plan wants to re-evaluate or skip goes through the
        planned dense firing).  When *every* maintained view is row-local
        the plan (or §7) decision is priced at the containment-scaled
        rank ``ceil(rank · frac)``: a row sweep touches ``r·m`` elements
        where the dense sweep the crossover was solved for touches
        ``n·m``.  Triggers with any widened view keep the full-rank
        price: those views really do pay the dense sweep.  An engine with
        deferred views widens every carrier into its window: a fold sweeps
        from a base snapshot, so there is no row-local path at depth >= 2
        (the dense path is its oracle).  An engine on a mesh widens every
        carrier too: the row-local trigger indexes whole views, a rank
        holds a row block."""
        if self._tiers or self.mesh is not None:
            return False
        frac = carrier.affected_fraction()
        if frac > self.rowlocal_fraction:
            return False
        trig = self.compiled.triggers[input_name]
        kinds = [trig.carriers.get(up.view) for up in trig.updates
                 if up.kind == "lowrank" and up.view != input_name]
        if not any(kd == "row_local" for kd in kinds):
            return False
        rank = max(carrier.rank, 1)
        if all(kd == "row_local" for kd in kinds):
            rank = max(1, int(np.ceil(rank * frac)))
        reeval, lazy = self._plan_decision(input_name, rank)
        return not reeval and not lazy

    def _rowlocal_trigger_fn(self, input_name: str, bucket: int) -> Callable:
        """The row-local trigger for (input, rank bucket), built on first
        use."""
        key = (input_name, bucket)
        fn = self._rowlocal_fns.get(key)
        if fn is None:
            fn = self._cached_build(
                ("rowlocal", input_name, bucket, self.rowlocal_fraction,
                 self._out_of_place),
                lambda: build_rowlocal_trigger_fn(
                    self._bucket_trigger(input_name, bucket), self.program,
                    self.binding, self.device,
                    max_fraction=self.rowlocal_fraction,
                    out_of_place=self._out_of_place))
            self._rowlocal_fns[key] = fn
        return fn

    def _apply_carrier(self, input_name: str, carrier: DeltaCarrier,
                       block: bool = False) -> Dict[str, Tensor]:
        """Dispatch one carrier: no-op → skip, contained row-local →
        row-local firing, anything else → widen to the dense factored path
        (``carrier.factors()`` is exact, so widening changes only the
        traffic)."""
        self._check_input(input_name)
        if carrier.kind == "noop":
            self.stats.noop_skips += 1
            self.stats.updates_applied += 1
            if block:
                _sync(self.device)
            return self.views
        if carrier.kind == "row_local":
            if self._rowlocal_ok(input_name, carrier):
                return self._apply_rowlocal(input_name, carrier, block=block)
            self.stats.widened_carriers += 1
        P, Q = carrier.factors(self.device)
        return self.apply_update(input_name, P, Q, block=block)

    def _apply_rowlocal(self, input_name: str, carrier: RowLocalCarrier,
                        block: bool = False, t_count: int = 1,
                        poisoned: bool = False) -> Dict[str, Tensor]:
        """Fire the row-local trigger for one (possibly stacked) row-local
        carrier: chaos poisoning and guard admission run on the compact
        ``(block, V)`` factors (``poisoned``: the batch path already
        poisoned each member), then the rank is zero-padded to its
        power-of-two bucket, as for raw pairs; the rows stay exact (eager
        torch needs no row bucket)."""
        rows = np.asarray(carrier.rows)
        B = np.asarray(carrier.block, dtype=np.float32)
        V = np.asarray(carrier.V, dtype=np.float32)
        if self.chaos is not None and not poisoned:
            B, V = (np.asarray(x, dtype=np.float32)
                    for x in self.chaos.poison_update(B, V))
        if self.guard is not None:
            admitted = self.guard.admit_carrier(input_name, rows, B, V,
                                                count=t_count)
            if admitted is None:
                return self.views
            B, V = admitted
        t0 = time.perf_counter()
        B0, V0 = B, V  # pre-padding (what an abort keeps)
        rank = B.shape[1]
        base = self.compiled.triggers[input_name].rank
        bucket = rank if rank == base else batch_bucket(rank)
        if bucket != rank:
            B = np.pad(B, ((0, 0), (0, bucket - rank)))
            V = np.pad(V, ((0, 0), (0, bucket - rank)))
        fn = self._rowlocal_trigger_fn(input_name, bucket)
        originals = {}
        if self._cow_rows:
            for name in fn.row_views:
                originals[name] = self.views[name]
                self.views[name] = self.views[name].clone()
        if self.guard is not None:
            from ..guard.txn import FiringAborted
            try:
                self.guard.fire_rowlocal(self, input_name, fn, rows, B, V)
            except FiringAborted as e:
                # the rollback restored the copies' rows; hand back the
                # very pre-firing tensors, as a dense rollback does
                self.views.update(originals)
                P0 = np.zeros((int(carrier.nm[0]), B0.shape[1]), np.float32)
                P0[rows] = B0
                self.guard.on_abort(input_name, P0, V0, e.reason)
                return self.views
        else:
            if self.chaos is not None:
                self.chaos.maybe_raise_in_trigger()
            self.views = fn(self.views, rows, B, V)
        self.stats.row_applies += fn.row_applies
        self.stats.lowrank_applies += fn.dense_applies
        if self.plan is not None:
            self._accumulate((up.view for up in
                              self.compiled.triggers[input_name].updates),
                             bucket)
        if block:
            _sync(self.device)
            self.stats.trigger_seconds += time.perf_counter() - t0
            self.stats.updates_timed += t_count
            self.stats.sweep_flops_timed += self._rowlocal_sweep_flops(
                input_name, bucket, len(rows))
        self.stats.updates_applied += t_count
        self.stats.triggers_fired += 1
        self.stats.rowlocal_firings += 1
        if t_count > 1:
            self.stats.batches_applied += 1
        self._observe_firing(input_name, rank, t_count,
                             affected_fraction=carrier.affected_fraction())
        if self.guard is not None:
            self.guard.after_firing(self)
        return self.views

    def _rowlocal_sweep_flops(self, input_name: str, rank: int,
                              r: int) -> float:
        """FLOPs of one row-local sweep: row-local views pay
        ``2·rank·r·m``, widened views the full ``2·rank·n·m``."""
        trig = self.compiled.triggers[input_name]
        total = 0.0
        for name, (n, m), _ in self._factored_view_costs(input_name):
            rows_eff = r if trig.carriers.get(name) == "row_local" else n
            total += 2.0 * rank * rows_eff * m
        return total

    def _apply_carrier_batch(self, input_name: str, updates,
                             block: bool = False) -> Dict[str, Tensor]:
        """Batched carrier path: drop no-ops, stack the rest
        (:func:`~.factored.stack_carriers` — union row support while
        everything stays row-local), and fire once.  A stack that widens
        — any dense member, or a union past the crossover — expands to
        factor pairs and takes the ordinary batched path."""
        carriers =[x if isinstance(x, DeltaCarrier)
                    else as_carrier(x[0], x[1]) for x in updates]
        live = [c for c in carriers if c.kind != "noop"]
        skipped = len(carriers) - len(live)
        self.stats.noop_skips += skipped
        self.stats.updates_applied += skipped
        if not live:
            if block:
                _sync(self.device)
            return self.views
        stacked = stack_carriers(live)
        if not (stacked.kind == "row_local"
                and self._rowlocal_ok(input_name, stacked)):
            self.stats.widened_carriers += \
                sum(1 for c in live if c.kind == "row_local")
            return self.apply_updates(input_name,
                                      [c.factors(self.device) for c in live],
                                      block=block)
        if self.chaos is not None:
            # one poison gate a member, compactly: the draws of the dense
            # batched path
            live = [RowLocalCarrier(c.rows, *(
                np.asarray(x, dtype=np.float32)
                for x in self.chaos.poison_update(c.block, c.V)), c.n)
                for c in live]
            stacked = stack_carriers(live)
        if (self.max_batch_rank is not None
                and stacked.rank > self.max_batch_rank):
            # QR of the compact block touches only the r affected rows, so
            # the row support is kept exactly
            B2, V2 = recompress_factors(torch.from_numpy(stacked.block),
                                        torch.from_numpy(stacked.V),
                                        max_rank=self.max_batch_rank,
                                        tol=self.recompress_tol)
            stacked = RowLocalCarrier(stacked.rows, B2.numpy(), V2.numpy(),
                                      stacked.n)
            self.stats.recompressions += 1
        return self._apply_rowlocal(input_name, stacked, block=block,
                                    t_count=len(live), poisoned=True)

    # -- update queue (serving-path coalescing) --------------------------------
    def enqueue_update(self, input_name: str, u, v
                       ) -> Optional[Dict[str, Tensor]]:
        """Queue ``input_name += u @ v.T`` for the next coalesced flush.

        Flushes automatically per the engine's ``flush_policy`` —
        ``"fixed"``: the pending stacked rank reaches ``flush_size``;
        ``"cost"``: it reaches :meth:`cost_flush_rank`; both: the oldest
        queued update is older than ``flush_age`` seconds.  Returns the
        refreshed views on flush, else ``None`` (views are stale until
        the next :meth:`flush`).
        """
        self._check_input(input_name)
        u, v = _queued(u, self.device), _queued(v, self.device)
        if self.chaos is not None:
            u, v = self.chaos.poison_update(u, v)
        if self.guard is not None:
            admitted = self.guard.admit(input_name, u, v)
            if admitted is None:
                return None
            u, v = admitted
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
        """Flush one input's queue if the active policy says so: its age
        past ``flush_age``, or its stacked rank at ``flush_size``
        (``"fixed"``) or :meth:`cost_flush_rank` (``"cost"``).  Flushing
        at the crossover does not by itself re-evaluate the losing view —
        it bounds the stacked rank; the flushed firing then makes the
        per-view choice (:meth:`_fire`)."""
        if self.pending_age(input_name) >= self.flush_age:
            return self.flush(input_name)
        threshold = (self.cost_flush_rank(input_name)
                     if self.flush_policy == "cost" else self.flush_size)
        if self.pending_rank(input_name) >= threshold:
            return self.flush(input_name)
        return None

    def cost_flush_rank(self, input_name: str) -> int:
        """The stacked rank at which the ``"cost"`` policy flushes: one
        past the smallest §7 crossover of the trigger's factored views
        (the first integer K with reeval_flops < 2·K·n·m).  Cached per
        input; a trigger with no factored view falls back to
        ``flush_size``."""
        cached = self._cost_flush_rank.get(input_name)
        if cached is None:
            firsts = [int(reeval / (2.0 * n * m)) + 1
                      for _, (n, m), reeval
                      in self._factored_view_costs(input_name)]
            cached = min(firsts) if firsts else self.flush_size
            self._cost_flush_rank[input_name] = cached
        return cached

    def flush(self, input_name: Optional[str] = None,
              block: bool = False) -> Dict[str, Tensor]:
        """Apply all pending updates (for one input, or every input).

        The exactness point before a read: also recomputes any lazily
        maintained views that planned firings left stale, so every view
        in :attr:`views` is current when this returns."""
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
        if self._stale or (self._tiers and self._cascade_pending()):
            self.refresh(block=block)
        return self.views

    # -- baseline path ---------------------------------------------------------
    def reevaluate(self, block: bool = False) -> Dict[str, Tensor]:
        """The paper's re-evaluation strategy: recompute from the current
        inputs (which the triggers have been keeping up to date)."""
        self._apply_pending_inputs()  # deferred-input engines: make current
        inputs = {k: self.views[k] for k in self.program.inputs}
        t0 = time.perf_counter()
        computed = self._evaluate(inputs)
        if block:
            _sync(self.device)
            self.stats.reeval_seconds += time.perf_counter() - t0
            self.stats.reeval_flops_timed += self.reeval_flops()
        self.views.update(computed)
        self._stale.clear()
        self._accum_rank.clear()
        self._cascade_rebase_all()  # windows are void: every view is current
        self.stats.reevals += 1
        return dict(computed)

    # -- introspection -----------------------------------------------------------
    def output(self, name: Optional[str] = None) -> Tensor:
        """A view, exact: a read point, so stale lazy views are
        refreshed first; counts ``stats.reads`` (and tells an adaptive
        planner).  On a deferred-cascade engine every pending window is
        folded first.  On a mesh the view is gathered whole on every rank
        (a collective: every rank reads the same view)."""
        self.stats.reads += 1
        if self.planner is not None:
            self.planner.observe_read()
        if self._stale or (self._tiers and self._cascade_pending()):
            self.refresh()
        name = name or self.program.output_names()[0]
        return self._gather([name])[name]

    def trigger_flops(self, input_name: str) -> float:
        return trigger_flops(self.compiled.triggers[input_name], self.program,
                             self.binding)

    # -- materialized Δᵈ views (symbolic hierarchy) ---------------------------
    def delta_trigger_fn(self, input_name: str, depth: int,
                         rank: Optional[int] = None) -> Callable:
        """The trigger maintaining the ``__d{depth}__V`` views, ``(views,
        U, V) -> views``, out of place (the caller's store is left
        alone).  Its shared-cache key carries the depth (and the engine
        namespace the order signature), so a depth-2 trigger never reuses
        a first-order fn."""
        if rank is None:
            rank = self.compiled.triggers[input_name].rank
        bucket = batch_bucket(rank)
        if depth == 1:
            return self._planned_trigger_fn(input_name, bucket)
        key = (input_name, depth, bucket)
        fn = self._delta_fns.get(key)
        if fn is None:
            fn = self._cached_build(("delta",) + key,
                                    lambda: self._build_delta(*key))
            self._delta_fns[key] = fn
        return fn

    def _build_delta(self, input_name: str, depth: int, bucket: int
                     ) -> Callable:
        fire = self._build_trigger(
            compile_delta_trigger(self.compiled, input_name, depth, bucket),
            out_of_place=True)
        device = self.device

        def run(views: Dict[str, Tensor], u, v) -> Dict[str, Tensor]:
            # factors as the engine's own paths take them: numpy or
            # tensors, 1-D or (n, k)
            return fire(views, _factor(u, device), _factor(v, device))

        run.lowrank_applies = fire.lowrank_applies
        return run

    def materialize_delta_views(self, input_name: str, depth: int,
                                rank: Optional[int] = None
                                ) -> Tuple[str, ...]:
        """Zero-initialize the ΔᵈV auxiliary views the depth-``depth``
        trigger for ``input_name`` maintains; returns their names."""
        from .cost import shape_of
        if rank is None:
            rank = self.compiled.triggers[input_name].rank
        trig = compile_delta_trigger(self.compiled, input_name, depth,
                                     batch_bucket(rank))
        by_name = {st.target.name: st.target
                   for st in self.program.statements}
        names = []
        for up in trig.updates:
            n, m = shape_of(by_name[up.view.split("__", 2)[-1]],
                            self.binding)
            if self.mesh is not None:
                n, m = self._shards.block_shape((n, m))
            if up.view not in self.views:
                self.views[up.view] = torch.zeros(
                    (n, m), dtype=torch.float32, device=self.device)
            names.append(up.view)
        return tuple(names)

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
