"""Online re-planning: watch the workload, re-plan when it drifts.

The static planner prices a plan against a *declared*
:class:`WorkloadDescriptor`; real update streams drift — adapter bursts
grow, batch coalescing changes T, a quiet corpus suddenly takes
high-rank refreshes.  :class:`AdaptivePlanner` closes the loop: the
engine reports every firing's observed stacked rank, and every
``replan_every`` firings the planner refits the descriptor to the
observed distribution (median / p10 / p90) and re-plans if the fit has
drifted past ``drift_tol``.  A re-plan that changes no per-view choice
is discarded; one that does is handed back to the engine, which
hot-swaps it (pending queues survive, cached triggers for already-seen
(bucket, partition) keys are reused from the trigger cache).
"""

from __future__ import annotations

from collections import deque
from dataclasses import replace
from typing import Deque, Dict, Optional

from .planner import (MaintenancePlan, WorkloadDescriptor, plan_program,
                      program_fingerprint)


class AdaptivePlanner:
    """Re-plans a :class:`MaintenancePlan` from observed firings.

    Construct unbound (``AdaptivePlanner(workload)``) and hand to
    ``IncrementalEngine(plan=...)`` — the engine binds it to its
    compiled program — or bind explicitly with :meth:`bind` for
    standalone use.
    """

    def __init__(self, workload: Optional[WorkloadDescriptor] = None, *,
                 replan_every: int = 8, drift_tol: float = 0.5,
                 history: int = 256):
        if replan_every < 1:
            raise ValueError(f"replan_every must be ≥ 1, got {replan_every}")
        self.workload = workload or WorkloadDescriptor()
        self.replan_every = replan_every
        self.drift_tol = drift_tol
        self._ranks: Deque[int] = deque(maxlen=history)
        self._batches: Deque[int] = deque(maxlen=history)
        self._fractions: Deque[float] = deque(maxlen=history)
        self._firings = 0
        self._reads = 0
        self._since_replan = 0
        self._force_replan = False
        #: per-view count of sentinel-reported drift recoveries
        self.drift_counts: Dict[str, int] = {}
        self.replans = 0
        self.plan: Optional[MaintenancePlan] = None
        self._compiled = None
        self._binding: Optional[Dict[str, int]] = None
        self._mesh = None
        self._mesh_axis: Optional[str] = None

    # -- binding -------------------------------------------------------------
    def bind(self, compiled, binding: Optional[Dict[str, int]] = None,
             mesh=None, mesh_axis: Optional[str] = None) -> MaintenancePlan:
        """Attach to a compiled program (and the engine's mesh) and
        produce the initial plan.  Re-binding to the same fingerprint
        keeps observation history."""
        fp = program_fingerprint(compiled.program, binding)
        if self.plan is not None and self.plan.fingerprint != fp:
            raise ValueError(
                "AdaptivePlanner is already bound to a different program "
                f"({self.plan.fingerprint} != {fp})")
        self._compiled = compiled
        self._binding = dict(compiled.program.dims
                             if binding is None else binding)
        self._mesh, self._mesh_axis = mesh, mesh_axis
        if self.plan is None:
            self.plan = plan_program(compiled, self.workload,
                                     binding=self._binding, mesh=mesh,
                                     mesh_axis=mesh_axis)
        return self.plan

    @property
    def bound(self) -> bool:
        return self._compiled is not None

    def adopt(self, plan: MaintenancePlan) -> None:
        """Accept an externally installed plan (engine hot-swap) as the
        new baseline, so the next drift check prices against it instead
        of silently reverting to the planner's own stale fit."""
        if self.plan is not None and self.plan.fingerprint != plan.fingerprint:
            raise ValueError(
                "cannot adopt a plan for a different program "
                f"({plan.fingerprint} != {self.plan.fingerprint})")
        self.plan = plan
        self.workload = plan.workload
        self._since_replan = 0

    # -- observation loop ----------------------------------------------------
    def observe(self, input_name: str, stacked_rank: int,
                batch_size: int,
                affected_fraction: Optional[float] = None) -> None:
        """Record one firing (pre-padding stacked rank, T updates).

        ``affected_fraction`` is the firing's observed row containment
        (``r/n`` for a row-local carrier, 1.0 for a dense firing) — the
        fitted descriptor carries its p90, so a stream that turns out
        contained re-prices row-local-closed views at the row-slab
        sweep cost, and one that widens drops the discount."""
        self._ranks.append(max(1, int(stacked_rank)))
        self._batches.append(max(1, int(batch_size)))
        self._fractions.append(1.0 if affected_fraction is None
                               else min(1.0, max(0.0, affected_fraction)))
        self._firings += 1
        self._since_replan += 1

    def observe_read(self) -> None:
        """Record one view read (engine ``output()``).  The observed
        reads-per-firing ratio is what makes depth pay: a stream of
        updates between sparse reads is exactly the window a deferred
        order-k cascade amortizes, so the fit feeds
        ``WorkloadDescriptor.reads_per_firing`` when ``max_order ≥ 2``.
        """
        self._reads += 1

    def observed_workload(self) -> Optional[WorkloadDescriptor]:
        """The empirical descriptor: median/p10/p90 of observed stacked
        ranks, with the median batch size factored out so the fitted
        (update_rank, batch_size) keep their declared meanings.  When
        the declared workload opts into depth (``max_order ≥ 2``) the
        fit also includes the observed reads-per-firing ratio — the
        signal :func:`repro_torch.plan.planner.plan_program` prices depth-k
        maintenance against."""
        if not self._ranks:
            return None
        ranks, batches = sorted(self._ranks), sorted(self._batches)
        q = lambda xs, p: xs[min(len(xs) - 1, int(p * len(xs)))]
        t = max(1, q(batches, 0.5))
        k = max(1, round(q(ranks, 0.5) / t))
        fitted = replace(self.workload, update_rank=k, batch_size=t,
                         rank_lo=q(ranks, 0.1), rank_hi=q(ranks, 0.9))
        if self._fractions:
            # p90 (not mean): the discount must hold for the stream's
            # wide tail, or the plan underprices its worst firings
            frac = q(sorted(self._fractions), 0.9)
            fitted = replace(fitted,
                             affected_fraction=None if frac >= 1.0
                             else max(frac, 1e-6))
        if self.workload.max_order >= 2 and self._firings > 0:
            fitted = replace(fitted,
                             reads_per_firing=self._reads / self._firings)
        return fitted

    # -- external signals (guard / stats) ---------------------------------------
    def note_drift(self, names) -> None:
        """The drift sentinel re-evaluated ``names`` back to exactness:
        their incremental maintenance is numerically too aggressive for
        this workload.  Record it and force a re-plan at the next
        firing (bypassing the drift-tolerance gate) so the pricing can
        react — e.g. a refitted rank distribution tipping the repeat
        offender to hybrid/re-evaluation."""
        for n in names:
            self.drift_counts[n] = self.drift_counts.get(n, 0) + 1
        self._force_replan = True

    def refit_from_stats(self, stats) -> Optional[float]:
        """Refit ``cost_scale`` online from an engine's measured rates.

        ``stats`` is an :class:`~repro_torch.core.runtime.EngineStats` whose
        timed counters pair wall-clock with the FLOPs they covered:
        sweep seconds-per-FLOP over re-evaluation seconds-per-FLOP *is*
        the workload's ``cost_scale`` (the calibration
        :func:`repro_torch.plan.calibrate_cost_scale` measures offline).
        Needs both paths to have run with ``block=True`` at least once;
        returns the fitted scale (or ``None`` when unmeasurable).  A
        material change (> ``drift_tol`` relative) updates the workload
        and forces a re-plan.
        """
        sweep_f = getattr(stats, "sweep_flops_timed", 0.0)
        reeval_f = getattr(stats, "reeval_flops_timed", 0.0)
        if (sweep_f <= 0 or reeval_f <= 0
                or stats.trigger_seconds <= 0 or stats.reeval_seconds <= 0):
            return None
        sweep_rate = stats.trigger_seconds / sweep_f
        reeval_rate = stats.reeval_seconds / reeval_f
        scale = max(sweep_rate / reeval_rate, 1e-3)
        old = self.workload.cost_scale
        if abs(scale - old) > self.drift_tol * max(old, 1e-12):
            self.workload = replace(self.workload, cost_scale=scale)
            self._force_replan = True
        return scale

    def maybe_replan(self) -> Optional[MaintenancePlan]:
        """Re-plan if due and drifted; returns the new plan only when a
        per-view choice actually changed (else ``None``).  A pending
        :meth:`note_drift` / :meth:`refit_from_stats` signal forces the
        re-plan regardless of cadence or rank drift."""
        force, self._force_replan = self._force_replan, False
        if (not self.bound or self.plan is None
                or (self._since_replan < self.replan_every and not force)):
            self._force_replan = force  # keep the signal until due
            return None
        self._since_replan = 0
        fitted = self.observed_workload()
        if fitted is None:
            if not force:
                return None
            fitted = self.workload
        if not force:
            expected = self.workload.expected_rank()
            if abs(fitted.expected_rank() - expected) <= \
                    self.drift_tol * max(expected, 1):
                return None
        self.workload = fitted
        new = plan_program(self._compiled, fitted, binding=self._binding,
                           mesh=self._mesh, mesh_axis=self._mesh_axis)
        if new.views == self.plan.views:
            self.plan = new  # same choices, fresher pricing
            return None
        self.plan = new
        self.replans += 1
        return new
