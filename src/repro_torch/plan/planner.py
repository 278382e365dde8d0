"""Cost-based maintenance planning for compiled IVM programs (§5–§7).

LINVIEW's central economic claim is that incremental maintenance only
wins when you *choose* per view: factored delta propagation while the
update rank stays small, re-evaluation once the avalanche makes the
delta as expensive as recomputing (§7 crossover), and a hybrid of the
two when the workload straddles the boundary.  The engine has always
had the cost model (:mod:`repro_torch.core.cost`) and the compiled
triggers (:mod:`repro_torch.core.compiler`); this module connects them into an
executable **maintenance plan**:

  * a per-view **strategy** — ``"incremental"`` | ``"reeval"`` |
    ``"hybrid"`` (incremental until a rank/staleness threshold, then
    re-evaluate);
  * a DAG-level **materialization choice** — an intermediate view is
    kept eagerly maintained iff its amortized per-firing delta cost
    beats recomputing it (and its consumers) on demand, à la §5's
    intermediate-view discussion;
  * the **workload descriptor** the choices were priced under, so an
    adaptive planner can detect drift and re-plan online.

Plans are pure data (JSON-serializable) — execution lives in
:class:`repro_torch.core.runtime.IncrementalEngine`, compiled-trigger
reuse in :mod:`repro_torch.plan.trigger_cache`.  See docs/planner.md.

This module is the port's own copy of the JAX package's planner: pure
arithmetic over the symbolic program, so a plan and its fingerprint are
the same string in both packages.  A plan priced with a mesh carries the
mesh's key (:func:`repro_torch.plan.trigger_cache.mesh_cache_key`), and
an engine runs it only on that mesh.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, replace
from typing import Dict, FrozenSet, List, Optional, Tuple

from ..core.codegen import trigger_touched_views
from ..core.compiler import CompiledProgram, compile_program
from ..core.cost import (batch_crossover_rank, batched_strategy,
                             cholesky_factor_cost, cholesky_update_cost,
                             expr_cost, expr_cost_kinds,
                             rowlocal_crossover_fraction, shape_of,
                             triangular_solve_cost)
from ..core.program import Program

STRATEGIES = ("incremental", "reeval", "hybrid")


# ---------------------------------------------------------------------------
# workload descriptor
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkloadDescriptor:
    """What the planner prices against: the update stream shape.

    ``update_rank`` × ``batch_size`` is the typical stacked rank of one
    trigger firing; ``rank_lo`` / ``rank_hi`` bound the distribution
    (default: the expectation itself — a point mass).  A view whose §7
    crossover lies above ``rank_hi`` is always incremental, below
    ``rank_lo`` always re-evaluated, and in between goes hybrid.
    ``reads_per_firing`` is how often the store is *read* relative to
    firings — the materialization lever: intermediates nobody reads can
    be maintained lazily.

    ``cost_scale`` corrects the FLOP model for the backend: the
    wall-clock cost of one incremental-sweep FLOP relative to one
    re-evaluation FLOP (``1.0`` = trust FLOPs).  Skinny rank-K updates
    run at a far worse rate than the dense matmuls re-evaluation is
    made of — >10x on CPU BLAS — so the *effective* §7 crossover sits
    at ``K*/cost_scale``.  Measure it with
    :func:`repro_torch.plan.calibrate_cost_scale`.

    ``chain_aware`` additionally prices the trigger's shared delta
    chain into each view's sweep cost.  The assigns of one trigger
    (``ΔZ``-style intermediate factors) are computed once per firing and
    amortize across every view maintained incrementally — but when
    siblings cross to re-evaluation, a *lone* incremental view keeps
    the whole chain it reads alive and bears its full cost.  The naive
    per-view ``2·K·n·m`` sweep price ignores that, overestimating how
    long incremental maintenance keeps winning (and underestimating the
    firing costs a fleet scheduler prioritizes by).  Off by default so
    declared-workload plans stay stable; the fleet turns it on.

    ``op_cost_scales`` refines the *re-evaluation* side per op kind
    (keys ``"matmul"`` / ``"inverse"`` / ``"other"``, values =
    wall-clock per FLOP relative to a dense matmul FLOP; missing kinds
    default to 1.0).  An OLS view whose re-evaluation is mostly an n×n
    ``Inverse`` runs those FLOPs several× slower than the matmul rate
    the plain count assumes, so its true crossover sits above the
    unscaled ``K*`` — exactly the cells straddling the §7 boundary that
    a single global scale misplans.  Measure with
    :func:`repro_torch.plan.calibrate_op_cost_scales`.
    """

    update_rank: int = 1          # per-update factored rank k
    batch_size: int = 1           # T updates coalesced per firing
    rank_lo: Optional[int] = None
    rank_hi: Optional[int] = None
    reads_per_firing: float = 1.0
    # expected fraction of input rows one update touches (None = dense /
    # unknown).  With a fraction set, views the compiler proved row-local
    # (Trigger.carriers) are priced at the row-slab sweep cost — their
    # effective §7 crossover scales by 1/fraction, so containment keeps
    # incremental maintenance winning at stacked ranks where a dense
    # sweep would already have crossed to re-evaluation.
    affected_fraction: Optional[float] = None
    cost_scale: float = 1.0       # wall-clock per-FLOP cost of the sweep
    #                               relative to re-evaluation (calibrated)
    chain_aware: bool = False     # price the shared delta chain into sweeps
    op_cost_scales: Optional[Dict[str, float]] = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Optional[Tuple[str, ...]] = None
    # higher-order (deferred-cascade) capability: max depth plan_program
    # may assign per view (1 = classic first order, no depth pricing),
    # the engine's fold window base, and the stacked-window rank cap —
    # the extra-state/QR-recompression side of the depth trade-off
    max_order: int = 1
    fold_window: int = 8
    max_fold_rank: int = 64

    def effective_reeval_flops(self, kinds: Dict[str, float]) -> float:
        """Σ kind_flops × kind_scale — FLOPs in matmul-equivalents."""
        if not self.op_cost_scales:
            return sum(kinds.values())
        return sum(f * self.op_cost_scales.get(k, 1.0)
                   for k, f in kinds.items())

    def expected_rank(self) -> int:
        return max(1, int(self.update_rank) * int(self.batch_size))

    def rank_bounds(self) -> Tuple[int, int]:
        k = self.expected_rank()
        lo = k if self.rank_lo is None else max(1, int(self.rank_lo))
        # hi floors at lo so a descriptor with only rank_lo set can
        # never produce inverted bounds (hi < lo would misclassify
        # always-past-crossover workloads as incremental)
        hi = max(lo, k) if self.rank_hi is None else max(lo, int(self.rank_hi))
        return lo, hi


# ---------------------------------------------------------------------------
# plan format
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ViewPlan:
    """One maintained view's refresh policy.

    ``materialize=False`` is only sound for views that no trigger's
    surviving factor blocks read — :func:`plan_program` guarantees this
    (``_trigger_read_views`` ∪ outputs ∪ inputs are never lazy); a
    hand-crafted plan that unmaterializes a factor-block-read view
    feeds stale values to incremental consumers.  Views read only by
    *re-evaluated* consumers are safe: the engine pulls stale lazy
    views into the recompute closure."""

    view: str
    strategy: str                       # "incremental" | "reeval" | "hybrid"
    threshold_rank: Optional[int] = None  # hybrid: switch to reeval here
    materialize: bool = True            # False → lazy (recompute on read)
    crossover_rank: int = 0             # §7 crossover (diagnostic)
    reeval_flops: float = 0.0           # view re-evaluation cost (diagnostic)
    # delta depth: 1 = per-firing maintenance (strategy above applies);
    # o >= 2 = deferred cascade — the engine folds this view's update
    # window every fold_window**(o-1) firings (or at the next read)
    # instead of sweeping per firing
    order: int = 1
    # row-local containment: True when the compiler proved this view's
    # delta row-support-preserving under every trigger that maintains it
    # AND the workload's affected fraction sits under the traffic
    # crossover — its strategy above was priced at the row-slab sweep
    # cost, and fleet firing pricing scales its sweep by the fraction
    row_local: bool = False

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.order < 1:
            raise ValueError(f"order must be >= 1, got {self.order}")


@dataclass(frozen=True)
class MaintenancePlan:
    """Executable maintenance plan for one compiled program.

    ``fingerprint`` ties the plan to the (program, dims) it was priced
    for — the engine refuses to execute a plan for a different program,
    and the compiled-trigger cache keys on it so identical plans share
    jitted triggers across engine instances.
    """

    fingerprint: str
    workload: WorkloadDescriptor
    views: Dict[str, ViewPlan]
    mesh_key: Optional[Tuple] = None

    # -- per-firing decision -------------------------------------------------
    def decide(self, stacked_rank: int, accum_rank: Dict[str, int]
               ) -> Tuple[FrozenSet[str], FrozenSet[str]]:
        """Partition views for a firing at ``stacked_rank``.

        Returns ``(reeval_due, lazy_skip)``: views to re-evaluate inside
        the firing, and unmaterialized views to skip (marked stale,
        recomputed on read).  ``accum_rank`` is the engine's per-view
        applied rank since the view's last re-evaluation — the hybrid
        staleness counter: a hybrid view re-evaluates when either this
        firing's rank or the accumulated rank crosses its threshold.
        """
        reeval, lazy = set(), set()
        for name, vp in self.views.items():
            if vp.order >= 2:
                # deferred views are the engine's business: neither swept,
                # re-evaluated, nor lazy-skipped per firing — their window
                # folds on the engine's cascade schedule
                continue
            if not vp.materialize:
                lazy.add(name)
                continue
            if vp.strategy == "reeval":
                reeval.add(name)
            elif vp.strategy == "hybrid":
                thr = max(1, int(vp.threshold_rank or 1))
                # accumulated rank is reset to 0 whenever the view is
                # re-evaluated, so this single check covers both "this
                # firing is too big" and "staleness built up"
                if accum_rank.get(name, 0) + stacked_rank >= thr:
                    reeval.add(name)
        return frozenset(reeval), frozenset(lazy)

    def strategy(self, view: str) -> str:
        return self.views[view].strategy

    def lazy_views(self) -> FrozenSet[str]:
        return frozenset(n for n, vp in self.views.items()
                         if not vp.materialize)

    # -- serialization -------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "fingerprint": self.fingerprint,
            "workload": asdict(self.workload),
            "views": {n: asdict(vp) for n, vp in sorted(self.views.items())},
            "mesh_key": list(self.mesh_key) if self.mesh_key else None,
        }, indent=1, default=list)

    @staticmethod
    def from_json(s: str) -> "MaintenancePlan":
        d = json.loads(s)
        wl = d["workload"]
        for k in ("mesh_shape", "mesh_axes"):
            if wl.get(k) is not None:
                wl[k] = tuple(wl[k])

        def untuple(x):  # JSON lists back to the nested-tuple mesh key
            return tuple(untuple(i) for i in x) if isinstance(x, list) else x

        return MaintenancePlan(
            fingerprint=d["fingerprint"],
            workload=WorkloadDescriptor(**wl),
            views={n: ViewPlan(**vp) for n, vp in d["views"].items()},
            mesh_key=untuple(d["mesh_key"]) if d.get("mesh_key") else None)


# ---------------------------------------------------------------------------
# fingerprinting
# ---------------------------------------------------------------------------


def program_fingerprint(program: Program,
                        binding: Optional[Dict[str, int]] = None) -> str:
    """Stable identity of (program structure, concrete dims).

    Two engines compiled from structurally identical programs at the
    same sizes produce the same fingerprint — that is what lets a plan
    (and its cached compiled triggers) survive across
    ``IncrementalEngine`` instances.
    """
    binding = dict(program.dims if binding is None else binding)
    payload = repr(program) + "|" + repr(sorted(binding.items()))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def _trigger_read_views(compiled: CompiledProgram) -> FrozenSet[str]:
    """Views some trigger's factor blocks *read* (old values).

    The delta chain assumes every referenced view is current at firing
    time, so these can never be maintained lazily."""
    read: set = set()
    for trig in compiled.triggers.values():
        _, ro = trigger_touched_views(trig)
        read |= set(ro)
        for a in trig.assigns:
            read |= set(a.expr.free_vars())
    return frozenset(read)


def _rowlocal_closed_views(compiled: CompiledProgram) -> FrozenSet[str]:
    """Views whose delta is row-support-preserving under EVERY trigger
    that maintains them in factored form (``Trigger.carriers`` —
    compile-time §4 closure).  A view that is row-local under updates
    to one input but widens under another cannot be priced at the
    row-slab cost: the plan is per-view, not per-(view, input)."""
    status: Dict[str, bool] = {}
    for trig in compiled.triggers.values():
        for up in trig.updates:
            if up.kind != "lowrank":
                continue
            ok = trig.carriers.get(up.view) == "row_local"
            status[up.view] = status.get(up.view, True) and ok
    return frozenset(n for n, ok in status.items() if ok)


def plan_program(compiled, workload: WorkloadDescriptor, *,
                 binding: Optional[Dict[str, int]] = None,
                 mesh=None, mesh_axis: Optional[str] = None
                 ) -> MaintenancePlan:
    """Price every maintained view under ``workload`` and emit a plan.

    Strategy per view (the §7 crossover ``K* = reeval/(2·n·m)``,
    divided by the workload's calibrated ``cost_scale`` to get the
    effective wall-clock crossover ``K*_eff``):

      * ``rank_hi < K*_eff``  → ``incremental`` — the factored sweep
        always wins at the ranks this workload produces;
      * ``rank_lo ≥ K*_eff``  → ``reeval`` — the avalanche always loses;
      * otherwise             → ``hybrid``, ``threshold_rank = K*_eff``.

    Materialization (intermediates only): a view that no trigger reads
    and no output needs is kept eagerly maintained iff its per-firing
    apply cost beats ``reads_per_firing ×`` its recompute cost —
    otherwise it goes lazy (skipped during firings, recomputed on
    read).

    Depth (``workload.max_order >= 2`` only): each view is additionally
    priced at depths 2..max_order.  At depth ``o`` the engine folds a
    window of ``w = fold_window**(o-1)`` firings into one stacked sweep
    (capped at ``max_fold_rank`` by re-compression) — but a read forces
    the fold early, so the *effective* window is
    ``min(w, 1/reads_per_firing)``.  The smallest depth whose amortized
    per-firing fold cost beats the best depth-1 cost by >= 2x is
    assigned (inputs and trigger-read views stay first-order, and
    producer depths are clamped to their consumers' so no trigger ever
    reads a stale deferred view).  Any plan with a depth >= 2 view
    materializes every view — fold bases and lazy recomputation do not
    mix.
    """
    if isinstance(compiled, Program):
        compiled = compile_program(compiled)
    program = compiled.program
    binding = dict(program.dims if binding is None else binding)
    lo, hi = workload.rank_bounds()
    outputs = set(program.output_names())
    never_lazy = _trigger_read_views(compiled) | outputs | set(program.inputs)
    rl_closed = _rowlocal_closed_views(compiled)
    frac = workload.affected_fraction

    views: Dict[str, ViewPlan] = {}
    shapes: Dict[str, Tuple[int, int]] = {}
    reeval_effs: Dict[str, float] = {}
    for st in program.statements:
        name = st.target.name
        shape = shape_of(st.target, binding)
        reeval = expr_cost(st.expr, binding).flops
        # per-op-kind scaling: crossover priced in matmul-equivalent
        # FLOPs, so inverse-heavy views (OLS) land on the right side
        reeval_eff = workload.effective_reeval_flops(
            expr_cost_kinds(st.expr, binding))
        kstar = batch_crossover_rank(shape, reeval_eff)
        # cardinality-based selection: a row-local-closed view under a
        # contained workload sweeps only frac·n rows, so its effective
        # crossover (both against cost_scale AND the hybrid threshold)
        # scales by 1/frac — incremental keeps winning at ranks where
        # the dense sweep would already re-evaluate
        row_local = (frac is not None and name in rl_closed
                     and 0.0 < frac
                     and frac <= rowlocal_crossover_fraction(
                         shape, workload.expected_rank()))
        kstar_rl = kstar if not row_local else \
            max(kstar, int(kstar / max(frac, 1e-9)))
        k_eff = max(1, int(kstar_rl / max(workload.cost_scale, 1e-12)))
        if hi < k_eff:
            strat, thr = "incremental", None
        elif lo >= k_eff:
            strat, thr = "reeval", None
        else:
            strat, thr = "hybrid", k_eff
        materialize = True
        if name not in never_lazy:
            n, m = shape
            k = workload.expected_rank()
            sweep_rows = n * frac if row_local else n
            maintain = 2.0 * k * sweep_rows * m        # per-firing sweep
            on_demand = workload.reads_per_firing * reeval_eff
            materialize = maintain <= on_demand
        # every statement view is depth-eligible; _resolve_depths then
        # clamps producers to their consumers' depth so per-firing delta
        # chains never read a stale deferred view
        order = _price_depth(workload, shape, reeval_eff)
        shapes[name], reeval_effs[name] = shape, reeval_eff
        views[name] = ViewPlan(view=name, strategy=strat,
                               threshold_rank=thr, materialize=materialize,
                               crossover_rank=kstar, reeval_flops=reeval,
                               order=order, row_local=row_local)
    if workload.chain_aware:
        _reprice_with_chain(compiled, binding, workload, lo, hi,
                            views, shapes, reeval_effs)
    _resolve_depths(program, views)

    from .trigger_cache import mesh_cache_key
    wl = workload
    if mesh is not None and wl.mesh_shape is None:
        wl = replace(wl, mesh_shape=tuple(int(s) for s in mesh.shape),
                     mesh_axes=tuple(mesh.mesh_dim_names))
    return MaintenancePlan(
        fingerprint=program_fingerprint(program, binding),
        workload=wl, views=views,
        mesh_key=mesh_cache_key(mesh, mesh_axis))


def _price_depth(workload: WorkloadDescriptor, shape: Tuple[int, int],
                 reeval_eff: float) -> int:
    """Smallest depth whose amortized fold cost beats the best depth-1
    per-firing cost by >= 2x (1 when none does, or max_order is 1).

    Depth-1 per-firing cost: min(sweep, re-evaluate).  Depth-o: one fold
    every ``w_eff`` firings — a stacked sweep at the window rank (capped
    by re-compression) or a re-evaluation, whichever wins — where
    ``w_eff = min(fold_window**(o-1), 1/reads_per_firing)`` because a
    read forces the fold early.  With reads on every firing (the default
    descriptor) w_eff is 1 and no depth is ever assigned: depth buys
    nothing without read sparsity, exactly the memory-vs-work trade-off
    docs/higher_order.md plots.
    """
    if workload.max_order < 2:
        return 1
    n, m = shape
    k = workload.expected_rank()
    scale = max(workload.cost_scale, 1e-12)
    rho = max(float(workload.reads_per_firing), 0.0)
    best_order = 1
    best = min(scale * 2.0 * k * n * m, reeval_eff)
    for o in range(2, int(workload.max_order) + 1):
        w = float(max(1, workload.fold_window) ** (o - 1))
        w_eff = max(1.0, min(w, (1.0 / rho) if rho > 0 else w))
        kw = float(k) * w_eff
        if workload.max_fold_rank:
            kw = min(kw, float(workload.max_fold_rank))
        fold_cost = min(scale * 2.0 * kw * n * m, reeval_eff)
        amortized = fold_cost / w_eff
        if amortized * 2.0 <= best:
            best_order, best = o, amortized
    return best_order


def _resolve_depths(program: Program, views: Dict[str, ViewPlan]) -> None:
    """Clamp each view's depth to its consumers' (reverse program order)
    and, if any depth >= 2 survives, force every view materialized —
    the engine's deferred cascade refuses lazy/deferred mixing."""
    names = {st.target.name for st in program.statements}
    consumers: Dict[str, List[str]] = {}
    for st in program.statements:
        for v in st.expr.free_vars():
            if v in names and v != st.target.name:
                consumers.setdefault(v, []).append(st.target.name)
    eff: Dict[str, int] = {}
    for st in reversed(program.statements):
        name = st.target.name
        o = views[name].order
        for c in consumers.get(name, ()):
            o = min(o, eff[c])
        eff[name] = o
    deferred = any(o >= 2 for o in eff.values())
    for name, vp in views.items():
        o = eff.get(name, 1)
        if o != vp.order or (deferred and not vp.materialize):
            views[name] = replace(vp, order=o,
                                  materialize=vp.materialize or deferred)


def trigger_chain_costs(trig, binding: Dict[str, int]
                        ) -> Tuple[Dict[str, float], Dict[str, FrozenSet[str]]]:
    """Price one trigger's shared delta chain.

    Returns ``(assign_flops, view_deps)``: FLOPs of each trigger assign
    at the trigger's compiled rank, and — per updated view — the
    transitive set of assign names its factor blocks read.  The chain is
    computed once per firing and shared by every view still maintained
    incrementally; these two maps are what lets a planner decide who
    pays for it when some views re-evaluate instead.
    """
    assign_flops: Dict[str, float] = {}
    assign_deps: Dict[str, FrozenSet[str]] = {}
    for a in trig.assigns:
        direct = set(a.expr.free_vars()) & set(assign_flops)
        closure = set(direct)
        for d in direct:
            closure |= assign_deps[d]
        assign_flops[a.name] = expr_cost(a.expr, binding).flops
        assign_deps[a.name] = frozenset(closure)
    view_deps: Dict[str, FrozenSet[str]] = {}
    for up in trig.updates:
        roots = {n for n in (up.u, up.v, up.d)
                 if n is not None and n in assign_flops}
        closure = set(roots)
        for r in roots:
            closure |= assign_deps[r]
        view_deps[up.view] = frozenset(closure)
    return assign_flops, view_deps


def _reprice_with_chain(compiled: CompiledProgram, binding, workload,
                        lo: int, hi: int, views: Dict[str, ViewPlan],
                        shapes, reeval_effs) -> None:
    """Chain-aware second pass over a freshly priced plan (in place).

    Per trigger, the delta-chain assigns a view's sweep reads are split
    evenly among the views that still read them incrementally; a view's
    per-rank sweep cost becomes ``2·n·m + chain_share`` and its
    crossover drops accordingly.  Demoting a view to re-evaluation
    shifts its chain share onto the surviving readers — so the pass
    iterates to a fixed point (≤ one demotion per round, bounded by the
    view count).  This is exactly the "lone incremental view keeps the
    shared chain alive" correction: with every sibling re-evaluated,
    the last reader bears the whole chain.
    """
    chains = [(trigger_chain_costs(trig, binding), max(trig.rank, 1))
              for trig in compiled.triggers.values()]
    for _ in range(len(views) + 1):
        # per-rank chain share each still-incremental view would bear
        share: Dict[str, float] = {}
        for (assign_flops, view_deps), rank in chains:
            live = [w for w, deps in view_deps.items()
                    if deps and w in views and views[w].strategy != "reeval"]
            users = {a: sum(1 for w in live if a in view_deps[w])
                     for a in assign_flops}
            for w in live:
                s = sum(assign_flops[a] / max(users[a], 1)
                        for a in view_deps[w]) / rank
                share[w] = max(share.get(w, 0.0), s)
        changed = False
        for name, s in share.items():
            vp = views[name]
            n, m = shapes[name]
            kstar = max(1, int(reeval_effs[name] / (2.0 * n * m + s)))
            k_eff = max(1, int(kstar / max(workload.cost_scale, 1e-12)))
            if hi < k_eff:
                strat, thr = "incremental", None
            elif lo >= k_eff:
                strat, thr = "reeval", None
            else:
                strat, thr = "hybrid", k_eff
            if (strat, thr, kstar) != (vp.strategy, vp.threshold_rank,
                                       vp.crossover_rank):
                changed = strat != vp.strategy or changed
                views[name] = replace(vp, strategy=strat,
                                      threshold_rank=thr,
                                      crossover_rank=kstar)
        if not changed:
            return


def firing_cost_flops(compiled: CompiledProgram, binding: Dict[str, int],
                      input_name: str, stacked_rank: int, *,
                      reeval_views: FrozenSet[str] = frozenset(),
                      workload: Optional[WorkloadDescriptor] = None,
                      view_orders: Optional[Dict[str, int]] = None,
                      affected_fraction: Optional[float] = None
                      ) -> float:
    """Planner-estimated FLOPs of one trigger firing at ``stacked_rank``.

    Prices the shared delta chain ONCE (only the assigns some
    incremental view still reads, scaled linearly to the stacked rank),
    one ``2·K·n·m`` factored sweep per incrementally maintained view,
    and a full re-evaluation per view in ``reeval_views``.  The sweep
    side is scaled by the workload's calibrated ``cost_scale`` so the
    number is in re-evaluation-FLOP equivalents — this is the cost term
    the fleet scheduler multiplies into its SLO priority, and the place
    the chain a lone incremental view keeps alive must not be
    underestimated (ROADMAP carried follow-up).

    ``view_orders`` (an engine's resolved per-view delta depths) prices
    a deferred order-``o`` view at its amortized fold share — one
    stacked, rank-capped sweep per ``fold_window**(o-1)`` firings,
    never worse than re-evaluation — instead of a full per-firing
    sweep, and keeps none of the delta chain alive per firing.
    Chain-aware fleet pricing would otherwise overcharge higher-order
    tenants by exactly the factor their depth buys back.

    ``affected_fraction`` (a row-local firing's ``r/n``, or the
    workload's expectation) scales the sweep of every view the compiler
    proved row-local under this trigger — the fleet's lease pricing
    must see the contained cost, or sparse tenants get overcharged by
    ``1/fraction`` and starve dense tenants of their fair share.
    """
    trig = compiled.triggers[input_name]
    assign_flops, view_deps = trigger_chain_costs(trig, binding)
    scale = workload.cost_scale if workload is not None else 1.0
    if affected_fraction is None and workload is not None:
        affected_fraction = workload.affected_fraction
    fold_window = workload.fold_window if workload is not None else 8
    max_fold_rank = workload.max_fold_rank if workload is not None else 64
    k = max(1, int(stacked_rank))
    by_name = {s.target.name: s for s in compiled.program.statements}
    total = 0.0
    live_assigns: set = set()
    for up in trig.updates:
        st = by_name.get(up.view)
        order = (view_orders or {}).get(up.view, 1)
        if order >= 2 and st is not None:
            w = float(max(1, fold_window) ** (order - 1))
            kw = k * w
            if max_fold_rank:
                kw = min(kw, float(max_fold_rank))
            n, m = shape_of(st.target, binding)
            kinds = expr_cost_kinds(st.expr, binding)
            re_eff = (workload.effective_reeval_flops(kinds)
                      if workload is not None else sum(kinds.values()))
            total += min(scale * 2.0 * kw * n * m, re_eff) / w
            continue
        if up.view in reeval_views and st is not None:
            kinds = expr_cost_kinds(st.expr, binding)
            total += (workload.effective_reeval_flops(kinds)
                      if workload is not None else sum(kinds.values()))
            continue
        target = st.target if st is not None \
            else compiled.program.inputs[up.view]
        n, m = shape_of(target, binding)
        rows = n
        if (affected_fraction is not None
                and trig.carriers.get(up.view) == "row_local"):
            rows = max(1.0, affected_fraction * n)
        total += scale * 2.0 * k * rows * m
        live_assigns |= view_deps[up.view]
    total += scale * sum(assign_flops[a] for a in live_assigns) \
        * (k / max(trig.rank, 1))
    return total


def plan_for_engine(engine, workload: WorkloadDescriptor) -> MaintenancePlan:
    """Plan against an engine's compiled program, binding and mesh."""
    return plan_program(engine.compiled, workload, binding=engine.binding,
                        mesh=engine.mesh, mesh_axis=engine.mesh_axis)


def static_plan(engine, strategy: str,
                workload: Optional[WorkloadDescriptor] = None
                ) -> MaintenancePlan:
    """The degenerate plan that forces one ``strategy`` on every view.

    The static baselines the adaptive planner is judged against
    (benchmarks, A/B tests): ``"incremental"`` reproduces the
    pre-planner engine behavior, ``"reeval"`` the paper's batched
    REEVAL baseline.  Every view stays materialized.
    """
    base = plan_for_engine(engine, workload or WorkloadDescriptor())
    views = {name: replace(vp, strategy=strategy, threshold_rank=None,
                           materialize=True, order=1)
             for name, vp in base.views.items()}
    return MaintenancePlan(fingerprint=base.fingerprint,
                           workload=base.workload, views=views,
                           mesh_key=base.mesh_key)


def solver_resolve_strategy(n: int, pending_rank: int, *,
                            cost_scale: float = 1.0) -> str:
    """Price a normal-equation re-solve against the maintained ring
    (fivm): ``"update"`` applies ``pending_rank`` Cholesky
    rank-one update/downdates to the cached factor of ``G + λI``
    (``2kn²`` flops), ``"refactor"`` refactors from the maintained
    gram (``n³/3``) — the §7 incremental-vs-reeval crossover
    transplanted to the solver layer, crossing at ``k ≈ n/6``
    (:func:`repro_torch.core.cost.solver_crossover_rank`).

    ``cost_scale`` biases the update side (>1 penalizes the Python-loop
    rank-one kernel against the BLAS refactor; calibrated by the fivm
    bench).  The back-substitution ``2n²p`` is common to both arms and
    drops out of the comparison.
    """
    if pending_rank <= 0:
        return "update"          # nothing pending: keep the factor
    upd = cholesky_update_cost(n, pending_rank).flops * cost_scale
    ref = cholesky_factor_cost(n).flops
    return "update" if upd < ref else "refactor"
