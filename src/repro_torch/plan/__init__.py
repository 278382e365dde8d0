"""repro_torch.plan — cost-based adaptive execution planning for IVM
programs on the port's engine.

Public API:

    from repro_torch.plan import (
        WorkloadDescriptor, ViewPlan, MaintenancePlan,
        plan_program, plan_for_engine, program_fingerprint,
        AdaptivePlanner, TriggerCache, global_trigger_cache,
    )

A :class:`MaintenancePlan` tells the engine, per maintained view,
whether to propagate factored deltas, re-evaluate, or switch between
the two at a rank threshold — plus which intermediates to keep eagerly
materialized.  :class:`AdaptivePlanner` refits the plan online from
observed firings; :class:`TriggerCache` makes built triggers survive
across engine instances.  Plans are the same JSON in this package and
the JAX package.  See docs/planner.md.
"""

from .planner import (MaintenancePlan, ViewPlan, WorkloadDescriptor,
                      firing_cost_flops, plan_for_engine, plan_program,
                      program_fingerprint, solver_resolve_strategy,
                      static_plan, trigger_chain_costs)
from .trigger_cache import TriggerCache, global_trigger_cache, mesh_cache_key
from .adaptive import AdaptivePlanner
from .calibrate import calibrate_cost_scale, calibrate_op_cost_scales

__all__ = [
    "MaintenancePlan", "ViewPlan", "WorkloadDescriptor",
    "plan_for_engine", "plan_program", "program_fingerprint",
    "static_plan", "firing_cost_flops", "trigger_chain_costs",
    "solver_resolve_strategy",
    "calibrate_cost_scale", "calibrate_op_cost_scales",
    "TriggerCache", "global_trigger_cache", "mesh_cache_key",
    "AdaptivePlanner",
]
