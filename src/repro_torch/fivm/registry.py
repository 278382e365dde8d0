"""Pinned-view registry: one ring, many models.

Interactive analyses over the same evolving dataset should not each
maintain a private gram matrix — the ring's views are model-agnostic
(λ enters at read, coefficients live in per-model slots), so every
regression and clustering job over the same :class:`RingSpec` can share
ONE maintained ring.  :class:`RingRegistry` keys live rings by their
spec, pins them while any analysis holds them (pin-counted acquire /
release — an unpinned ring is dropped, a pinned one survives every
release but the last), hands out model slots to named solvers, and
passes one shared :class:`repro_torch.plan.TriggerCache` to every engine
it builds so same-shape rings never rebuild their triggers.

The fleet face of the same idea: :meth:`RingRegistry.tenant_spec`
wraps a ring program as a :class:`repro_torch.fleet.TenantSpec`, so a
multi-tenant deployment hosts per-dataset rings under the scheduler's
lease/SLO machinery, and :func:`submit_event` feeds labeled
insert/delete events through the fleet's admission path using exactly
the carriers :meth:`Ring.apply` fires locally (bit-identical replay).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..data.updates import LabeledUpdate
from .ring import (Ring, RingSpec, build_ring_program, event_carriers,
                   initial_ring_inputs)


@dataclass
class _Entry:
    ring: Ring
    pins: int = 0
    models: Dict[str, object] = field(default_factory=dict)


class RingRegistry:
    """Process-local registry of live, pinned rings (see module doc)."""

    def __init__(self, trigger_cache=None):
        if trigger_cache is None:
            from ..plan import global_trigger_cache
            trigger_cache = global_trigger_cache()
        self.trigger_cache = trigger_cache
        self._entries: Dict[RingSpec, _Entry] = {}
        self.evictions = 0

    # -- pinning -----------------------------------------------------------

    def acquire(self, spec: RingSpec, **ring_opts) -> Ring:
        """The shared ring for ``spec`` (built on first acquire; pinned
        +1).  ``ring_opts`` (order, guard, device, …) apply only to the
        build — a second acquirer shares the first ring as-is."""
        e = self._entries.get(spec)
        if e is None:
            ring = Ring(spec, trigger_cache=self.trigger_cache,
                        **ring_opts)
            e = self._entries[spec] = _Entry(ring=ring)
        e.pins += 1
        return e.ring

    def release(self, spec: RingSpec) -> int:
        """Unpin; at zero pins the ring (and its models) is dropped.
        Returns the remaining pin count."""
        e = self._entries.get(spec)
        if e is None:
            raise KeyError(f"no ring for {spec}")
        e.pins -= 1
        if e.pins <= 0:
            del self._entries[spec]
            self.evictions += 1
            return 0
        return e.pins

    def get(self, spec: RingSpec) -> Ring:
        """The live ring for ``spec`` without pinning (raises if not
        held by anyone)."""
        return self._entries[spec].ring

    def pinned(self) -> List[RingSpec]:
        return sorted(self._entries, key=repr)

    # -- models ------------------------------------------------------------

    def model(self, spec: RingSpec, name: str, kind: str = "ridge",
              **solver_opts):
        """A named solver over the shared ring (create on first call,
        shared thereafter): ``kind`` ∈ {"ridge", "ols", "kmeans"}.
        Regression models each claim their own coefficient slot —
        one ring, many models."""
        e = self._entries[spec]
        if name in e.models:
            return e.models[name]
        from .solvers import KMeansSolver, OLSSolver, RidgeSolver
        if kind == "ridge":
            solver = RidgeSolver(e.ring, **solver_opts)
        elif kind == "ols":
            solver = OLSSolver(e.ring, **solver_opts)
        elif kind == "kmeans":
            solver = KMeansSolver(e.ring, **solver_opts)
        else:
            raise ValueError(f"unknown model kind {kind!r}")
        e.models[name] = solver
        return solver

    def models(self, spec: RingSpec) -> Dict[str, object]:
        return dict(self._entries[spec].models)

    def stats(self) -> Dict[str, object]:
        return {
            "rings": len(self._entries),
            "pins": {repr(s): e.pins for s, e in self._entries.items()},
            "models": {repr(s): sorted(e.models)
                       for s, e in self._entries.items()},
            "evictions": self.evictions,
            "trigger_cache": self.trigger_cache.stats(),
        }

    # -- fleet face --------------------------------------------------------

    def tenant_spec(self, spec: RingSpec, tenant_id: str, *,
                    slo_s: float = 1.0, guarded: bool = True,
                    **tenant_kw):
        """A :class:`repro_torch.fleet.TenantSpec` hosting this ring shape:
        the ring program and its per-input update ranks — fleet ring
        tenants live under lease-claimed refresh and SLO staleness
        accounting like any other tenant, and same-shape ring tenants
        share built triggers through the fleet's own cache.  The tenant's
        engine is on the card unless ``engine_opts={"device": "cpu"}``."""
        from ..fleet import TenantSpec
        ranks: Dict[str, int] = {"X": 1, "Y": 1, "W": 1}
        for j in range(spec.model_slots):
            ranks[f"B{j}"] = spec.targets
        return TenantSpec(tenant_id, build_ring_program(spec),
                          update_ranks=ranks, slo_s=slo_s,
                          guarded=guarded, **tenant_kw)

    def add_fleet_tenant(self, scheduler, spec: RingSpec, tenant_id: str,
                         **tenant_kw):
        """Register a ring tenant on a running fleet scheduler, its
        inputs initialized to the empty ring."""
        inputs = initial_ring_inputs(spec, tenant_kw.pop("seed", 0))
        return scheduler.add_tenant(
            self.tenant_spec(spec, tenant_id, **tenant_kw), inputs)


def submit_event(scheduler, tenant_id: str, capacity: int,
                 ev: LabeledUpdate) -> List[str]:
    """Feed one labeled insert/delete through the fleet admission path
    as the same three row carriers :meth:`Ring.apply` fires locally.
    Returns the three admission decisions (X, Y, W)."""
    return [scheduler.submit(tenant_id, name, carrier)
            for name, carrier in event_carriers(ev, capacity)]
