"""repro_torch.fleet — fault-tolerant multi-tenant view service.

The port of ``repro.fleet``, on the port's engine: every firing a worker
makes runs on the tenant engine's device through its kernels, and every
tenant engine writes out of place (:mod:`.tenant`), which is what keeps
the reference's reader isolation and bit-identical rollbacks.

N tenants (each a program + :class:`~repro_torch.core.runtime.IncrementalEngine`
+ staleness SLO) share a pool of refresh workers coordinated purely by
TTL **leases with fencing tokens** — no leader, no failure detector.
A worker claims a tenant's dirty log prefix, fires it through the
guard/transaction path, and commits only if its lease is still current;
crashed or fenced claims are rolled back (bit-identically) and replayed
from the tenant's update log, so every admitted update is reflected in
the committed store **exactly once**.

Around that core: token-bucket admission with bounded per-tenant logs,
noisy-neighbor quarantine (per-tenant circuit breakers over the guard's
abort accounting), SLO-×-cost scheduling priority, explicit overload
tiers (degrade cold tenants to re-eval-on-read, shed under saturation),
and a shared cross-tenant trigger cache.  See docs/fleet.md.

    from repro_torch.fleet import FleetScheduler, FleetConfig, TenantSpec

    fleet = FleetScheduler(FleetConfig(lease_ttl=0.5))
    fleet.add_tenant(TenantSpec("acme", program, {"u": 1}, slo_s=0.2,
                                engine_opts={"device": "cuda"}), inputs)
    fleet.submit("acme", "u", du, dv)
    fleet.run_until_idle()          # or fleet.start() for live threads
    fresh = fleet.read("acme")
"""

from .admission import (ADMITTED, DECISIONS, QUEUE_FULL, SHED, THROTTLED,
                        AdmissionController, TokenBucket)
from .lease import Lease, LeaseStore
from .scheduler import (FleetConfig, FleetScheduler, OverloadPolicy,
                        WorkerCrashed)
from .tenant import (Inflight, LogEntry, Tenant, TenantRegistry, TenantSpec,
                     TenantStats, UpdateLog)

__all__ = [
    "FleetScheduler", "FleetConfig", "OverloadPolicy", "WorkerCrashed",
    "TenantSpec", "Tenant", "TenantRegistry", "TenantStats",
    "UpdateLog", "LogEntry", "Inflight",
    "LeaseStore", "Lease",
    "AdmissionController", "TokenBucket",
    "ADMITTED", "THROTTLED", "QUEUE_FULL", "SHED", "DECISIONS",
]
