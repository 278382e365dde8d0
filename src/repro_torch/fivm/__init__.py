"""repro_torch.fivm — learning over evolving data: models maintained as
incremental views (LINVIEW §5 + the F-IVM line, arXiv 1703.07484 /
2006.00694).

The subsystem composes substrates that already exist in this repo into
a learning-serving layer:

  * :mod:`repro_torch.fivm.ring` — the maintained covariance/gram "ring"
    ``(c, s, G) = (count, Σxᵢ, XᵀX)`` plus ``XᵀY``, registered as views
    in the LINVIEW compiler and updated under factored insert *and*
    delete (negative-weight downdate) carriers;
  * :mod:`repro_torch.fivm.solvers` — ridge/OLS whose normal-equation solve
    consumes the ring (Cholesky update/downdate or planner-priced
    refactor past the §7 crossover) and k-means reading the same ring
    views, each pushing its coefficients back as a maintained gradient
    view via ``train/grad_compression`` factors;
  * :mod:`repro_torch.fivm.registry` — the pinned-view registry: one ring,
    many models, shared across interactive analyses and fleet tenants.

See docs/fivm.md for the serve contract (decoupled refresh).  The ring's
views live on the engine's device; the solvers run on the host.
"""

from .ring import (Ring, RingSpec, build_ring_program, event_carriers,
                   initial_ring_inputs)
from .solvers import (DowndateError, KMeansSolver, OLSSolver, RidgeSolver,
                      batch_kmeans, batch_ridge, chol_rank1_update,
                      solve_cholesky)
from .registry import RingRegistry

__all__ = [
    "Ring", "RingSpec", "build_ring_program", "event_carriers",
    "initial_ring_inputs",
    "RidgeSolver", "OLSSolver", "KMeansSolver", "batch_ridge",
    "batch_kmeans", "chol_rank1_update", "solve_cholesky",
    "DowndateError", "RingRegistry",
]
