"""Learning over evolving data (repro_torch.fivm; LINVIEW §5 + F-IVM).

The app bundles one maintained ring, a labeled insert/delete stream,
and the solvers living on it — ridge (λ at read), OLS, k-means — into
the uniform app scaffolding, so benchmarks and the serving CLI treat
"models as incremental views" like any other paper workload.

The serve shape (``launch/serve.py --fivm``) runs the ring at
``order=2``: every arriving example banks as a factored delta (O(rank)
bookkeeping — the deferred-input fast path), and the normal-equation
re-solve happens when a *read* folds the window — model-refresh latency
is decoupled from data arrival.  See docs/fivm.md.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from ..core import ReevalEngine
from ..data import labeled_stream
from ..fivm import KMeansSolver, RidgeSolver, Ring, RingSpec
from .common import App, register_app


@register_app("fivm_learning")
class FivmLearning(App):
    """One ring, a labeled stream, and its resident models.

    ``order=2`` puts the ring in decoupled (bank-on-ingest,
    fold-on-read) mode; the default first-order ring refreshes views on
    every firing like the other apps.  The ring's views live on
    ``device`` (``None`` means the card); the solvers run on the host.
    """

    def __init__(self, features: int = 16, targets: int = 1,
                 capacity: int = 128, model_slots: int = 2,
                 churn: float = 0.3, lam: float = 0.1, clusters: int = 4,
                 seed: int = 0, order: Optional[int] = None,
                 proj_dim: int = 0, device=None, with_reeval: bool = False,
                 **ring_kw):
        self.spec = RingSpec(features=features, targets=targets,
                             capacity=capacity, model_slots=model_slots,
                             proj_dim=proj_dim)
        self.ring = Ring(self.spec, seed=seed, order=order, device=device,
                         **ring_kw)
        # App scaffolding fields (the surface every app exposes)
        self.program = self.ring.program
        self.update_input = "X"
        self.rank = 1
        self.engine = self.ring.engine
        self.device = self.engine.device
        self.reeval = None
        if with_reeval:
            self.reeval = ReevalEngine(self.program, device=self.device)
            self.reeval.initialize(self.ring.initial_inputs())
        self.stream = labeled_stream(features, targets=targets,
                                     capacity=capacity, churn=churn,
                                     seed=seed)
        self.model = RidgeSolver(self.ring, lam=lam)
        self.kmeans = KMeansSolver(self.ring, clusters, seed=seed)

    # -- data path ---------------------------------------------------------

    def ingest(self, count: int) -> int:
        """Pull ``count`` events off the stream into the ring."""
        return self.ring.apply_events(self.stream.events(count))

    def refresh(self) -> np.ndarray:
        """Re-solve the resident ridge model against everything the
        ring absorbed (folds any banked windows first)."""
        return self.model.coefficients()

    # -- serve demo --------------------------------------------------------

    def serve_demo(self, *, bursts: int = 8, burst_size: int = 32,
                   reads: int = 4) -> Dict[str, object]:
        """Decoupled-refresh serving: ``bursts`` ingest bursts with
        interleaved model reads; returns the timing/staleness ledger
        the serving CLI prints.  Ingest time is pure banking on an
        ``order>=2`` ring; each read pays its own fold + re-solve."""
        ingest_s, read_s = [], []
        events = 0
        for b in range(bursts):
            t0 = time.perf_counter()
            events += self.ingest(burst_size)
            ingest_s.append(time.perf_counter() - t0)
            if (b + 1) % max(1, bursts // max(1, reads)) == 0:
                t0 = time.perf_counter()
                self.refresh()
                read_s.append(time.perf_counter() - t0)
        stats = self.ring.stats
        return {
            "events": events,
            "live": float(self.ring.count()),
            "ingest_us_per_event": 1e6 * sum(ingest_s) / max(events, 1),
            "read_ms": [1e3 * t for t in read_s],
            "folds": stats.folds,
            "refreshes": self.model.stats.refreshes,
            "strategies": list(self.model.stats.strategy_log),
        }
