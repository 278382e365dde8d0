"""Update-stream generators for the IVM workloads (paper §7).

The paper's experiments drive a continuous stream of rank-1 row updates;
Table 4 additionally skews *which* rows change using a Zipf distribution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass
class UpdateStream:
    """Stream of (u, v) factored updates to an (n × m) input matrix.

    One stream owns ONE generator state, lazily seeded from ``seed``:
    every draw — iteration or :meth:`batch` — advances it, so
    consecutive ``batch()`` calls produce *different* updates (the old
    behavior re-seeded per call, silently replaying the same batch
    forever).  For a bit-identical replay (e.g. timing incremental vs
    re-evaluation on the same stream) either call :meth:`reset` or
    construct a second stream with the same seed.
    """

    n: int
    m: int
    rank: int = 1
    scale: float = 0.1
    seed: int = 0
    zipf: Optional[float] = None     # row-selection skew (None = uniform)
    _rng: Optional[np.random.Generator] = field(
        default=None, init=False, repr=False, compare=False)

    @property
    def rng(self) -> np.random.Generator:
        if self._rng is None:
            self._rng = np.random.default_rng(self.seed)
        return self._rng

    def reset(self) -> None:
        """Rewind to ``seed``; the next draw replays from the start."""
        self._rng = None

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_update(self.rng)

    def next_update(self, rng=None) -> Tuple[np.ndarray, np.ndarray]:
        rng = self.rng if rng is None else rng
        u = np.zeros((self.n, self.rank), dtype=np.float32)
        rows = self._rows(rng, self.rank)
        u[rows, np.arange(self.rank)] = 1.0
        v = (self.scale * rng.normal(size=(self.m, self.rank))
             ).astype(np.float32)
        return u, v

    def _rows(self, rng, k: int) -> np.ndarray:
        if self.zipf is None or self.zipf <= 0:
            return rng.integers(0, self.n, size=k)
        # Zipf over row indices, clipped into range (Table 4 workload)
        r = rng.zipf(max(self.zipf, 1.01), size=k)
        return np.minimum(r - 1, self.n - 1)

    def batch(self, count: int) -> Tuple[np.ndarray, np.ndarray]:
        """A batch of ``count`` rank-1 updates merged into rank-`count`
        factors (the paper's batch-update experiment).  Draws from the
        stream's shared generator, advancing it past the batch."""
        us, vs = [], []
        for _ in range(count):
            u, v = self.next_update()
            us.append(u)
            vs.append(v)
        return np.concatenate(us, axis=1), np.concatenate(vs, axis=1)
