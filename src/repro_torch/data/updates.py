"""Update-stream generators for the IVM workloads (paper §7).

The paper's experiments drive a continuous stream of rank-1 row updates;
Table 4 additionally skews *which* rows change using a Zipf distribution.
:class:`RowLocalStream` emits the same kind of workload as row-local
delta carriers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional, Tuple

import numpy as np

from ..core.factored import RowLocalCarrier, stack_carriers


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


@dataclass
class RowLocalStream:
    """Stream of :class:`~repro_torch.core.factored.RowLocalCarrier`
    updates: each draw touches ``rows_touched`` distinct rows of an
    (n × m) input with a rank-``rank`` delta, carried in compact
    ``(rows, block, V)`` form.

    Same generator discipline as :class:`UpdateStream`: one lazily
    seeded state, every draw advances it, :meth:`reset` rewinds, and two
    streams with the same parameters are draw-for-draw identical.

    ``zipf`` skews which rows are touched (Table 4); skewed draws are
    deduplicated, so a draw may carry *fewer* than ``rows_touched`` rows.
    """

    n: int
    m: int
    rows_touched: int = 1
    rank: int = 1
    scale: float = 0.1
    seed: int = 0
    zipf: Optional[float] = None
    _rng: Optional[np.random.Generator] = field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if not (1 <= self.rows_touched <= self.n):
            raise ValueError(f"rows_touched must be in [1, {self.n}], "
                             f"got {self.rows_touched}")

    @property
    def rng(self) -> np.random.Generator:
        if self._rng is None:
            self._rng = np.random.default_rng(self.seed)
        return self._rng

    def reset(self) -> None:
        self._rng = None

    def __iter__(self):
        while True:
            yield self.next_carrier()

    def _draw_rows(self, rng) -> np.ndarray:
        if self.zipf is None or self.zipf <= 0:
            rows = rng.choice(self.n, size=self.rows_touched,
                              replace=False)
        else:
            r = rng.zipf(max(self.zipf, 1.01), size=self.rows_touched)
            rows = np.minimum(r - 1, self.n - 1)
        return np.unique(rows).astype(np.int32)  # sorted + deduped

    def next_carrier(self, rng=None) -> RowLocalCarrier:
        rng = self.rng if rng is None else rng
        rows = self._draw_rows(rng)
        block = (self.scale * rng.normal(size=(len(rows), self.rank))
                 ).astype(np.float32)
        v = (self.scale * rng.normal(size=(self.m, self.rank))
             ).astype(np.float32)
        return RowLocalCarrier(rows, block, v, self.n)

    def batch(self, count: int):
        """``count`` carriers stacked into one (union-support) carrier."""
        return stack_carriers([self.next_carrier() for _ in range(count)])


def row_local_stream(n: int, rows_touched: int, *, m: Optional[int] = None,
                     rank: int = 1, scale: float = 0.1, seed: int = 0,
                     zipf: Optional[float] = None) -> RowLocalStream:
    """A row-local carrier stream (``m`` defaults to ``n``)."""
    return RowLocalStream(n=n, m=n if m is None else m,
                          rows_touched=rows_touched, rank=rank,
                          scale=scale, seed=seed, zipf=zipf)


def zipf_row_stream(n: int, m: int, zipf_factor: float, seed: int = 0,
                    rows_touched: Optional[int] = None):
    """Table 4's skewed-row workload: with ``rows_touched`` set, a stream
    of :class:`RowLocalCarrier` updates; without it, padded ``(u, v)``
    pairs from an :class:`UpdateStream`."""
    if rows_touched is not None:
        return row_local_stream(n, rows_touched, m=m, seed=seed,
                                zipf=zipf_factor)
    return UpdateStream(n=n, m=m, zipf=zipf_factor, seed=seed)
