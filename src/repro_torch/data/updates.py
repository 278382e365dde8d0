"""Update-stream generators for the IVM workloads (paper §7).

The paper's experiments drive a continuous stream of rank-1 row updates;
Table 4 additionally skews *which* rows change using a Zipf distribution.
:class:`RowLocalStream` emits the same kind of workload as row-local
delta carriers.  :class:`LabeledStream` drives the learning views
(:mod:`repro_torch.fivm`): labeled inserts and stored-payload deletes.
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


@dataclass(frozen=True)
class LabeledUpdate:
    """One labeled tuple event against the F-IVM ring: an *insert* adds
    example ``(x, y)`` at row ``slot`` of the (capacity × features)
    design matrix; a *delete* is the matching negative-weight downdate
    of the **exact payload inserted earlier** (arXiv 1703.07484's
    "deletion = insertion with weight −1").  Replaying the stored
    payload, not a re-draw, is what makes insert-then-delete restore
    the ring bit-near-identically."""

    kind: str                 # "insert" | "delete"
    slot: int                 # row slot in X / Y / W
    x: np.ndarray             # (features,) float32
    y: np.ndarray             # (targets,)  float32

    @property
    def weight(self) -> float:
        return 1.0 if self.kind == "insert" else -1.0


@dataclass
class LabeledStream:
    """Mixed insert/delete stream of labeled examples for the learning
    views (:mod:`repro_torch.fivm`).

    The stream owns the slot ledger: inserts claim free row slots of a
    ``capacity``-row design matrix, deletes re-emit the *stored* payload
    of a live slot with weight −1 and free it.  ``churn`` is the mix
    knob — the probability (once warm) that the next event is a delete;
    ``churn=0`` is append-only, ``churn≈0.9`` is delete-heavy.  Labels
    carry signal: ``y = xᵀ·w_true + noise`` with ``w_true`` drawn once
    from the seed, so regressions fit on the live set are non-trivial.

    Same generator discipline as :class:`UpdateStream` — one lazily
    seeded state, every draw advances it, :meth:`reset` rewinds ledger
    *and* generator, and two streams with identical parameters are
    event-for-event identical (deterministic replay)."""

    features: int
    targets: int = 1
    capacity: int = 256
    churn: float = 0.3
    scale: float = 1.0
    noise: float = 0.01
    seed: int = 0
    _rng: Optional[np.random.Generator] = field(
        default=None, init=False, repr=False, compare=False)
    _live: dict = field(default_factory=dict, init=False, repr=False,
                        compare=False)
    _free: list = field(default_factory=list, init=False, repr=False,
                        compare=False)
    _w_true: Optional[np.ndarray] = field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if not (0.0 <= self.churn < 1.0):
            raise ValueError(f"churn must be in [0, 1), got {self.churn}")
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._free = list(range(self.capacity))

    @property
    def rng(self) -> np.random.Generator:
        if self._rng is None:
            self._rng = np.random.default_rng(self.seed)
        return self._rng

    @property
    def w_true(self) -> np.ndarray:
        """The (features × targets) ground-truth weights behind the
        labels; drawn from ``seed + 1`` so it is stable across resets
        and independent of how many events were consumed."""
        if self._w_true is None:
            rng = np.random.default_rng(self.seed + 1)
            self._w_true = rng.normal(
                size=(self.features, self.targets)).astype(np.float32)
        return self._w_true

    @property
    def live_slots(self) -> Tuple[int, ...]:
        return tuple(sorted(self._live))

    @property
    def live_count(self) -> int:
        return len(self._live)

    def reset(self) -> None:
        """Rewind generator AND slot ledger; the next draw replays the
        stream from its first event."""
        self._rng = None
        self._live = {}
        self._free = list(range(self.capacity))

    def __iter__(self) -> Iterator[LabeledUpdate]:
        while True:
            yield self.next_event()

    def _draw_example(self, rng) -> Tuple[np.ndarray, np.ndarray]:
        x = (self.scale * rng.normal(size=self.features)).astype(np.float32)
        eps = (self.noise * rng.normal(size=self.targets)).astype(np.float32)
        y = (x @ self.w_true + eps).astype(np.float32)
        return x, y

    def next_event(self) -> LabeledUpdate:
        rng = self.rng
        want_delete = bool(self._live) and (
            not self._free or rng.random() < self.churn)
        if want_delete:
            slots = sorted(self._live)
            slot = slots[int(rng.integers(0, len(slots)))]
            x, y = self._live.pop(slot)
            self._free.append(slot)
            return LabeledUpdate("delete", slot, x, y)
        slot = self._free.pop()
        x, y = self._draw_example(rng)
        self._live[slot] = (x, y)
        return LabeledUpdate("insert", slot, x, y)

    def events(self, count: int) -> list:
        """The next ``count`` events as a list (advances the stream)."""
        return [self.next_event() for _ in range(count)]


def labeled_stream(features: int, *, targets: int = 1, capacity: int = 256,
                   churn: float = 0.3, scale: float = 1.0,
                   noise: float = 0.01, seed: int = 0) -> LabeledStream:
    """A labeled insert/delete event stream for the fivm learning views
    (churn is the delete-mix knob; deletes are stored-payload
    negative-weight downdates)."""
    return LabeledStream(features=features, targets=targets,
                         capacity=capacity, churn=churn, scale=scale,
                         noise=noise, seed=seed)


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
