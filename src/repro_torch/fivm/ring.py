"""The maintained covariance/gram ring (F-IVM, arXiv 1703.07484).

A labeled dataset living in ``capacity`` row slots of a design matrix
``X`` (and target matrix ``Y``, occupancy indicator ``W``) is summarized
by the ring of aggregates

    c  = WᵀW   (live-example count)
    s  = XᵀW   (feature sums Σxᵢ)
    G  = XᵀX   (gram / scatter matrix)
    XY = XᵀY   (feature–target cross moments)
    YY = YᵀY   (target moments)

— every statistic a normal-equation learner needs, registered as
*views* in the LINVIEW compiler and maintained by its factored
triggers.  An insert of example ``(x, y)`` at slot ``i`` is the rank-1
row carrier ``ΔX = eᵢxᵀ`` (and ``ΔY = eᵢyᵀ``, ``ΔW = eᵢ``); a delete is
the **same stored payload with weight −1** — the negative-weight
downdate that makes deletion "an insertion with weight −1", and makes
insert-then-delete restore the ring bit-near-identically (the carriers
cancel exactly in the factor algebra; float summation order is the only
residual).

Model coefficients are inputs too: slot ``j`` holds ``Bⱼ`` with the
maintained view ``grad{j} = G·Bⱼ − XY`` (the λ-term is added at read so
one ring serves every regularization strength).  :meth:`Ring.set_model`
turns a solver's new coefficients into a rank-``targets`` factored
delta via :func:`repro_torch.train.grad_compression.compress_leaf` — the
PowerSGD-shaped factors double as exact IVM deltas because ``ΔB`` has
rank ≤ ``targets`` — so gradient computation stays a maintained view,
never a recompute.

With ``order=2`` the engine's deferred cascade banks every firing in
factored form and folds at the next read — the decoupled-refresh serve
contract (docs/fivm.md): ingest cost per event is O(rank) bookkeeping,
model-refresh cost is paid by the reader.

The views live on the engine's device (the card unless ``device="cpu"``);
every read hands back host numpy copies, since the solvers
(:mod:`repro_torch.fivm.solvers`) run on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from ..core import (IncrementalEngine, Program, dim, matmul,
                    row_delta_carrier, sub, transpose)
from ..data.updates import LabeledUpdate


@dataclass(frozen=True)
class RingSpec:
    """Shape contract of one maintained ring (hashable: the registry
    keys shared rings by it).

    ``model_slots`` coefficient inputs are pre-allocated so several
    models (different λ, different solver) share one ring;
    ``proj_dim > 0`` adds a random projection input ``R`` and the view
    ``XP = X·R`` — the one ring view the compiler proves *row-local*
    (gram-side views widen row support through the transpose), so
    row-carrier containment has a genuine target."""

    features: int
    targets: int = 1
    capacity: int = 256
    model_slots: int = 1
    proj_dim: int = 0

    def __post_init__(self):
        if self.features < 1 or self.targets < 1 or self.capacity < 1:
            raise ValueError(f"bad ring spec {self}")
        if self.model_slots < 0 or self.proj_dim < 0:
            raise ValueError(f"bad ring spec {self}")


def build_ring_program(spec: RingSpec) -> Program:
    """The ring as a LINVIEW program: inputs X/Y/W (+ B-slots, + R),
    views c/s/G/XY/YY (+ grad{j}, + XP)."""
    prog = Program(name=f"fivm_ring_f{spec.features}_t{spec.targets}"
                        f"_c{spec.capacity}_b{spec.model_slots}"
                        f"_d{spec.proj_dim}")
    M, N, P, ONE = dim("m"), dim("n"), dim("p"), dim("one")
    X = prog.input("X", (M, N))
    Y = prog.input("Y", (M, P))
    W = prog.input("W", (M, ONE))
    G = prog.let("G", matmul(transpose(X), X))
    XY = prog.let("XY", matmul(transpose(X), Y))
    prog.let("s", matmul(transpose(X), W))
    prog.let("c", matmul(transpose(W), W))
    prog.let("YY", matmul(transpose(Y), Y))
    outputs = ["G", "XY", "s", "c", "YY"]
    for j in range(spec.model_slots):
        B = prog.input(f"B{j}", (N, P))
        prog.let(f"grad{j}", sub(matmul(G, B), XY))
        outputs.append(f"grad{j}")
    binding = dict(m=spec.capacity, n=spec.features, p=spec.targets, one=1)
    if spec.proj_dim > 0:
        D = dim("d")
        R = prog.input("R", (N, D))
        prog.let("XP", matmul(X, R))   # row-local: ΔX·R keeps row support
        outputs.append("XP")
        binding["d"] = spec.proj_dim
    prog.outputs = outputs
    prog.bind_dims(**binding)
    return prog


def initial_ring_inputs(spec: RingSpec, seed: int = 0
                        ) -> Dict[str, np.ndarray]:
    """The empty ring: zero data/occupancy/models, seeded projection."""
    inputs: Dict[str, np.ndarray] = {
        "X": np.zeros((spec.capacity, spec.features), np.float32),
        "Y": np.zeros((spec.capacity, spec.targets), np.float32),
        "W": np.zeros((spec.capacity, 1), np.float32),
    }
    for j in range(spec.model_slots):
        inputs[f"B{j}"] = np.zeros((spec.features, spec.targets),
                                   np.float32)
    if spec.proj_dim > 0:
        rng = np.random.default_rng(seed + 7)
        inputs["R"] = (rng.normal(size=(spec.features, spec.proj_dim))
                       / np.sqrt(spec.proj_dim)).astype(np.float32)
    return inputs


def _host(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of a view (never a buffer a later in-place apply
    could change)."""
    return t.detach().to("cpu", copy=True).numpy()


def event_carriers(ev: LabeledUpdate, capacity: int
                   ) -> List[Tuple[str, object]]:
    """One labeled event as the three row carriers it fires: ``(input
    name, RowLocalCarrier)`` for X, Y, W.  Deletes ride the same path
    with ``weight=−1`` (the downdate).  Shared by :meth:`Ring.apply`
    and the fleet submission path so both fire bit-identical deltas."""
    w = ev.weight
    x = np.asarray(ev.x, dtype=np.float32).reshape(-1)
    y = np.asarray(ev.y, dtype=np.float32).reshape(-1)
    return [
        ("X", row_delta_carrier(ev.slot, x, capacity, weight=w)),
        ("Y", row_delta_carrier(ev.slot, y, capacity, weight=w)),
        ("W", row_delta_carrier(ev.slot, np.ones(1, np.float32),
                                capacity, weight=w)),
    ]


class Ring:
    """One maintained ring: the engine, its event log, and the model
    slots.  See the module docstring for the view algebra.

    ``order=2`` (any int/dict the engine accepts) turns on deferred
    maintenance — updates bank, reads fold — which is the serve mode;
    ``guard``/``chaos``/``plan``/``trigger_cache``/``device`` pass
    straight through to :class:`repro_torch.core.IncrementalEngine`.
    """

    def __init__(self, spec: RingSpec, *, seed: int = 0, order=None,
                 fold_window: int = 8, guard=None, chaos=None, plan=None,
                 trigger_cache=None, device=None, **engine_opts):
        self.spec = spec
        self.program = build_ring_program(spec)
        ranks: Dict[str, int] = {"X": 1, "Y": 1, "W": 1}
        for j in range(spec.model_slots):
            ranks[f"B{j}"] = spec.targets
        self.update_ranks = ranks
        self.engine = IncrementalEngine(
            self.program, ranks, order=order, fold_window=fold_window,
            guard=guard, chaos=chaos, plan=plan,
            trigger_cache=trigger_cache, device=device, **engine_opts)
        self._seed = seed
        # grow-only host-side log of (weight, x) gram events — solvers
        # keep cursors into it for Cholesky update/downdate replay
        self.event_log: List[Tuple[float, np.ndarray]] = []
        self.events_applied = 0
        # per-slot applied coefficients + compress_leaf warm-start state
        self._models: Dict[int, np.ndarray] = {}
        self._model_err: Dict[int, np.ndarray] = {}
        self._slots_claimed = 0
        self.initialize()

    # -- lifecycle ---------------------------------------------------------

    def initial_inputs(self) -> Dict[str, np.ndarray]:
        return initial_ring_inputs(self.spec, self._seed)

    def initialize(self) -> None:
        """(Re)start from the empty ring: zero data, zero models."""
        self.engine.initialize(self.initial_inputs())
        self.event_log = []
        self.events_applied = 0
        self._models = {}
        self._model_err = {}

    def bootstrap(self, X, Y=None) -> None:
        """Load an existing labeled dataset in ONE full evaluation
        (rows of ``X`` occupy slots ``0..len(X)-1``), replacing the
        ring's contents — how an interactive analysis starts from a
        table that already exists instead of replaying its history as
        events.  Models and the event log reset with the data."""
        s = self.spec
        X = np.asarray(X, np.float32)
        if X.ndim != 2 or X.shape[1] != s.features \
                or X.shape[0] > s.capacity:
            raise ValueError(f"bootstrap X {X.shape} does not fit "
                             f"({s.capacity}, {s.features})")
        m = X.shape[0]
        inputs = self.initial_inputs()
        inputs["X"][:m] = X
        if Y is not None:
            inputs["Y"][:m] = np.asarray(Y, np.float32).reshape(
                m, s.targets)
        inputs["W"][:m] = 1.0
        self.engine.initialize(inputs)
        self.event_log = []
        self.events_applied = 0
        self._models = {}
        self._model_err = {}

    def claim_slot(self) -> int:
        """Allocate the next free model slot (registry bookkeeping)."""
        if self._slots_claimed >= self.spec.model_slots:
            raise RuntimeError(
                f"ring has only {self.spec.model_slots} model slots; "
                f"build the spec with more model_slots to share further")
        j = self._slots_claimed
        self._slots_claimed += 1
        return j

    # -- data path ---------------------------------------------------------

    def apply(self, ev: LabeledUpdate) -> None:
        """Fire one labeled insert/delete through the ring triggers."""
        for name, carrier in event_carriers(ev, self.spec.capacity):
            self.engine.apply_update(name, carrier)
        self.event_log.append(
            (ev.weight, np.asarray(ev.x, np.float32).reshape(-1).copy()))
        self.events_applied += 1

    def apply_events(self, events) -> int:
        n = 0
        for ev in events:
            self.apply(ev)
            n += 1
        return n

    @property
    def log_version(self) -> int:
        """Monotone ring version: solvers diff their cursor against it
        to know how many gram events their cached factor is behind."""
        return len(self.event_log)

    # -- read path ---------------------------------------------------------

    def read(self, *names: str) -> Dict[str, np.ndarray]:
        """Read views (folds any deferred windows first — on an
        ``order>=2`` ring this is where banked updates materialize)."""
        self.engine.output()
        if not names:
            names = tuple(self.program.output_names())
        return {n: _host(self.engine.views[n]) for n in names}

    def view(self, name: str) -> np.ndarray:
        return self.read(name)[name]

    def gram(self) -> np.ndarray:
        return self.view("G")

    def xty(self) -> np.ndarray:
        return self.view("XY")

    def count(self) -> float:
        return float(self.view("c").reshape(()))

    def sum_x(self) -> np.ndarray:
        return self.view("s").reshape(-1)

    def mean_x(self) -> np.ndarray:
        c = max(self.count(), 1.0)
        return self.sum_x() / c

    def live_data(self) -> Tuple[np.ndarray, np.ndarray]:
        """The live examples ``(X_live, Y_live)`` read straight from
        the maintained X/Y/W input views (slot order).  The live rows are
        gathered on the engine's device; only they cross to the host."""
        self.engine.output()
        views = self.engine.views
        live = views["W"].reshape(-1) > 0.5
        return _host(views["X"][live]), _host(views["Y"][live])

    # -- model slots (gradient as a maintained view) -----------------------

    def model(self, slot: int) -> np.ndarray:
        """The coefficients the ring currently maintains for ``slot``
        (the applied low-rank approximations, matching input ``B{slot}``
        in the engine up to the carried compression residual)."""
        z = np.zeros((self.spec.features, self.spec.targets), np.float32)
        return self._models.get(slot, z).copy()

    def set_model(self, slot: int, B_new: np.ndarray) -> None:
        """Move slot ``slot`` to ``B_new`` by firing the factored delta
        through the ``B{slot}`` trigger, keeping ``grad{slot}`` a
        maintained view.

        ``ΔB = B_new − B_applied`` has rank ≤ ``targets``, so the
        rank-``targets`` ``compress_leaf`` factors (warm-started on the
        identity right basis, with error feedback) are exact up to
        float — reused verbatim as the IVM delta.
        """
        from ..train.grad_compression import compress_leaf
        if not (0 <= slot < self.spec.model_slots):
            raise IndexError(f"model slot {slot} out of range "
                             f"[0, {self.spec.model_slots})")
        s = self.spec
        B_new = np.asarray(B_new, np.float32).reshape(s.features, s.targets)
        B_cur = self._models.get(
            slot, np.zeros((s.features, s.targets), np.float32))
        err = self._model_err.get(
            slot, np.zeros((s.features, s.targets), np.float32))
        delta = B_new - B_cur
        if not np.any(delta) and not np.any(err):
            return
        q0 = np.eye(s.targets, dtype=np.float32)
        P, Q, new_err = compress_leaf(delta, q0, err)
        P, Q = P.numpy(), Q.numpy()
        self.engine.apply_update(f"B{slot}", P, Q)
        self._models[slot] = B_cur + P @ Q.T
        self._model_err[slot] = new_err.numpy()

    def gradient(self, slot: int, lam: float = 0.0) -> np.ndarray:
        """``∇ = G·B − XY + λ·B`` — the maintained ``grad{slot}`` view
        plus the read-time λ-term (one ring, every λ)."""
        g = self.view(f"grad{slot}")
        if lam:
            g = g + np.float32(lam) * self._models.get(
                slot, np.zeros_like(g))
        return g

    # -- introspection -----------------------------------------------------

    @property
    def stats(self):
        return self.engine.stats

    def __repr__(self) -> str:
        s = self.spec
        return (f"Ring(features={s.features}, targets={s.targets}, "
                f"capacity={s.capacity}, slots={s.model_slots}, "
                f"events={self.events_applied})")
