"""repro_torch.guard — failure containment around every trigger firing.

The port of ``repro.guard``.  Five cooperating layers:

  1. :mod:`repro_torch.guard.validate` — admission checks + quarantine for
     incoming ``(u, v)`` update factors;
  2. :mod:`repro_torch.guard.txn`      — transactional firings: snapshot,
     post-firing NaN/Inf validation, atomic rollback;
  3. :mod:`repro_torch.guard.sentinel` — stochastic drift probes + targeted
     exactness recovery, feeding the adaptive planner;
  4. :mod:`repro_torch.guard.chaos`    — deterministic seeded fault
     injection threaded through the engine;
  5. :mod:`repro_torch.guard.degrade`  — serve-path retries, circuit
     breaker, last-good-snapshot fallback with explicit staleness.

Attach to an engine with ``IncrementalEngine(prog, guard=GuardConfig())``
(:class:`EngineGuard` is the per-engine runtime the engine drives);
inject faults with ``IncrementalEngine(prog, chaos=ChaosConfig(...))``.

Where the reference leans on immutable arrays, the port writes out of
place: a transactional guard makes its engine build every firing with
the out-of-place apply (:func:`repro_torch.kernels.ops.
rank_update_batched_out`), so the pre-firing views survive the firing
untouched (:mod:`.txn`).  The fused fast path's commit is the
:func:`repro_torch.kernels.ops.select_commit` kernel, which copies a
pre-firing view back only when a flag on the card says the firing
failed: a clean firing moves no extra bytes and never waits on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.rank_update_rows import RowSet
from .chaos import ChaosConfig, ChaosError, ChaosMonkey, as_monkey
from .degrade import (CircuitBreaker, DegradePolicy, GuardedView,
                      retry_with_backoff)
from .sentinel import DriftSentinel, SentinelConfig
from .txn import (FiringAborted, FiringSnapshot, changed_views,
                  check_finite, nonfinite, restore_snapshot, take_snapshot)
from .validate import (QuarantinedUpdate, QuarantineQueue, ValidationPolicy,
                       all_finite, fro_norm, host_copy, validate_carrier,
                       validate_update)

__all__ = [
    "GuardConfig", "GuardStats", "EngineGuard",
    "ValidationPolicy", "QuarantineQueue", "QuarantinedUpdate",
    "validate_update", "validate_carrier",
    "FiringAborted", "FiringSnapshot", "take_snapshot", "restore_snapshot",
    "changed_views", "check_finite",
    "SentinelConfig", "DriftSentinel",
    "ChaosConfig", "ChaosError", "ChaosMonkey", "as_monkey",
    "DegradePolicy", "CircuitBreaker", "GuardedView", "retry_with_backoff",
]

# fused firings between two accounting syncs (the reference's window)
SYNC_WINDOW = 32


@dataclass(frozen=True)
class GuardConfig:
    """Everything one guarded engine enforces.

    ``transactional=False`` keeps validation/quarantine but lets a
    failed firing propagate (debugging); ``sentinel=None`` disables
    drift probing.  The default — validation + transactional firings,
    no sentinel — is the cheapest configuration that still guarantees
    the store never goes non-finite.
    """

    validation: ValidationPolicy = field(default_factory=ValidationPolicy)
    sentinel: Optional[SentinelConfig] = None
    transactional: bool = True
    quarantine_capacity: int = 1024


@dataclass
class GuardStats:
    """Failure-log counters — deliberately NOT part of
    :class:`~repro_torch.core.runtime.EngineStats`, so a rollback can
    restore the engine's stats bit-identically while the guard still
    remembers what went wrong.

    On the fused fast path the counters are *eventually consistent*:
    a firing's outcome lives on the device until the next sync window
    (every 32 firings) or an explicit :meth:`EngineGuard.sync`.  The
    store itself is always protected immediately — only the accounting
    is deferred."""

    admitted: int = 0
    quarantined: int = 0
    noop_skips: int = 0          # updates dropped by the no-op gate (legal
                                 # skips, NOT faults — never quarantined)
    aborted_firings: int = 0
    rollbacks: int = 0
    probes: int = 0
    drift_recoveries: int = 0
    max_drift: float = 0.0


def _is_f32(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.float32
    return x.dtype == np.float32


class EngineGuard:
    """Per-engine guard runtime; driven by
    :class:`~repro_torch.core.runtime.IncrementalEngine` at its admission,
    firing, and post-commit hooks."""

    def __init__(self, config: GuardConfig, engine):
        import dataclasses
        from ..core.cost import shape_of
        self.config = config
        self.quarantine = QuarantineQueue(config.quarantine_capacity)
        self.stats = GuardStats()
        self.sentinel = (DriftSentinel(config.sentinel, engine.program,
                                       engine.binding)
                         if config.sentinel is not None else None)
        self._input_shapes = {
            name: shape_of(var, engine.binding)
            for name, var in engine.program.inputs.items()}
        # this config can run firings through the fused path (out-of-place
        # applies + device flags + select-commit, no host sync)
        self.fused_path_ok = (config.transactional
                              and config.validation.check_outputs)
        # admission policy minus the finite screen — what the host still
        # checks when the finite screen is deferred into the fused firing
        self._structural_policy = dataclasses.replace(
            config.validation, check_finite=False)
        # fused firings whose outcome has not been fetched yet: the
        # select-commit already kept the store safe on the device, so
        # only the *accounting* (reject/rollback counters + quarantine) is
        # deferred
        self._pending: list = []
        # device-resident cumulative [input-rejects, output-aborts]
        # counts, a new tensor each fused firing; sync() learns "all
        # clean" from ONE fetch regardless of how many firings are
        # pending, and only walks per-firing records when a count moved
        self._nbad: Optional[torch.Tensor] = None
        self._nbad_seen = (0, 0)

    # -- admission (layer 1) -------------------------------------------------
    def admit(self, input_name: str, u, v, defer_finite: bool = False
              ) -> Optional[Tuple[object, object]]:
        """Validate one update; quarantine and return None on reject.

        Numpy factors are checked on the host, tensors on their device
        (:mod:`.validate`).  With ``defer_finite=True`` (the engine's
        fused fast path) the host checks only structure — shape/dtype/rank
        conformance — and the NaN/Inf screen runs inside the firing on
        the device, where a poisoned update rolls back via the
        select-commit and is reclassified as an admission reject at the
        next :meth:`sync`.  A norm budget keeps the full check (the
        budget needs the values anyway)."""
        u = u.detach() if isinstance(u, torch.Tensor) else np.asarray(u)
        v = v.detach() if isinstance(v, torch.Tensor) else np.asarray(v)
        policy = self.config.validation
        if policy.noop_tol > 0.0 and self._noop_gate(u, v):
            return None
        if defer_finite and policy.max_norm is None:
            policy = self._structural_policy
        reason = validate_update(input_name, u, v,
                                 self._input_shapes[input_name], policy)
        if reason is not None:
            self.quarantine.put(input_name, u, v, reason)
            self.stats.quarantined += 1
            return None
        self.stats.admitted += 1
        return u, v

    def admit_batch_stacked(self, input_name: str, updates
                            ) -> Optional[Tuple[object, object]]:
        """Fast-path batch admission that also *stacks*: returns the
        concatenated ``(P, Q)`` factors ready for one rank-ΣkT firing,
        or ``None`` to send the batch down the careful per-update walk
        (:meth:`admit_batch`).  The concat IS the validation vehicle —
        it refuses ragged rows, the stacked dtype exposes any
        non-float32 factor, and one vectorized NaN/Inf reduction over
        ``(P, Q)`` replaces T per-update screens.  Numpy factors stack
        and screen on the host, as in the reference; a batch of tensors
        stacks and screens on their device (one verdict read back)."""
        policy = self.config.validation
        if (policy.max_norm is not None
                or policy.max_update_rank is not None
                or policy.noop_tol > 0.0 or not updates):
            # budgets and the no-op gate need per-update values — the
            # careful walk applies them one update at a time
            return None
        n, m = self._input_shapes[input_name]
        tensors = any(isinstance(x, torch.Tensor)
                      for pair in updates for x in pair)
        try:
            if tensors:
                P = torch.cat([torch.as_tensor(u) for u, _ in updates], 1)
                Q = torch.cat([torch.as_tensor(v) for _, v in updates], 1)
            else:
                P = np.concatenate([u for u, _ in updates], axis=1)
                Q = np.concatenate([v for _, v in updates], axis=1)
            # equal stacked ranks can still hide misaligned pairs
            # (u_i, v_i); a mispairing silently changes the delta
            if [u.shape[1] for u, _ in updates] != \
                    [v.shape[1] for _, v in updates]:
                return None
        except Exception:  # noqa: BLE001 — ragged, 1-D, or odd factors
            return None
        if (P.shape[0] != n or Q.shape[0] != m
                or P.shape[1] != Q.shape[1]
                or not _is_f32(P) or not _is_f32(Q)):
            return None
        if policy.check_finite and not all_finite(P, Q):
            return None
        self.stats.admitted += len(updates)
        return P, Q

    def _noop_gate(self, u, v) -> bool:
        """The no-op gate (runs BEFORE quarantine screening): an update
        whose delta norm bound sits under ``policy.noop_tol`` is a legal
        skip, not a fault — it must never land in quarantine, where an
        operator would read it as an anomaly.  Sound by construction:
        ``‖u‖_F·‖v‖_F ≥ ‖u vᵀ‖_F`` bounds how far ANY maintained view
        can move, and a NaN/Inf norm fails the ``<=`` so poisoned
        updates fall through to the finite screen instead of being
        silently dropped."""
        norm = fro_norm(u) * fro_norm(v)
        if norm <= self.config.validation.noop_tol:
            self.stats.noop_skips += 1
            return True
        return False

    def admit_carrier(self, input_name: str, rows, block, v,
                      count: int = 1) -> Optional[Tuple[object, object]]:
        """Admission for a row-local carrier in compact form: the no-op
        gate, then :func:`validate_carrier` — structure, NaN/Inf, and
        the rank/norm budgets, all computed on the ``(r, k)`` block so
        admission cost scales with the rows *touched*.  On reject the
        factors are quarantined widened (dense-shaped ``(P, Q)``) when
        the row structure permits, so :meth:`QuarantineQueue.replay`
        rides the ordinary update path; ``count`` is the logical update
        count a stacked carrier batch represents."""
        rows = host_copy(rows)
        block = host_copy(block)
        v = host_copy(v)
        policy = self.config.validation
        if policy.noop_tol > 0.0 and self._noop_gate(block, v):
            return None
        reason = validate_carrier(input_name, rows, block, v,
                                  self._input_shapes[input_name], policy)
        if reason is not None:
            try:  # widen for replay; malformed rows keep the compact form
                n = self._input_shapes[input_name][0]
                P = np.zeros((n, block.shape[1]), np.float32)
                P[rows.astype(np.int64)] = block
                qu = P
            except Exception:  # noqa: BLE001
                qu = block
            self.quarantine.put(input_name, qu, v, reason)
            self.stats.quarantined += 1
            return None
        self.stats.admitted += count
        return block, v

    def admit_batch(self, input_name: str, updates) -> list:
        """Careful per-update batch admission: full
        :func:`validate_update` on each update, so one poisoned or
        malformed update quarantines alone and the healthy remainder
        still batches.  The engine lands here only when
        :meth:`admit_batch_stacked` refused the fast path — policy
        budgets set, or something in the batch is structurally off or
        non-finite."""
        admitted = [self.admit(input_name, u, v) for u, v in updates]
        return [a for a in admitted if a is not None]

    # -- transactional firing (layer 2) --------------------------------------
    def fire(self, engine, input_name: str, bucket: int, P, Q,
             screened: bool = False) -> None:
        """Run one trigger firing transactionally: fire → validate
        outputs → commit, or roll back atomically and raise
        :class:`FiringAborted`.  Rollback restores the pre-firing
        tensors, so the store and
        :class:`~repro_torch.core.runtime.EngineStats` come back
        bit-identically.

        Unplanned firings take the fused fast path
        (``engine._guard_fast_path``, :meth:`_fire_fused`): the NaN/Inf
        screens and the commit/rollback select all run on the device, so
        a bad firing never reaches the store and the clean path pays no
        host sync.  The accounting — reject and rollback counters,
        quarantined factors — resolves within a sync window (every 32
        firings) or on an explicit :meth:`sync`."""
        if engine._guard_fast_path:
            if len(self._pending) >= SYNC_WINDOW:
                self.sync()
            return self._fire_fused(engine, input_name, bucket, P, Q,
                                    screened)
        if not self.config.transactional:
            if engine.chaos is not None:
                engine.chaos.maybe_raise_in_trigger()
            return engine._fire_inner(input_name, bucket, P, Q)
        self._transact(engine, input_name, take_snapshot(engine),
                       lambda: engine._fire_inner(input_name, bucket, P, Q))

    def fire_rowlocal(self, engine, input_name: str, fn, rows, block,
                      v) -> None:
        """Transactional row-local firing.  Always the snapshot path, as
        in the reference: the snapshot saves the touched rows of each
        view the row kernel updates in place (``fn.row_views``), and the
        output check reads only those rows plus the views the firing
        wrote whole.  The rows are checked and uploaded once, for the
        snapshot, the kernel and the check alike."""
        rows = RowSet.of(rows, self._input_shapes[input_name][0])

        def run():
            engine.views = fn(engine.views, rows, block, v)
        if not self.config.transactional:
            if engine.chaos is not None:
                engine.chaos.maybe_raise_in_trigger()
            return run()
        self._transact(engine, input_name,
                       take_snapshot(engine, fn.row_views, rows), run)

    def _transact(self, engine, input_name: str, snap: FiringSnapshot,
                  run) -> None:
        """(chaos) → ``run()`` → validate outputs → commit, or restore
        ``snap`` and raise :class:`FiringAborted`."""
        try:
            if engine.chaos is not None:
                engine.chaos.maybe_raise_in_trigger()
            run()
            reason = engine._agreed(self.validate_outputs(snap,
                                                          engine.views))
            if reason is not None:
                raise FiringAborted(reason, input_name, "validate")
        except FiringAborted:
            restore_snapshot(engine, snap)
            self.stats.rollbacks += 1
            raise
        except Exception as e:  # noqa: BLE001 — any kernel error rolls back
            restore_snapshot(engine, snap)
            self.stats.rollbacks += 1
            raise FiringAborted(repr(e), input_name, "execute") from e

    def _fire_fused(self, engine, input_name: str, bucket: int,
                    P, Q, screened: bool = False) -> None:
        """The clean-path firing: out-of-place applies that set a device
        flag when they store a non-finite value, NaN/Inf reductions over
        the views written outside the kernel (and over the factors, when
        admission deferred its screen here), then one
        :func:`~repro_torch.kernels.ops.select_commit` a written view,
        which copies the pre-firing view back only when a flag is set.
        The verdict stays on the device; only the accounting reads it,
        lazily (:meth:`sync`).  Host-screened factors (batch admission,
        ``screened``) skip the device screen."""
        fn = engine._planned_trigger_fn(input_name, bucket)
        dev = engine.device
        if self._nbad is None:
            self._nbad = torch.zeros(2, dtype=torch.int32, device=dev)
        old = engine.views
        try:
            if engine.chaos is not None:
                engine.chaos.maybe_raise_in_trigger()
            # flags: [factors non-finite, an output non-finite]
            flags = torch.zeros(2, dtype=torch.int32, device=dev)
            new = fn(dict(old), P, Q, flags[1:])
            if fn.unflagged:
                flags[1:].bitwise_or_(nonfinite(
                    *(new[name] for name in fn.unflagged)).to(torch.int32))
            if self.config.validation.check_finite and not screened:
                flags[:1].copy_(nonfinite(P, Q).to(torch.int32))
            for name in fn.written:
                ops.select_commit(flags, old[name], new[name])
        except FiringAborted:
            self.stats.rollbacks += 1
            raise
        except Exception as e:  # noqa: BLE001
            self.stats.rollbacks += 1
            raise FiringAborted(repr(e), input_name, "execute") from e
        # safe either way: a bad firing's views were selected back
        engine.views = new
        engine.stats.lowrank_applies += fn.lowrank_applies
        bad_in = flags[0]
        self._nbad = self._nbad + torch.stack(
            (bad_in, flags[1] & (1 - bad_in)))
        self._pending.append((self._nbad, input_name, P, Q))

    def sync(self) -> None:
        """Resolve deferred fused-firing outcomes.  The fused firings
        thread a cumulative ``[input-rejects, output-aborts]`` count, so
        the clean case costs ONE fetch per sync window regardless of how
        many firings are pending; only when a count moved does the
        (rare) per-firing walk run — a poisoned update is reclassified
        as an admission reject (exactly as the host screen would have
        recorded it), a firing whose *outputs* went non-finite is counted
        as a rollback, and both quarantine the factors the select rolled
        back."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        tail = tuple(pending[-1][0].tolist())
        if tail == self._nbad_seen:  # every pending firing was clean
            return
        prev_in, prev_out = self._nbad_seen
        self._nbad_seen = tail
        for nbad_after, input_name, P, Q in pending:
            cur_in, cur_out = nbad_after.tolist()
            if cur_in > prev_in:
                # deferred admission screen fired: the factors were
                # non-finite, the select kept the store untouched
                self.stats.admitted -= 1
                self.stats.quarantined += 1
                self.quarantine.put(
                    input_name, P, Q,
                    f"{input_name}: non-finite entries in update factors")
            elif cur_out > prev_out:
                self.stats.rollbacks += 1
                self.stats.aborted_firings += 1
                self.quarantine.put(
                    input_name, P, Q,
                    f"{input_name}: firing aborted — non-finite output, "
                    f"rolled back in-program")
            prev_in, prev_out = cur_in, cur_out

    # -- post-firing validation (layer 2) ------------------------------------
    def validate_outputs(self, snap: FiringSnapshot, views) -> Optional[str]:
        if not self.config.validation.check_outputs:
            return None
        return check_finite(views, changed_views(snap, views),
                            {n: idx for n, (idx, _) in snap.rows.items()})

    def on_abort(self, input_name: str, P, Q, reason: str) -> None:
        """A firing rolled back: keep its factors for inspection/replay.

        If the factors themselves turn out non-finite (possible only on
        the fused path, where the admission screen is deferred into the
        firing and an unrelated fault — e.g. an injected trigger raise —
        can abort the firing first), the record is reclassified as the
        admission reject the host screen would have produced."""
        self.stats.aborted_firings += 1
        P = host_copy(P)
        Q = host_copy(Q)
        if (self.config.validation.check_finite
                and not (np.isfinite(P).all() and np.isfinite(Q).all())):
            self.stats.admitted -= 1
            self.stats.quarantined += 1
            self.quarantine.put(
                input_name, P, Q,
                f"{input_name}: non-finite entries in update factors")
            return
        self.quarantine.put(input_name, P, Q,
                            f"{input_name}: firing aborted — {reason}")

    # -- post-commit (layer 3) -----------------------------------------------
    def after_firing(self, engine) -> None:
        if self.sentinel is None:
            return
        drifts = self.sentinel.after_firing(engine)
        if drifts is not None:
            self.stats.probes = self.sentinel.probes
            self.stats.drift_recoveries = self.sentinel.recoveries
            self.stats.max_drift = self.sentinel.max_drift
