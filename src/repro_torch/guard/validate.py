"""Update validation & quarantine (guard layer 1).

The port of ``repro.guard.validate``.  Every ``(u, v)`` factored update is
admitted through :func:`validate_update` before it can touch an engine
queue or trigger:
shape/dtype conformance against the target input, NaN/Inf screening,
and a rank/norm budget (a single adversarial update with a huge
Frobenius norm can push an f32 view to Inf even though every entry is
finite).  Rejected updates are not dropped — they land in a per-input
:class:`QuarantineQueue` where an operator (or a test) can inspect
them, repair them, and :meth:`~QuarantineQueue.replay` them through the
engine's normal guarded path.

Factors are screened where they live: numpy arrays (what
:class:`~repro_torch.data.UpdateStream` yields) with numpy on the host, as
in the reference; torch tensors with torch on their own device, so a
factor already on the card is never copied to the host to be checked —
only the verdict (one scalar) is read back.  A quarantined record keeps
host copies.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ValidationPolicy:
    """What :func:`validate_update` enforces on incoming factors.

    ``max_norm`` bounds ``‖u‖_F · ‖v‖_F`` — an upper bound on the
    Frobenius norm of the applied delta ``u vᵀ`` — so one oversized
    update cannot blow a float32 view past overflow even though every
    entry is individually finite.  ``check_outputs`` belongs to the
    transactional layer (:mod:`repro_torch.guard.txn`): post-firing NaN/Inf
    validation of every written view before the firing commits.

    ``noop_tol`` enables the no-op gate: an update whose delta norm
    bound ``‖u‖_F·‖v‖_F`` is at most ``noop_tol`` is *skipped* — no
    firing, no quarantine (it is a legal no-op, not a fault; counted in
    ``GuardStats.noop_skips``).  The bound dominates the true delta
    norm, so the gate can never skip an update that would move any view
    by more than ``noop_tol`` (a NaN norm fails the comparison and
    falls through to the finite screen).
    """

    check_finite: bool = True
    check_outputs: bool = True
    max_update_rank: Optional[int] = None
    max_norm: Optional[float] = None
    noop_tol: float = 0.0


def _array(x):
    """``x`` as a numpy array, or as the tensor it is (never copied)."""
    return x.detach() if isinstance(x, torch.Tensor) else np.asarray(x)


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype.is_floating_point
    return x.dtype.kind == "f"


def all_finite(*xs) -> bool:
    """Whether every entry of every array or tensor is finite (on the
    tensor's own device; one scalar read back)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            if not bool(torch.isfinite(x).all()):
                return False
        elif not np.isfinite(x).all():
            return False
    return True


def fro_norm(x) -> float:
    """Frobenius norm of an array or a tensor, as a host float."""
    if isinstance(x, torch.Tensor):
        return float(torch.linalg.norm(x.float()))
    return float(np.linalg.norm(x))


def host_copy(x) -> np.ndarray:
    """``x`` on the host (a tensor is copied there; an array as it is)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def validate_update(input_name: str, u: np.ndarray, v: np.ndarray,
                    input_shape: Tuple[int, int],
                    policy: ValidationPolicy) -> Optional[str]:
    """Admission check for ``input_name += u @ v.T``.

    Returns ``None`` when the update is admissible, else a short
    human-readable rejection reason (which becomes the quarantine
    record's ``reason``).  Numpy factors are checked on the host; tensors
    on their device, with only the verdicts read back.
    """
    n, m = input_shape
    u = _array(u)
    v = _array(v)
    if u.ndim != 2 or v.ndim != 2:
        return (f"{input_name}: factors must be 2-D, got "
                f"u.ndim={u.ndim} v.ndim={v.ndim}")
    if u.shape[0] != n or v.shape[0] != m:
        return (f"{input_name}: factor rows ({u.shape[0]}, {v.shape[0]}) "
                f"do not match input shape ({n}, {m})")
    if u.shape[1] != v.shape[1]:
        return (f"{input_name}: factor ranks disagree "
                f"({u.shape[1]} != {v.shape[1]})")
    if not (_is_float(u) and _is_float(v)):
        return (f"{input_name}: factors must be floating point, got "
                f"{u.dtype}/{v.dtype}")
    if policy.max_update_rank is not None and u.shape[1] > policy.max_update_rank:
        return (f"{input_name}: rank {u.shape[1]} exceeds budget "
                f"{policy.max_update_rank}")
    if policy.check_finite and not all_finite(u, v):
        return f"{input_name}: non-finite entries in update factors"
    if policy.max_norm is not None:
        norm = fro_norm(u) * fro_norm(v)
        if not norm <= policy.max_norm:  # catches NaN too
            return (f"{input_name}: delta norm bound {norm:.3e} exceeds "
                    f"budget {policy.max_norm:.3e}")
    return None


def validate_carrier(input_name: str, rows: np.ndarray, block: np.ndarray,
                     v: np.ndarray, input_shape: Tuple[int, int],
                     policy: ValidationPolicy) -> Optional[str]:
    """Admission check for a row-local carrier in *compact* form.

    The same budgets as :func:`validate_update`, restated on the
    ``(rows, block, V)`` triple so admission never materializes the
    dense-shaped left factor: structure (row indices sorted, unique,
    in-range; block rows match), dtype, NaN/Inf, and the rank/norm
    budgets (``‖block‖_F·‖V‖_F`` equals the widened bound exactly —
    the scattered zeros contribute nothing).
    """
    n, m = input_shape
    rows = host_copy(rows)
    block = _array(block)
    v = _array(v)
    if rows.ndim != 1 or block.ndim != 2 or v.ndim != 2:
        return (f"{input_name}: carrier dims — rows.ndim={rows.ndim} "
                f"block.ndim={block.ndim} v.ndim={v.ndim}")
    if rows.dtype.kind not in "iu":
        return f"{input_name}: carrier rows must be integral, got {rows.dtype}"
    if rows.size == 0:
        return f"{input_name}: row-local carrier with empty row set"
    if rows.min() < 0 or rows.max() >= n:
        return (f"{input_name}: carrier rows out of range [0, {n}) "
                f"(min {rows.min()}, max {rows.max()})")
    if np.any(np.diff(rows) <= 0):
        return f"{input_name}: carrier rows must be sorted and unique"
    if block.shape[0] != rows.size:
        return (f"{input_name}: block rows {block.shape[0]} != affected "
                f"rows {rows.size}")
    if v.shape[0] != m:
        return (f"{input_name}: right factor rows {v.shape[0]} do not "
                f"match input columns {m}")
    if block.shape[1] != v.shape[1]:
        return (f"{input_name}: factor ranks disagree "
                f"({block.shape[1]} != {v.shape[1]})")
    if not (_is_float(block) and _is_float(v)):
        return (f"{input_name}: factors must be floating point, got "
                f"{block.dtype}/{v.dtype}")
    if (policy.max_update_rank is not None
            and block.shape[1] > policy.max_update_rank):
        return (f"{input_name}: rank {block.shape[1]} exceeds budget "
                f"{policy.max_update_rank}")
    if policy.check_finite and not all_finite(block, v):
        return f"{input_name}: non-finite entries in update factors"
    if policy.max_norm is not None:
        norm = fro_norm(block) * fro_norm(v)
        if not norm <= policy.max_norm:
            return (f"{input_name}: delta norm bound {norm:.3e} exceeds "
                    f"budget {policy.max_norm:.3e}")
    return None


@dataclass
class QuarantinedUpdate:
    """One rejected update, held with enough context to replay it."""

    input_name: str
    u: np.ndarray
    v: np.ndarray
    reason: str
    seq: int
    wall_time: float = field(default_factory=time.time)


class QuarantineQueue:
    """Bounded FIFO of rejected updates, inspectable and replayable.

    ``capacity`` bounds memory under a sustained poison storm: the
    oldest records are evicted first (and counted in ``evicted``), so a
    misbehaving producer can never OOM the view service through its own
    rejects.
    """

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._items: List[QuarantinedUpdate] = []
        self._seq = 0
        self.evicted = 0

    def put(self, input_name: str, u, v, reason: str) -> QuarantinedUpdate:
        rec = QuarantinedUpdate(input_name=input_name,
                                u=host_copy(u), v=host_copy(v),
                                reason=reason, seq=self._seq)
        self._seq += 1
        self._items.append(rec)
        if len(self._items) > self.capacity:
            drop = len(self._items) - self.capacity
            self._items = self._items[drop:]
            self.evicted += drop
        return rec

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(list(self._items))

    def by_input(self, input_name: str) -> List[QuarantinedUpdate]:
        return [q for q in self._items if q.input_name == input_name]

    def reasons(self) -> Dict[str, int]:
        """Histogram of rejection reasons (first line only)."""
        out: Dict[str, int] = {}
        for q in self._items:
            key = q.reason.split(":", 1)[-1].strip()
            out[key] = out.get(key, 0) + 1
        return out

    def clear(self) -> None:
        self._items.clear()

    def replay(self, engine, repair: Optional[Callable[[QuarantinedUpdate],
               Optional[Tuple[np.ndarray, np.ndarray]]]] = None,
               input_name: Optional[str] = None) -> Tuple[int, int]:
        """Re-submit quarantined updates through the engine's guarded path.

        ``repair`` maps a record to fixed ``(u, v)`` factors (or ``None``
        to drop it); without one, records are replayed verbatim — useful
        after a policy change (e.g. a raised norm budget).  Replayed
        updates go through :meth:`IncrementalEngine.apply_update`, so
        they are re-validated: a still-bad update lands back in
        quarantine rather than looping.  Returns ``(applied,
        requarantined)``.
        """
        guard = getattr(engine, "guard", None)
        if guard is not None:
            guard.sync()  # deferred rejects belong to this replay pass
        picked = [q for q in self._items
                  if input_name is None or q.input_name == input_name]
        kept_out = {id(q) for q in picked}  # identity, not ==: the
        # records hold ndarrays, whose == is elementwise
        self._items = [q for q in self._items if id(q) not in kept_out]
        applied = requarantined = 0
        for q in picked:
            fixed = (q.u, q.v) if repair is None else repair(q)
            if fixed is None:
                continue
            before = len(self)
            engine.apply_update(q.input_name, fixed[0], fixed[1])
            if guard is not None:
                guard.sync()  # resolve any deferred reject NOW, so the
                # still-bad update counts as requarantined, not applied
            if len(self) > before:
                requarantined += 1
            else:
                applied += 1
        return applied, requarantined
