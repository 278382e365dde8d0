"""Transactional trigger firings (guard layer 2).

A firing either commits completely or leaves the engine untouched.  The
reference gets that for free from immutable arrays: its snapshot is a
shallow copy of the view dict and its rollback a pointer swap.  The
port's engine updates views in place, so a guarded engine writes out of
place instead (:func:`repro_torch.core.codegen.build_trigger_fn` with
``out_of_place=True``): every dense apply of a guarded firing stores its
result in new storage and leaves the pre-firing tensor alone.  With that,
the reference's contracts carry over:

* the snapshot is a ``dict`` copy of the views, by reference;
* :func:`changed_views` finds the views a firing wrote by identity;
* rollback is a ``dict`` swap, bit-identical by construction: the
  restored views *are* the pre-firing tensors.

Row-local firings keep the in-place row kernel, which writes only the
touched rows of each row-local view.  For those the snapshot also saves
the touched rows (``index_select``), rollback scatters them back
(``index_copy_``), and the output check reads only them.

The snapshot also captures the engine's host-side firing bookkeeping
(hybrid staleness counters, lazy-stale set, a copy of ``EngineStats``,
and on a higher-order engine its deferred-cascade windows) so an aborted
firing is invisible there too.  The price
is memory: one extra view per written view while a firing runs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import torch

from ..kernels.rank_update_rows import RowSet


class FiringAborted(RuntimeError):
    """A guarded firing failed and was rolled back.

    ``reason`` says why ("chaos: injected trigger fault", "non-finite
    output in view Z", a kernel error repr); ``stage`` is where it was
    caught (``"execute"`` — the trigger raised — or ``"validate"`` — it
    produced non-finite outputs).
    """

    def __init__(self, reason: str, input_name: str, stage: str):
        super().__init__(f"firing on {input_name!r} aborted [{stage}]: "
                         f"{reason}")
        self.reason = reason
        self.input_name = input_name
        self.stage = stage


@dataclass
class FiringSnapshot:
    """Everything a rollback must restore: the views by reference, and
    the touched rows of the views a row-local firing writes in place
    (``{view: (row index, saved rows)}``)."""

    views: Dict[str, torch.Tensor]
    accum_rank: Dict[str, int]
    stale: Set[str]
    stats: object  # copied EngineStats dataclass
    rows: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict)
    # deferred-cascade window state (higher-order engines): pending window
    # factors, window-start base snapshots, firing counters, banked inputs
    cascade: Optional[tuple] = None


def take_snapshot(engine, row_views=(), rows=None) -> FiringSnapshot:
    """Pre-firing snapshot: O(#views) reference copies, plus, for a
    row-local firing, a gather of the touched ``rows`` (an integer array,
    or a :class:`~repro_torch.kernels.rank_update_rows.RowSet`) of each
    view in ``row_views`` — r × p values a view, the only device work."""
    saved = {}
    for name in row_views:
        view = engine.views[name]
        idx = RowSet.of(rows, view.shape[0]).index(view.device)
        saved[name] = (idx, view.index_select(0, idx))
    return FiringSnapshot(views=dict(engine.views),
                          accum_rank=dict(engine._accum_rank),
                          stale=set(engine._stale),
                          stats=dataclasses.replace(engine.stats),
                          rows=saved,
                          cascade=engine._cascade_snapshot())


def restore_snapshot(engine, snap: FiringSnapshot) -> None:
    """Roll the engine back to ``snap`` — bit-identical: the restored
    views are the very tensors the snapshot kept, and a view written in
    place on its touched rows gets those rows back."""
    engine.views = snap.views
    for name, (idx, saved) in snap.rows.items():
        snap.views[name].index_copy_(0, idx, saved)
    engine._accum_rank = snap.accum_rank
    engine._stale = snap.stale
    for f in dataclasses.fields(type(engine.stats)):
        setattr(engine.stats, f.name, getattr(snap.stats, f.name))
    if snap.cascade is not None:
        engine._cascade_restore(snap.cascade)


def changed_views(snap: FiringSnapshot,
                  views: Dict[str, torch.Tensor]) -> List[str]:
    """Names whose tensor identity changed since the snapshot — every
    view the firing wrote out of place — and the views whose touched
    rows it saved (written in place by the row kernel)."""
    return [name for name, val in views.items()
            if snap.views.get(name) is not val or name in snap.rows]


def check_finite(views: Dict[str, torch.Tensor], names,
                 rows: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Optional[str]:
    """Post-firing output validation: one reduction a view, queued back
    to back, and a single host read for the set
    (:func:`repro_torch.core.codegen.build_finite_check`).  ``rows`` maps
    a view to the row index to probe (a row-local firing's touched rows).
    Returns a reason naming the offending views, or ``None`` when every
    output is finite."""
    names = sorted(names)
    if not names:
        return None
    from ..core.codegen import build_finite_check
    flags = build_finite_check(names)(views, rows)
    if bool(flags.all()):
        return None
    bad = [n for n, ok in zip(names, flags) if not bool(ok)]
    return f"non-finite output in view(s) {', '.join(bad)}"


def nonfinite(*xs: torch.Tensor) -> torch.Tensor:
    """A bool scalar on the device of ``xs``: True when an entry of any of
    them is not finite.  No host read, and a handful of launches: one
    ``aminmax`` a tensor (a NaN reaches both ends, ±inf one of them), then
    the ends times zero, summed — NaN exactly when an end is not
    finite."""
    ends = torch.stack([e for x in xs if x.numel() for e in torch.aminmax(x)]
                       or [torch.zeros((), device=xs[0].device)])
    return ends.mul(0).sum().isnan()
