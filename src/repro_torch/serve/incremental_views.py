"""Incremental logit views: LINVIEW's serving integration.

Serving systems cache views over model outputs: classifier scores for a
corpus, prompt-prefix logits, retrieval scores.  When the head gets a
low-rank update ΔW = U Vᵀ (an adapter hot-swap, an online fine-tune
step), re-running the head over the corpus costs O(m·n·p); the delta rule
for the final linear view

    Y = H Wᵀ     ⇒     ΔY = H (ΔW)ᵀ = (H V) Uᵀ

costs O(m·k·(n+p)).  This module maintains such views through the port's
:class:`~repro_torch.core.IncrementalEngine`, so the same compiler,
triggers and rank-update kernel drive the analytics and serving paths.

Exact only for views linear in the updated weight (lm-head, classifier,
embedding-projection layers); :meth:`IncrementalLogitView.covers` says
which updates are maintainable.  :meth:`IncrementalLogitView.replan`
hot-swaps a cost-based maintenance plan (:mod:`repro_torch.plan`) into
the view's engine without dropping its queued deltas.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import IncrementalEngine, Program, dim, matmul, transpose


def build_logit_view_program(m: int, d: int, p: int) -> Program:
    """The logit-view program Y = H · Wᵀ: H (m, d) cached corpus hidden
    states, W (p, d) output head."""
    prog = Program(name="logit_view")
    M, D, P_ = dim("m"), dim("d"), dim("p")
    H = prog.input("H", (M, D))
    W = prog.input("W", (P_, D))
    prog.let("Y", matmul(H, transpose(W)))
    prog.outputs = ["Y"]
    prog.bind_dims(m=m, d=d, p=p)
    return prog


class IncrementalLogitView:
    """Maintains Y = H · Wᵀ under rank-k updates to W (and to H).

    H (m, d): hidden states of a corpus of m items, computed once with the
    frozen backbone; W (p, d): the output head.  The engine holds f32
    copies of both and Y on ``device`` (``None``: the card).
    """

    def __init__(self, hidden, head, rank: int = 1, flush_size: int = 16,
                 flush_age: float = 0.05,
                 max_batch_rank: Optional[int] = None, plan=None,
                 device=None):
        m, d = hidden.shape
        p, d2 = head.shape
        if d != d2:
            raise ValueError(f"hidden width {d} != head width {d2}")
        prog = build_logit_view_program(m, d, p)
        self.engine = IncrementalEngine(
            prog, {"W": rank, "H": rank}, max_batch_rank=max_batch_rank,
            flush_size=flush_size, flush_age=flush_age, plan=plan,
            device=device)
        self.engine.initialize({"H": hidden, "W": head})

    def replan(self, workload):
        """Hot-swap a cost-based maintenance re-plan for this view.

        ``workload`` is a :class:`repro_torch.plan.WorkloadDescriptor`
        (or a ready :class:`~repro_torch.plan.MaintenancePlan`).  The
        staleness contract survives the swap: pending queued hot-swap
        deltas are kept (they flush under the *new* plan on the same
        ``flush_size``/``flush_age`` thresholds).  Returns the installed
        plan.
        """
        from ..plan import MaintenancePlan, plan_for_engine
        plan = (workload if isinstance(workload, MaintenancePlan)
                else plan_for_engine(self.engine, workload))
        self.engine.set_plan(plan)
        return plan

    @property
    def logits(self) -> torch.Tensor:
        # read-path staleness bound: flush pending deltas past the size or
        # age threshold (a lone queued delta must not go stale forever)
        self.engine.maybe_flush("W")
        return self.engine.views["Y"]

    def update_head(self, u, v) -> torch.Tensor:
        """W += u vᵀ (u: (p, k) class/vocab side, v: (d, k))."""
        self.engine.apply_update("W", u, v)
        return self.logits

    def update_head_batch(self, updates) -> torch.Tensor:
        """Apply head updates ``[(u_t, v_t)]`` as ONE batched firing: Y is
        swept once per batch instead of once per delta."""
        self.engine.apply_updates("W", updates)
        return self.logits

    def submit_head_update(self, u, v) -> bool:
        """Serving-path contract: queue a head update for coalescing.

        Returns True if this submission flushed the queue (logits are
        fresh), False if it is pending (call :meth:`flush` before reads
        that need exact logits)."""
        return self.engine.enqueue_update("W", u, v) is not None

    def flush(self) -> torch.Tensor:
        """Force all pending updates into the maintained logits."""
        self.engine.flush()
        return self.logits

    @property
    def pending_updates(self) -> int:
        return self.engine.pending_rank("W")

    def add_items(self, u, v) -> torch.Tensor:
        """Corpus-side update H += u vᵀ (refreshed item embeddings for the
        rows picked out by u)."""
        self.engine.apply_update("H", u, v)
        return self.logits

    @staticmethod
    def covers(update_path: str) -> bool:
        """Is a weight at ``update_path`` maintainable exactly?"""
        linear_views = ("lm_head", "embed", "frontend", "router")
        return any(t in update_path for t in linear_views)

    def speedup_estimate(self) -> float:
        return (self.engine.reeval_flops() /
                max(self.engine.trigger_flops("W"), 1.0))
