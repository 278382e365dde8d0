"""Drift sentinel: stochastic residual probes + exactness recovery
(guard layer 3).

The port of ``repro.guard.sentinel``: the same probes, drawn from the
same seeded numpy stream (so one seed probes with the same vectors in
both packages), applied with torch on the engine's device;
``torch.linalg.solve_ex`` stands for ``jnp.linalg.solve`` (neither raises
on a singular operand).  Matmuls run in full fp32 (TF32 off, PyTorch's
default).

Incremental maintenance is algebraically exact but floating-point
drifts: a million rank-k sweeps accumulate rounding that a single
re-evaluation would not.  Re-evaluating everything to *check* for drift
would forfeit the paper's entire §7 win, so the sentinel sketches
instead: every ``probe_every`` firings it draws a few random probe
vectors ``x`` and measures, per materialized view ``A`` with defining
statement ``A := f(parents)``,

    drift(A) = ‖f(parents)·x − A·x‖_F / ‖f(parents)·x‖_F

where ``f(parents)·x`` is computed *matrix-free* (matvec chains through
the expression tree, O(n²) per probe instead of the O(n³) of
materializing ``f``).  Per-statement residuals cover the whole DAG by
induction: inputs are maintained exactly (the trigger's ``+=`` is the
update itself), so any divergence from full re-evaluation must show up
as some statement disagreeing with its own parents.

When a view's drift exceeds ``tol`` the sentinel runs **exactness
recovery**: targeted re-evaluation of only the drifted views, in
program order (so a recovered ancestor feeds its recovered descendant)
— the §7 cost model's escape hatch, paid only when the probes prove it
is needed.  Recoveries are also reported to the engine's
:class:`~repro_torch.plan.AdaptivePlanner` (when one is attached) as a
re-planning signal: a view that keeps drifting is a view whose
incremental strategy is numerically too aggressive.

On a mesh engine (``IncrementalEngine(mesh=...)``, views row-sharded)
every rank draws the same probes from the seeded stream; each rank
evaluates ``f(parents)·x`` and ``A·x`` on its row block
(:func:`repro_torch.dist.ivm_shard.probe_sums`) and the squared norms
are summed over the row axis before the ratio, so every rank reads the
same drift.  Recovery re-evaluates on the mesh and keeps the row layout
(``engine._recompute``); a replicated view is probed whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import expr as ex
from ..core.codegen import evaluate
from ..core.cost import shape_of


@dataclass(frozen=True)
class SentinelConfig:
    """Probe cadence and tolerance.

    ``probe_every`` amortizes the probe against the firings it covers
    (a probe costs O(Σ n·m · n_probes) — a few matvecs — vs the
    2·k·n·m of every firing's sweep, so the clean-path overhead is
    ~``n_probes / (k · probe_every)``).  ``tol`` is the relative
    residual above which a view is declared drifted; ``recover=False``
    reports drift without re-evaluating (monitoring-only mode).
    """

    probe_every: int = 64
    n_probes: int = 2
    tol: float = 5e-3
    seed: int = 0
    recover: bool = True


class DriftSentinel:
    """Tracks per-view drift for one engine's program."""

    def __init__(self, config: SentinelConfig, program, binding):
        self.config = config
        self.program = program
        self.binding = dict(binding)
        self._rng = np.random.default_rng(config.seed)
        self._since_probe = 0
        self.probes = 0
        self.recoveries = 0
        self.last_drift: Dict[str, float] = {}
        self.max_drift = 0.0

    # -- cadence -------------------------------------------------------------
    def after_firing(self, engine) -> Optional[Dict[str, float]]:
        """Count one committed firing; probe when the cadence is due.
        Returns the per-view drift map on probe firings, else None."""
        self._since_probe += 1
        if self._since_probe < self.config.probe_every:
            return None
        self._since_probe = 0
        drifts = self.probe(engine)
        drifted = [n for n, d in drifts.items() if d > self.config.tol]
        if drifted and self.config.recover:
            self.recover(engine, drifted)
        return drifts

    # -- probing -------------------------------------------------------------
    def probe(self, engine) -> Dict[str, float]:
        """Residual-sketch every materialized view against its defining
        statement (lazy views left stale by planned firings are skipped
        — they are *known* stale and recomputed on read)."""
        drifts: Dict[str, float] = {}
        views = engine.views
        env = None
        if engine.mesh is not None:
            from ..dist import ivm_shard
            env = ivm_shard.tagged(views, engine._kinds)
        for st in self.program.statements:
            name = st.target.name
            if name in engine._stale or name not in views:
                continue
            _, m = shape_of(st.target, self.binding)
            x = torch.from_numpy(self._rng.standard_normal(
                (m, self.config.n_probes)).astype(np.float32)).to(
                    views[name].device)
            if env is not None:
                den2, num2 = ivm_shard.probe_sums(
                    st.expr, env[name], env, self.binding, engine._shards, x)
                denom, num = float(np.sqrt(den2)), float(np.sqrt(num2))
            else:
                ref = expr_matvec(st.expr, views, self.binding, x)
                cur = views[name] @ x
                denom = float(torch.linalg.norm(ref))
                num = float(torch.linalg.norm(ref - cur))
            drift = num / max(denom, 1e-30)
            if not np.isfinite(drift):
                drift = float("inf")
            drifts[name] = drift
        self.probes += 1
        self.last_drift = drifts
        finite = [d for d in drifts.values() if np.isfinite(d)]
        if finite:
            self.max_drift = max(self.max_drift, max(finite))
        return drifts

    def drifted_views(self) -> List[str]:
        return [n for n, d in self.last_drift.items() if d > self.config.tol]

    # -- recovery ------------------------------------------------------------
    def recover(self, engine, names) -> List[str]:
        """Targeted exactness recovery: re-evaluate only the drifted
        views, in program order, against the engine's current store —
        ancestors first, so a drifted chain heals in one pass.  Each
        recovered view gets storage of its own
        (:func:`~repro_torch.core.codegen.recompute`; on a mesh the
        sharded re-evaluation, each view in its row layout)."""
        todo = set(names)
        statements = [st for st in self.program.statements
                      if st.target.name in todo]
        engine._recompute(statements)
        recovered = [st.target.name for st in statements]
        for name in recovered:
            engine._accum_rank[name] = 0
        if recovered:
            self.recoveries += 1
            if engine.planner is not None:
                engine.planner.note_drift(recovered)
        return recovered


# ---------------------------------------------------------------------------
# matrix-free expression application: expr @ x without materializing expr
# ---------------------------------------------------------------------------


def expr_matvec(e, env, binding, x):
    """Evaluate ``e @ x`` for a skinny probe block ``x`` — matvec chains
    instead of matmuls, O(n²·probes) where materializing ``e`` costs
    O(n³).  ``Inverse`` nodes become triangular solves against the
    (materialized) operand; node types with no cheap matvec form fall
    back to full evaluation (they are small in every paper program)."""
    if isinstance(e, ex.Var):
        return env[e.name] @ x
    if isinstance(e, ex.Identity):
        return x
    if isinstance(e, ex.Zero):
        n = _dim(e.shape[0], binding)
        return torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    if isinstance(e, ex.MatMul):
        return expr_matvec(e.lhs, env, binding,
                           expr_matvec(e.rhs, env, binding, x))
    if isinstance(e, ex.Add):
        out = expr_matvec(e.terms[0], env, binding, x)
        for t in e.terms[1:]:
            out = out + expr_matvec(t, env, binding, x)
        return out
    if isinstance(e, ex.Scale):
        f = evaluate(e.factor, env, binding, device=x.device)
        if f.dim() == 2:
            f = f[0, 0]
        return f * expr_matvec(e.operand, env, binding, x)
    if isinstance(e, ex.Transpose):
        return expr_rmatvec(e.operand, env, binding, x)
    if isinstance(e, ex.Inverse):
        a = evaluate(e.operand, env, binding, device=x.device)
        if a.shape == (1, 1):
            return x / a
        return torch.linalg.solve_ex(a, x).result
    # HStack / ColSlice / Const: rare and small — materialize
    return evaluate(e, env, binding, device=x.device) @ x


def expr_rmatvec(e, env, binding, x):
    """``eᵀ @ x`` by the dual recursion (so Transpose nodes never
    materialize their operand)."""
    if isinstance(e, ex.Var):
        return env[e.name].T @ x
    if isinstance(e, ex.Identity):
        return x
    if isinstance(e, ex.Zero):
        m = _dim(e.shape[1], binding)
        return torch.zeros((m, x.shape[1]), dtype=x.dtype, device=x.device)
    if isinstance(e, ex.MatMul):
        return expr_rmatvec(e.rhs, env, binding,
                            expr_rmatvec(e.lhs, env, binding, x))
    if isinstance(e, ex.Add):
        out = expr_rmatvec(e.terms[0], env, binding, x)
        for t in e.terms[1:]:
            out = out + expr_rmatvec(t, env, binding, x)
        return out
    if isinstance(e, ex.Scale):
        f = evaluate(e.factor, env, binding, device=x.device)
        if f.dim() == 2:
            f = f[0, 0]
        return f * expr_rmatvec(e.operand, env, binding, x)
    if isinstance(e, ex.Transpose):
        return expr_matvec(e.operand, env, binding, x)
    if isinstance(e, ex.Inverse):
        a = evaluate(e.operand, env, binding, device=x.device)
        if a.shape == (1, 1):
            return x / a
        return torch.linalg.solve_ex(a.T, x).result
    return evaluate(e, env, binding, device=x.device).T @ x


def _dim(d, binding):
    return binding[d.name] if isinstance(d, ex.Dim) else int(d)
