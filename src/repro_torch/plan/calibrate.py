"""Wall-clock calibration of the planner's FLOP cost model.

The §7 crossover ``K* = reeval_flops / (2·n·m)`` treats every FLOP as
equal, but the two sides run at very different rates: re-evaluation is
dense matmuls at the library's peak, while a rank-K factored sweep is
skinny matmuls and rank updates, and a small firing is bound by the
host's dispatch of its many small ops.  Deciding strategies from raw
FLOPs therefore misplaces the rank where re-evaluation starts to win.

:func:`calibrate_cost_scale` measures the ratio on the device that will
execute the plan: it fires the all-incremental and the all-reeval static
plan at a probe stacked rank, prices both firings under the FLOP model,
and returns

    cost_scale = (t_incr / sweep_flops) / (t_reeval / reeval_flops)

— the wall-clock cost of one sweep FLOP in units of re-evaluation
FLOPs.  Feed it to ``WorkloadDescriptor(cost_scale=…)`` and the planner
prices every view against the *effective* crossover ``K*/cost_scale``.

Every timed firing or op ends in ``torch.cuda.synchronize`` on the card
(the counterpart of the reference's ``jax.block_until_ready``), so the
times are the device's work plus the host's dispatch of it — the host
part is what the calibration exists to catch.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..core.compiler import batch_bucket
from ..core.cost import expr_cost, shape_of
from ..core.runtime import IncrementalEngine, _sync, resolve_device

from .planner import static_plan


def _probe_updates(n: int, m: int, rank: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(scale=0.01, size=(n, 1)).astype(np.float32),
             rng.normal(scale=0.01, size=(m, 1)).astype(np.float32))
            for _ in range(rank)]


def calibrate_cost_scale(make_engine, inputs: Dict, input_name: str, *,
                         probe_rank: int = 32, samples: int = 9,
                         trigger_cache=None) -> float:
    """Measure ``WorkloadDescriptor.cost_scale`` for one program.

    ``make_engine`` builds a fresh :class:`IncrementalEngine` (called
    twice — the two static baselines must not share view state);
    ``inputs`` initializes it; the probe fires ``probe_rank`` stacked
    rank-1 updates to ``input_name``.  Returns the measured ratio,
    clamped to ≥ 1e-3; timing keeps the best of ``samples``
    steady-state firings per side so a scheduler stall cannot skew the
    scale.
    """
    engines: Dict[str, IncrementalEngine] = {}
    flops: Dict[str, float] = {}
    ups = _probe_updates(*np.shape(inputs[input_name]), probe_rank)
    for strategy in ("incremental", "reeval"):
        eng = make_engine()
        if not isinstance(eng, IncrementalEngine):
            raise TypeError("make_engine must return an IncrementalEngine")
        if trigger_cache is not None:
            eng._trigger_cache = trigger_cache
        eng.set_plan(static_plan(eng, strategy))
        eng.initialize(dict(inputs))
        engines[strategy] = eng

        total = 0.0
        for up in eng.compiled.triggers[input_name].updates:
            st = next((s for s in eng.program.statements
                       if s.target.name == up.view), None)
            if st is None:
                continue
            if strategy == "incremental":
                if up.kind != "lowrank":
                    continue  # dense-kind updates are not a rank-K sweep
                shape = shape_of(st.target, eng.binding)
                # the firing executes at the padded pow2 bucket rank,
                # so price the sweep at that rank, not the raw probe
                total += 2.0 * batch_bucket(probe_rank) * shape[0] * shape[1]
            else:
                total += expr_cost(st.expr, eng.binding).flops
        flops[strategy] = max(total, 1.0)

    def firing(eng):
        eng.apply_updates(input_name, ups)
        _sync(eng.device)

    # interleaved probe, order re-randomized each round — both
    # strategies see the same conditions AND the same mix of
    # predecessors (a firing inherits its predecessor's allocator and
    # cache state), so the rate ratio survives load drift and order bias
    # that would skew back-to-back blocks
    raw: Dict[str, list] = {s: [] for s in engines}
    names = list(engines)
    order = np.random.default_rng(0)
    for eng in engines.values():
        firing(eng)  # warm-up: first-use builds and allocations
    for _ in range(samples):
        for idx in order.permutation(len(names)):
            t0 = time.perf_counter()
            firing(engines[names[idx]])
            raw[names[idx]].append(time.perf_counter() - t0)
    # min, not median: the best window is the true rate — stall episodes
    # can outlast half the probe, but each side only needs one quiet
    # window, and nothing ever runs too fast
    times = {s: float(np.min(v)) for s, v in raw.items()}

    scale = ((times["incremental"] / flops["incremental"])
             / (times["reeval"] / flops["reeval"]))
    return max(float(scale), 1e-3)


def calibrate_op_cost_scales(n: int = 512, samples: int = 5,
                             seed: int = 0, device=None) -> Dict[str, float]:
    """Measure ``WorkloadDescriptor.op_cost_scales`` on ``device``
    (``None``: the card).

    Times one representative op per cost-model op kind at size ``n`` —
    dense matmul ``a @ b`` (``"matmul"``), ``torch.linalg.inv`` behind
    ``Inverse`` (``"inverse"``), elementwise ``a + b`` (``"other"``) —
    and returns each kind's measured seconds-per-FLOP relative to the
    matmul rate.  A kind's scale > 1 means its FLOPs run slower than the
    dense-matmul FLOPs the raw count implicitly assumes, pushing the §7
    crossover of views dominated by that kind upward.  Best-of-
    ``samples`` timing, same rationale as :func:`calibrate_cost_scale`.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)
                         ).to(device)
    b = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)
                         ).to(device)
    spd = a @ a.T + n * torch.eye(n, dtype=torch.float32, device=device)
    ops = {
        "matmul": (lambda: a @ b, 2.0 * n ** 3),
        "inverse": (lambda: torch.linalg.inv(spd),
                    (2.0 / 3.0) * n ** 3 + 2.0 * n ** 2),
        "other": (lambda: a + b, float(n) * n),
    }
    rates: Dict[str, float] = {}
    for kind, (fn, op_flops) in ops.items():
        fn()  # warm-up: library handles and workspaces
        _sync(device)
        best = float("inf")
        for _ in range(samples):
            t0 = time.perf_counter()
            fn()
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        rates[kind] = best / op_flops
    base = rates["matmul"]
    return {k: max(float(r / base), 1e-3) for k, r in rates.items()}
