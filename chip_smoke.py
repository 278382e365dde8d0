#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each of which raises on failure:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build: compile every CUDA source of ``src/repro_torch/kernels/csrc``
   from the checkout, one ``nvcc`` per source, all started together.
3. kernels: every CUDA entry against its plain PyTorch version on the card,
   at the main path's shapes plus ragged shapes (and a T > 1 stack), with
   kernel, plain, library and bound times.
4. matrix powers A^16 (n = 10000, exp model, the paper's size): 8 single
   updates, one batch of 16, 20 queued updates with a final flush, all
   replayed through the re-evaluation engine and compared view by view;
   the kernel launch counts must equal the engine's applies.
5. OLS (m = 16384, n = 8192, p = 1): the same sequence.
6. row-local, compact regime: the left chain Y1 = X W1, Y2 = Y1 W2 at
   n = 2^20, m = 384, K = 256 under rank-8 row-local carriers touching 1 %
   of the rows (8 single, one stacked batch of 16, 8 Zipf-skewed), through
   a carrier engine, a second engine fed the same deltas widened to dense
   factor pairs, and re-evaluation.
7. row-local, mixed regime: the general iterative form (n = 10000,
   p = 128, k = 16, exp) under rank-1 carriers on A touching 100 rows (8
   single, one batch of 8): A, T1 and S2 take the row kernel, the other
   views the dense kernel.
8. sums of powers, gradient descent, PageRank (edge updates) and the
   general iterative form at n = 10000 on the dense path: 4 single
   updates, one batch of 8, 8 queued updates with a flush.
9. Sherman-Morrison through the dual-matmul kernel on OLS's maintained
   W (8192 x 8192) from phase 5.

Every launch count is set to 0 just before a phase drives its engines and
read just after; the counts of each kernel must equal the applies (or
calls) the phase made.

The last two lines of standard output are the ``{"kernels": [...]}``
record and ``{"ok": true, "device": {...}}``.  Without CUDA, or outside a
checkout, the script prints no result and exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
DEVICE = "cuda"   # where the script makes its inputs

# Tolerance of a kernel against its plain version: the repo's kernel
# tolerance (tests/conftest.py assert_close), |got - want| <= ATOL + RTOL
# |want|.  Both sum K products in fp32, in different orders.
KERNEL_RTOL = KERNEL_ATOL = 2e-4

# Tolerance of every incremental view against the re-evaluation engine's,
# as max |incr - reeval| / max |reeval|.  Both run fp32 with TF32 off, but
# they sum inner dimensions of 8192-16384 in different orders (factored
# chains and rank-k applies against full GEMMs and an LU inverse), and the
# incremental side carries its rounding through 44 updates.  A wrong apply
# (an update lost or applied twice) moves a view by more than 1e-2 of its
# largest entry at these update scales, far above this bound.
MAIN_TOL = 1e-3

UPDATES_SINGLE, UPDATES_BATCH, UPDATES_QUEUED = 8, 16, 20
# the four apps of phase 8 run at n = 10000 with fewer updates, to keep
# the script short
APP_N, APP_UPDATES = 10000, (4, 8, 8)

# phase 6: the left chain of benchmarks/bench_sparse.py at its widths
# (m = 384, K = 256, rank-8 carriers, 1 % of rows), n raised to 2^20
CHAIN_N, CHAIN_M, CHAIN_K, CHAIN_RANK = 2 ** 20, 384, 256, 8
CHAIN_ROWS = CHAIN_N // 100
# phase 7: the general iterative form under 100-row carriers on A
GI_N, GI_P, GI_K, GI_ROWS = 10000, 128, 16, 100

# fp32 (non-tensor-core) peak and memory rate per part, from NVIDIA's data
# sheets at the part's full power limit: (name match, TFLOP/s, TB/s).
PEAKS = (("H100 PCIe", 51.0, 2.0), ("H100 NVL", 60.0, 3.9),
         ("H100", 67.0, 3.35))

SOURCES = {
    "rank_update_batched": "src/repro_torch/kernels/csrc/rank_update.cu",
    "rank_update": "src/repro_torch/kernels/csrc/rank_update.cu",
    "rank_update_rows": "src/repro_torch/kernels/csrc/rank_update_rows.cu",
    "dual_matmul": "src/repro_torch/kernels/csrc/dual_matmul.cu"}
REPLACES = {
    "rank_update_batched": "src/repro/kernels/rank_update.py:84",
    "rank_update": "src/repro/kernels/rank_update.py:40",
    "rank_update_rows": "src/repro/kernels/rank_update_rows.py:50",
    "dual_matmul": "src/repro/kernels/dual_matmul.py:45"}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def peaks(name: str):
    for key, tflops, tbs in PEAKS:
        if key in name:
            return key, tflops * 1e12, tbs * 1e12
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def bound(nbytes: float, flops: float, flops_peak: float,
          bytes_peak: float):
    """Least time (ms) for work that must move ``nbytes`` and do
    ``flops``, and which of the two bounds it."""
    t_bytes = nbytes / bytes_peak * 1e3
    t_ops = flops / flops_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, target_ms: float = 40.0) -> float:
    """Mean ms per call of ``fn`` over a run of launches, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(5, min(200, int(target_ms / max(start.elapsed_time(end),
                                               1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_modules():
    from repro_torch.kernels import dual_matmul, rank_update, rank_update_rows
    return rank_update, rank_update_rows, dual_matmul


def reset_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


def launches() -> dict:
    out = {}
    for mod in kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def check_launches(label: str, got: dict, expect: dict) -> None:
    if got != expect:
        raise AssertionError(f"{label}: kernel launches {got} != the "
                             f"phase's applies {expect}")


def check_close(label: str, got, want) -> float:
    """Raise unless |got - want| <= ATOL + RTOL |want|; max abs err."""
    import torch
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: shape {tuple(got.shape)} or "
                             "non-finite output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    worst = float(((got - want).abs() - KERNEL_RTOL * want.abs()).max()) \
        if got.numel() else 0.0
    if worst > KERNEL_ATOL:
        raise AssertionError(f"{label}: max abs err {err} exceeds atol "
                             f"{KERNEL_ATOL} + rtol {KERNEL_RTOL} |want|")
    return err


def check_views(label: str, got: dict, want: dict) -> dict:
    """Every view of ``want`` against ``got``, relative to its largest
    entry, within MAIN_TOL."""
    import torch
    rel = {}
    for view, w in want.items():
        g = got[view]
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{label}: view {view} is {tuple(g.shape)}"
                                 f" or non-finite")
        scale = float(w.abs().max()) or 1.0
        rel[view] = float((g - w).abs().max()) / scale
        if rel[view] > MAIN_TOL:
            raise AssertionError(f"{label}: view {view} differs from "
                                 f"re-evaluation by {rel[view]} > {MAIN_TOL}")
    return rel


# -- phase 3 ------------------------------------------------------------------

def check_kernels(flops_peak: float, bytes_peak: float):
    """Each CUDA entry against its plain version at the given shapes.
    Returns {entry: [per-shape records]}."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    cuda_ru, cuda_rows, cuda_dual = kernel_modules()

    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen)

    def record(entry, shape, err, ms, plain_ms, lib_ms, nbytes, flops):
        b_ms, b_by = bound(nbytes, flops, flops_peak, bytes_peak)
        rec = {"entry": entry, **shape, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
               "bound_by": b_by}
        log("kernel " + json.dumps(rec))
        out[entry].append(rec)

    out = {name: [] for name in SOURCES}

    # (n, p, T, k): the main path's applies (matrix powers views, OLS X and
    # Z/W), a ragged shape, and T > 1 stacks
    batched_cases = [(10000, 10000, 1, K) for K in (1, 16, 64, 256)] + [
        (8192, 8192, 1, 2), (8192, 8192, 1, 32),
        (16384, 8192, 1, 1), (16384, 8192, 1, 16),
        (37, 101, 1, 5), (1000, 777, 4, 3), (10000, 10000, 16, 1)]
    single_cases = [(10000, 10000, 1), (16384, 8192, 1), (37, 101, 5)]
    cases = [("rank_update_batched", c) for c in batched_cases] + \
            [("rank_update", (n, p, 1, k)) for n, p, k in single_cases]
    for entry, (n, p, t, k) in cases:
        m0 = randn(n, p)
        u = randn(t, n, k)
        v = randn(t, p, k)
        K = t * k
        u2 = u.permute(1, 0, 2).reshape(n, K).contiguous()
        v2 = v.permute(1, 0, 2).reshape(p, K).contiguous()
        if entry == "rank_update":
            args = (u[0], v[0])
            kernel, plain = cuda_ru.rank_update, ref.rank_update
        else:
            args = (u, v)
            kernel, plain = cuda_ru.rank_update_batched, ref.rank_update_batched
        want = plain(m0, *args)
        got = kernel(m0.clone(), *args)
        torch.cuda.synchronize()
        err = check_close(f"{entry} {(n, p, t, k)}", got, want)
        del want, got
        work = m0.clone()
        ms = time_ms(lambda: kernel(work, *args))
        plain_ms = time_ms(lambda: plain(m0, *args))
        lib_ms = time_ms(lambda: work.addmm_(u2, v2.T))
        record(entry, {"n": n, "p": p, "T": t, "k": k}, err, ms, plain_ms,
               lib_ms, 8.0 * n * p + 4.0 * K * (n + p), 2.0 * n * p * K)
        del m0, u, v, u2, v2, work

    # (n, p, r, k): phase 6's applies to X and to Y1, Y2 (one carrier, and
    # a stacked batch of about 16 x 1 % of the rows at rank 128), phase 7's
    # to A and S2 and to T1 (one carrier, a batch of 8), a ragged shape
    rng = np.random.default_rng(0)
    row_cases = [(CHAIN_N, CHAIN_M, CHAIN_ROWS, CHAIN_RANK),
                 (CHAIN_N, CHAIN_K, CHAIN_ROWS, CHAIN_RANK),
                 (CHAIN_N, CHAIN_M, 15 * CHAIN_ROWS, 16 * CHAIN_RANK),
                 (GI_N, GI_N, GI_ROWS, 1), (GI_N, GI_P, GI_ROWS, 1),
                 (GI_N, GI_N, 8 * GI_ROWS, 8), (37, 101, 5, 3)]
    for n, p, r, k in row_cases:
        m0 = randn(n, p)
        rows = cuda_rows.RowSet(np.sort(rng.choice(n, r, replace=False)), n)
        block = randn(r, k)
        v = randn(p, k)
        idx = rows.index(DEVICE)
        want = ref.rank_update_rows(m0, idx, block, v)
        got = cuda_rows.rank_update_rows(m0.clone(), rows, block, v)
        torch.cuda.synchronize()
        err = check_close(f"rank_update_rows {(n, p, r, k)}", got, want)
        del want, got
        work = m0.clone()
        ms = time_ms(lambda: cuda_rows.rank_update_rows(work, rows, block, v))
        plain_ms = time_ms(lambda: ref.rank_update_rows(m0, idx, block, v))
        lib_ms = time_ms(lambda: work.index_add_(0, idx, block @ v.T))
        record("rank_update_rows", {"n": n, "p": p, "r": r, "k": k}, err, ms,
               plain_ms, lib_ms, 8.0 * r * p + 4.0 * k * (r + p) + 4.0 * r,
               2.0 * r * p * k)
        del m0, block, v, work

    # (n, m, k): phase 9's W (8192^2, k = 1) and ragged shapes
    for n, m, k in [(8192, 8192, 1), (1000, 777, 5), (37, 101, 1)]:
        a = randn(n, m)
        u = randn(m, k)
        v = randn(n, k)
        got = cuda_dual.dual_matmul(a, u, v)
        want = ref.dual_matmul(a, u, v)
        torch.cuda.synchronize()
        err = max(check_close(f"dual_matmul {(n, m, k)} {name}", g, w)
                  for name, g, w in zip("PQ", got, want))
        ms = time_ms(lambda: cuda_dual.dual_matmul(a, u, v))
        plain_ms = time_ms(lambda: ref.dual_matmul(a, u, v))
        lib_ms = time_ms(lambda: (a @ u, a.T @ v))
        record("dual_matmul", {"n": n, "m": m, "k": k}, err, ms, plain_ms,
               lib_ms, 4.0 * n * m + 4.0 * k * (2 * n + 2 * m),
               4.0 * n * m * k)
        del a, u, v, got, want
    torch.cuda.empty_cache()
    return out


# -- phases 4, 5 and 8: the dense path ----------------------------------------

def drive(label: str, app, inputs, stream,
          counts=(UPDATES_SINGLE, UPDATES_BATCH, UPDATES_QUEUED)) -> dict:
    """Drive one app's engine through all three update paths, replay the
    same updates through its re-evaluation engine, and hold every view
    against it.  Returns the phase's record, launch counts included."""
    import torch

    eng, ree, name = app.engine, app.reeval, app.update_input
    t0 = time.perf_counter()
    app.initialize(inputs)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_single, n_batch, n_queued = counts
    total = n_single + n_batch + n_queued
    ups = [stream.next_update() for _ in range(total)]
    single = ups[:n_single]
    batch = ups[n_single:n_single + n_batch]
    queued = ups[n_single + n_batch:]

    torch.cuda.synchronize()
    reset_launches()
    fired0 = eng.stats.triggers_fired
    applies0 = eng.stats.lowrank_applies
    single_s = []
    for u, v in single:
        t0 = time.perf_counter()
        eng.apply_update(name, u, v, block=True)
        single_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    eng.apply_updates(name, batch, block=True)
    batch_s = (time.perf_counter() - t0) / len(batch)
    t0 = time.perf_counter()
    for u, v in queued:
        eng.enqueue_update(name, u, v)
    eng.flush(block=True)
    queued_s = (time.perf_counter() - t0) / len(queued)
    firings = eng.stats.triggers_fired - fired0
    applies = eng.stats.lowrank_applies - applies0
    reeval_s = []
    for u, v in ups:
        t0 = time.perf_counter()
        ree.apply_update(name, u, v, block=True)
        reeval_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    got = launches()
    check_launches(label, got, {"rank_update_batched": applies,
                                "rank_update": total,
                                "rank_update_rows": 0, "dual_matmul": 0})
    rel = check_views(label, eng.views, ree.views)
    eng.reevaluate(block=True)
    rec = {"phase": label, "views": {k: list(v.shape)
                                     for k, v in eng.views.items()},
           "initialize_s": init_s, "firings": firings,
           "lowrank_applies": applies, "launches": got,
           "updates": {"single": n_single, "batch": n_batch,
                       "queued": n_queued},
           "apply_update_s_first": single_s[0],
           "apply_update_s_median": statistics.median(single_s[1:]),
           "apply_updates_s_per_update": batch_s,
           "enqueue_flush_s_per_update": queued_s,
           "reeval_engine_s_first": reeval_s[0],
           "reeval_engine_s_median": statistics.median(reeval_s[1:]),
           "reevaluate_s": eng.stats.reeval_seconds,
           "rel_err_vs_reeval": rel, "tolerance": MAIN_TOL,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    return rec


class EdgeStream:
    """PageRank edge updates at distinct pages: each replaces one page's
    outlink column by a random stochastic column (``PageRank.edge_update``
    against the initialized M, exact because no page repeats)."""

    def __init__(self, app, n: int, seed: int):
        import numpy as np
        self.app, self.n = app, n
        self.rng = np.random.default_rng(seed)
        self.pages = iter(self.rng.permutation(n))

    def next_update(self):
        col = self.rng.random(self.n).astype("float32")
        col /= col.sum()
        return self.app.edge_update(int(next(self.pages)), col)


# -- phases 6 and 7: row-local carriers ---------------------------------------

def chain_program(n: int, m: int, k: int):
    """The left chain of benchmarks/bench_sparse.py: Y1 = X W1, Y2 = Y1 W2."""
    from repro_torch.core import Program, dim, matmul
    p = Program(name="chain")
    X = p.input("X", (dim("N"), dim("M")))
    W1 = p.input("W1", (dim("M"), dim("K")))
    W2 = p.input("W2", (dim("K"), dim("K")))
    Y1 = p.let("Y1", matmul(X, W1))
    p.let("Y2", matmul(Y1, W2))
    p.outputs = ["Y1", "Y2"]
    return p.bind_dims(N=n, M=m, K=k)


def timed(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def drive_carriers(label: str, eng, ree, name: str, steps, widened=None
                   ) -> dict:
    """Fire ``steps`` — (kind, carriers) applied one by one, or ("batch",
    carriers) stacked into one firing — through the carrier
    engine ``eng``, the same deltas widened to factor pairs through
    ``widened`` (if given), and one by one through ``ree``; hold every
    view against re-evaluation and the launches against the applies."""
    import torch
    from repro_torch.core import NoOpCarrier, stack_carriers
    pairs = [[c.factors() for c in cs] for _, cs in steps]
    stats0 = dict(vars(eng.stats))
    wide0 = widened.stats.lowrank_applies if widened is not None else 0
    torch.cuda.synchronize()
    reset_launches()
    times = {"carrier": {}, "widened": {}}
    for (kind, cs), ps in zip(steps, pairs):
        if kind != "batch":
            times["carrier"].setdefault(kind, []).extend(
                timed(lambda: eng.apply_update(name, c)) for c in cs)
            if widened is not None:
                times["widened"].setdefault(kind, []).extend(
                    timed(lambda: widened.apply_update(name, *p)) for p in ps)
        else:
            # a no-op in the batch is skipped and counted, never fired
            t = timed(lambda: eng.apply_updates(
                name, cs + [NoOpCarrier(*cs[0].nm)]))
            times["carrier"].setdefault(kind, []).append(t / len(cs))
            if widened is not None:
                t = timed(lambda: widened.apply_updates(name, ps))
                times["widened"].setdefault(kind, []).append(t / len(ps))
    reeval_s = []
    for ps in pairs:
        for p in ps:
            reeval_s.append(timed(lambda: ree.apply_update(name, *p)))
    got = launches()
    d = {k: v - stats0[k] for k, v in vars(eng.stats).items()
         if isinstance(v, int)}
    firings = sum(len(cs) if kind != "batch" else 1 for kind, cs in steps)
    if d["rowlocal_firings"] != firings or d["widened_carriers"] != 0:
        raise AssertionError(f"{label}: {d['rowlocal_firings']} row-local "
                             f"firings and {d['widened_carriers']} widened "
                             f"carriers in {firings} firings")
    if d["noop_skips"] != sum(kind == "batch" for kind, _ in steps):
        raise AssertionError(f"{label}: {d['noop_skips']} no-op skips")
    wide = (widened.stats.lowrank_applies - wide0) if widened else 0
    check_launches(label, got, {
        "rank_update_rows": d["row_applies"],
        "rank_update_batched": d["lowrank_applies"] + wide,
        "rank_update": len(reeval_s), "dual_matmul": 0})
    rel = check_views(label, eng.views, ree.views)
    rel_wide = check_views(label + " widened", widened.views, ree.views) \
        if widened is not None else None
    per_update = {path: {k: statistics.median(v) for k, v in ts.items()}
                  for path, ts in times.items() if ts}
    rec = {"phase": label, "firings": firings, "engine_counts": d,
           "launches": got, "rows_touched": {
               kind: [stack_carriers(cs).rows_touched] if kind == "batch"
               else [c.rows_touched for c in cs] for kind, cs in steps},
           "seconds_per_update_median": per_update,
           "reeval_engine_s_median": statistics.median(reeval_s),
           "rel_err_vs_reeval": rel, "rel_err_widened_vs_reeval": rel_wide,
           "tolerance": MAIN_TOL,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    return rec


def phase_compact() -> dict:
    """Phase 6: the left chain at n = 2^20 under row-local carriers."""
    import torch
    from repro_torch.core import IncrementalEngine, ReevalEngine
    from repro_torch.data import row_local_stream, zipf_row_stream
    n, m, k, rank = CHAIN_N, CHAIN_M, CHAIN_K, CHAIN_RANK
    g = torch.Generator(device=DEVICE).manual_seed(0)
    # made on the card: the engines copy them
    inputs = {"X": torch.randn(n, m, device=DEVICE, generator=g),
              "W1": torch.randn(m, k, device=DEVICE, generator=g) / m ** 0.5,
              "W2": torch.randn(k, k, device=DEVICE, generator=g) / k ** 0.5}
    prog = chain_program(n, m, k)
    eng = IncrementalEngine(prog, {"X": rank})
    wide = IncrementalEngine(prog, {"X": rank})
    ree = ReevalEngine(prog)
    t0 = time.perf_counter()
    for e in (eng, wide, ree):
        e.initialize(inputs)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    del inputs
    s = row_local_stream(n, CHAIN_ROWS, m=m, rank=rank, seed=1)
    z = zipf_row_stream(n, m, 1.5, seed=2, rows_touched=CHAIN_ROWS)
    steps = [("single", [s.next_carrier() for _ in range(8)]),
             ("batch", [s.next_carrier() for _ in range(16)]),
             ("zipf", [z.next_carrier() for _ in range(8)])]
    rec = drive_carriers(f"rowlocal_compact_chain_n{n}_m{m}_K{k}", eng, ree,
                         "X", steps, widened=wide)
    rec["initialize_s"] = init_s
    rec["compact"] = all(fn.compact for fn in eng._rowlocal_fns.values())
    if not rec["compact"]:
        raise AssertionError("the chain's row-local trigger is not compact")
    return rec


def phase_mixed() -> dict:
    """Phase 7: the general iterative form under 100-row carriers on A."""
    import torch
    from repro_torch.apps import GeneralIterative
    from repro_torch.data import row_local_stream
    app = GeneralIterative(n=GI_N, p=GI_P, k=GI_K, model="exp", with_b=True)
    t0 = time.perf_counter()
    app.initialize(GeneralIterative.synthesize(GI_N, GI_P, seed=0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    s = row_local_stream(GI_N, GI_ROWS, m=GI_N, rank=1, seed=3)
    steps = [("single", [s.next_carrier() for _ in range(8)]),
             ("batch", [s.next_carrier() for _ in range(8)])]
    rec = drive_carriers(f"rowlocal_mixed_general_n{GI_N}_p{GI_P}_k{GI_K}",
                         app.engine, app.reeval, "A", steps)
    rec["initialize_s"] = init_s
    fns = app.engine._rowlocal_fns.values()
    rec["row_views_per_firing"] = sorted({fn.row_applies for fn in fns})
    if any(fn.compact for fn in fns) or not all(fn.row_applies and
                                                fn.dense_applies
                                                for fn in fns):
        raise AssertionError("the general form's row-local trigger is not "
                             "mixed")
    return rec


def phase_apps() -> list:
    """Phase 8: the other four paper apps at n = 10000, dense path."""
    import torch
    from repro_torch.apps import (BatchGradientDescent, GeneralIterative,
                                  PageRank, SumsOfPowers)
    from repro_torch.data import UpdateStream
    n = APP_N
    recs = []

    def run(label, make, inputs, stream_of):
        app = make()
        stream = stream_of(app)
        recs.append(drive(label, app, inputs, stream, APP_UPDATES))
        del app
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    run(f"sums_of_powers_n{n}_k16_exp",
        lambda: SumsOfPowers(n=n, k=16, model="exp"),
        SumsOfPowers.synthesize(n, seed=0),
        lambda app: UpdateStream(n=n, m=n, seed=4))
    run(f"gradient_descent_m{n}_n{n}_p1000_k16_linear",
        lambda: BatchGradientDescent(m=n, n=n, p=1000, k=16,
                                     model="linear"),
        BatchGradientDescent.synthesize(n, n, 1000, seed=0),
        lambda app: UpdateStream(n=n, m=n, seed=5))
    pr = PageRank.synthesize(n, seed=0)
    run(f"pagerank_n{n}_k16_linear", lambda: PageRank(n=n, k=16), pr,
        lambda app: EdgeStream(app, n, seed=6))
    run(f"general_iterative_n{n}_p{GI_P}_k16_exp",
        lambda: GeneralIterative(n=n, p=GI_P, k=16, model="exp"),
        GeneralIterative.synthesize(n, GI_P, seed=0),
        lambda app: UpdateStream(n=n, m=n, seed=7))
    return recs


def phase_sherman_morrison(w, calls: int = 4) -> dict:
    """Phase 9: ops.sherman_morrison_delta on OLS's W through the dual
    kernel, against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(8)
    n = w.shape[0]
    uvs = [tuple(torch.tensor(rng.normal(size=n).astype(np.float32),
                              device=DEVICE) for _ in range(2))
           for _ in range(calls)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = [ops.sherman_morrison_delta(w, u, v) for u, v in uvs]
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / calls
    got = launches()
    check_launches("sherman_morrison", got, {
        "dual_matmul": calls, "rank_update_batched": 0, "rank_update": 0,
        "rank_update_rows": 0})
    err = 0.0
    for (u, v), (l, r) in zip(uvs, outs):
        wl, wr = ref.sherman_morrison_delta(w, u, v)
        err = max(err, check_close("sherman_morrison L", l, wl),
                  check_close("sherman_morrison R", r, wr))
    rec = {"phase": f"sherman_morrison_w{n}", "calls": calls,
           "launches": got, "seconds_per_call": seconds,
           "max_abs_err": err}
    log("main " + json.dumps(rec))
    return rec


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.apps import OLS, MatrixPowers
    from repro_torch.data import UpdateStream
    from repro_torch.kernels import cuda_build

    # 1. device
    smi = nvidia_smi()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    part, flops_peak, bytes_peak = peaks(kind)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {kind}; peaks from the {part} data sheet: "
        f"{flops_peak / 1e12} TFLOP/s fp32, {bytes_peak / 1e12} TB/s")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    build_s = cuda_build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{json.dumps(build_s)}")
    for name, text in sorted(cuda_build.BUILD_LOGS.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # 3. kernels
    shapes = check_kernels(flops_peak, bytes_peak)

    # 4. matrix powers at the paper's size; 5. OLS at the paper's n range
    n = 10000
    phases = [drive("matrix_powers_n10000_k16_exp",
                    MatrixPowers(n=n, k=16, model="exp"),
                    MatrixPowers.synthesize(n, seed=0),
                    UpdateStream(n=n, m=n, seed=1))]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m_rows, n_cols = 16384, 8192
    inputs, _ = OLS.synthesize(m_rows, n_cols, 1, seed=0)
    ols = OLS(m_rows, n_cols, 1)
    phases.append(drive("ols_m16384_n8192_p1", ols, inputs,
                        UpdateStream(n=m_rows, m=n_cols, seed=1)))
    w = ols.engine.views["W"]
    del ols, inputs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 6.-7. row-local carriers; 8. the other apps; 9. Sherman-Morrison
    phases.append(phase_compact())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phases.append(phase_mixed())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phases.extend(phase_apps())
    phases.append(phase_sherman_morrison(w))

    # the kernels record: per entry, the main path's launches and the
    # numbers of its headline shape (the most common apply of the path)
    headline = {"rank_update_batched": (10000, 10000, 1, 16),
                "rank_update": (10000, 10000, 1, 1),
                "rank_update_rows": (CHAIN_N, CHAIN_M, CHAIN_ROWS,
                                     CHAIN_RANK),
                "dual_matmul": (8192, 8192, 1)}
    kernels = []
    for entry, recs in shapes.items():
        head = next(r for r in recs
                    if tuple(r[k] for k in r if k in
                             ("n", "p", "m", "T", "r", "k"))
                    == headline[entry])
        kernels.append({
            "name": entry, "route": "cuda", "source": SOURCES[entry],
            "replaces": REPLACES[entry],
            "launches": sum(ph["launches"][entry] for ph in phases),
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": {k: v for k, v in head.items()
                      if k in ("n", "p", "m", "T", "r", "k")}})
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
