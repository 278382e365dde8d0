#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each of which raises on failure:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build: compile the rank-update CUDA kernel from the checkout's source.
3. kernels: every CUDA entry against its plain PyTorch version on the card,
   at the main path's shapes plus a ragged shape and a T > 1 stack, with
   kernel, plain, library (``addmm``) and bound times.
4. matrix powers A^16 (n = 10000, exp model, the paper's size): 8 single
   updates, one batch of 16, 20 queued updates with a final flush, all
   replayed through the re-evaluation engine and compared view by view;
   the kernel launch counts must equal the number of low-rank applies.
5. OLS (m = 16384, n = 8192, p = 1): the same sequence.

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

# fp32 (non-tensor-core) peak and memory rate per part, from NVIDIA's data
# sheets at the part's full power limit: (name match, TFLOP/s, TB/s).
PEAKS = (("H100 PCIe", 51.0, 2.0), ("H100 NVL", 60.0, 3.9),
         ("H100", 67.0, 3.35))


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


def bound(n: int, p: int, K: int, flops_peak: float, bytes_peak: float):
    """Least time (ms) for M (n,p) += U (n,K) V (p,K)^T: M read and
    written once, each factor read once; 2 n p K FLOPs."""
    nbytes = 8.0 * n * p + 4.0 * K * (n + p)
    t_bytes = nbytes / bytes_peak * 1e3
    t_ops = 2.0 * n * p * K / flops_peak * 1e3
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


# -- phase 3 ------------------------------------------------------------------

def check_kernels(flops_peak: float, bytes_peak: float):
    """Each CUDA entry against its plain version at the given shapes.
    Returns {entry: [per-shape records]}."""
    import torch
    from repro_torch.kernels import rank_update as cuda_ru
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    # (n, p, T, k): the main path's applies (matrix powers views, OLS X and
    # Z/W), a ragged shape, and T > 1 stacks
    batched_cases = [(10000, 10000, 1, K) for K in (1, 16, 64, 256)] + [
        (8192, 8192, 1, 2), (8192, 8192, 1, 32),
        (16384, 8192, 1, 1), (16384, 8192, 1, 16),
        (37, 101, 1, 5), (1000, 777, 4, 3), (10000, 10000, 16, 1)]
    single_cases = [(10000, 10000, 1), (16384, 8192, 1), (37, 101, 5)]

    out = {"rank_update_batched": [], "rank_update": []}
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
        if not torch.isfinite(got).all():
            raise AssertionError(f"{entry} {(n, p, t, k)}: non-finite output")
        err = float((got - want).abs().max())
        worst = float(((got - want).abs()
                       - KERNEL_RTOL * want.abs()).max())
        if worst > KERNEL_ATOL:
            raise AssertionError(
                f"{entry} {(n, p, t, k)}: max abs err {err} exceeds "
                f"atol {KERNEL_ATOL} + rtol {KERNEL_RTOL} |want|")
        del want, got
        work = m0.clone()
        ms = time_ms(lambda: kernel(work, *args))
        plain_ms = time_ms(lambda: plain(m0, *args))
        lib_ms = time_ms(lambda: work.addmm_(u2, v2.T))
        b_ms, b_by = bound(n, p, K, flops_peak, bytes_peak)
        rec = {"entry": entry, "n": n, "p": p, "T": t, "k": k,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
        log("kernel " + json.dumps(rec))
        out[entry].append(rec)
        del m0, u, v, u2, v2, work
    torch.cuda.empty_cache()
    return out


# -- phases 4 and 5 -----------------------------------------------------------

def drive(label: str, app, inputs, stream) -> dict:
    """Drive one app's engine through all three update paths, replay the
    same updates through its re-evaluation engine, and hold every view
    against it.  Returns the phase's record, launch counts included."""
    import torch
    from repro_torch.kernels import rank_update as cuda_ru

    eng, ree, name = app.engine, app.reeval, app.update_input
    t0 = time.perf_counter()
    app.initialize(inputs)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    total = UPDATES_SINGLE + UPDATES_BATCH + UPDATES_QUEUED
    ups = [stream.next_update() for _ in range(total)]
    single = ups[:UPDATES_SINGLE]
    batch = ups[UPDATES_SINGLE:UPDATES_SINGLE + UPDATES_BATCH]
    queued = ups[UPDATES_SINGLE + UPDATES_BATCH:]

    torch.cuda.synchronize()
    cuda_ru.reset_launches()
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
    launches = dict(cuda_ru.LAUNCHES)

    expect = {"rank_update_batched": applies,
              "rank_update": total}
    if launches != expect:
        raise AssertionError(f"{label}: kernel launches {launches} != "
                             f"low-rank applies {expect}")
    rel = {}
    for view, want in ree.views.items():
        got = eng.views[view]
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{label}: view {view} is {tuple(got.shape)}"
                                 f" or non-finite")
        scale = float(want.abs().max()) or 1.0
        rel[view] = float((got - want).abs().max()) / scale
        if rel[view] > MAIN_TOL:
            raise AssertionError(f"{label}: view {view} differs from "
                                 f"re-evaluation by {rel[view]} > {MAIN_TOL}")
    eng.reevaluate(block=True)
    rec = {"phase": label, "views": {k: list(v.shape)
                                     for k, v in eng.views.items()},
           "initialize_s": init_s, "firings": firings,
           "lowrank_applies": applies, "launches": launches,
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
    from repro_torch.kernels import rank_update as cuda_ru

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
    build_s = cuda_ru.build()
    log(f"build: {build_s:.2f} s")
    for line in cuda_ru.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    # 3. kernels
    shapes = check_kernels(flops_peak, bytes_peak)

    # 4. matrix powers at the paper's size; 5. OLS at the paper's n range
    n = 10000
    mp = drive("matrix_powers_n10000_k16_exp",
               MatrixPowers(n=n, k=16, model="exp"),
               MatrixPowers.synthesize(n, seed=0),
               UpdateStream(n=n, m=n, seed=1))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m_rows, n_cols = 16384, 8192
    inputs, _ = OLS.synthesize(m_rows, n_cols, 1, seed=0)
    ols = drive("ols_m16384_n8192_p1", OLS(m_rows, n_cols, 1), inputs,
                UpdateStream(n=m_rows, m=n_cols, seed=1))

    # the kernels record: per entry, the main path's launches and the
    # numbers of its headline shape (the most common apply of the path)
    headline = {"rank_update_batched": (10000, 10000, 1, 16),
                "rank_update": (10000, 10000, 1, 1)}
    replaces = {
        "rank_update_batched": "src/repro/kernels/rank_update.py:84",
        "rank_update": "src/repro/kernels/rank_update.py:40"}
    kernels = []
    for entry, recs in shapes.items():
        head = next(r for r in recs
                    if (r["n"], r["p"], r["T"], r["k"]) == headline[entry])
        kernels.append({
            "name": entry, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rank_update.cu",
            "replaces": replaces[entry],
            "launches": mp["launches"][entry] + ols["launches"][entry],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": {"n": head["n"], "p": head["p"], "T": head["T"],
                      "k": head["k"]}})
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
