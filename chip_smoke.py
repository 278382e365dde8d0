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
   kernel, plain, library and bound times, the achieved fp32 TFLOP/s and
   the kernel's time over the library call's (the dense kernel at every K
   of matrix powers' batch of 16); the flash kernels at danube's
   and starcoder2's attention shapes, windowed, ragged, bf16 and f32 (the
   prefill kernel's records with its achieved TFLOP/s and share of the
   bf16 tensor-core peak); the row kernel also cold (rotating RowSets),
   by the profiler, and its host time; the dual kernel and the library
   pair by the profiler and their host times.
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
   W (8192 x 8192) from phase 5: the first call's seconds apart from the
   median of the warm ones, and the dual kernels' device time a call.
10. serve_danube_full: h2o-danube-1.8b at its published width and depth
    (24 layers, d_model 2560, bf16, random weights from a seed) on
    ``ServeEngine``: 8 prompts of 4096 tokens, prefill, 32 greedy decode
    steps (positions 4096-4127 wrap the 4096-slot ring); prefill ms, decode
    ms per step, tokens/s, the decode step's byte bound, peak memory; the
    flash kernels checked again on layer 0's real q/k/v; one more prefill
    and two decode steps under ``torch.profiler`` (device time, idle share,
    and the bf16 tensor-core attention kernel's time and launches).
11. serve_danube_f32_exact: the same widths in f32 at 4 layers; every
    decode step's logits against ``forward``'s at its position over the
    whole 4128-token sequence (window mask in the prefill kernel against
    the wrapped ring in the decode kernel), greedy tokens against
    ``forward``'s argmax.
12. the incremental logit view Y = H W^T over phase 10's final-norm hidden
    states (32768 x 2560) and lm_head (32000 x 2560): 8 rank-1 hot-swaps
    through ``ServeEngine`` and a flush, against H W'^T recomputed.

Every launch count is set to 0 just before a phase drives its engines and
read just after; the counts of each kernel must equal the applies (or
calls) the phase made.

The last two lines of standard output are the ``{"kernels": [...]}``
record (``rank_update_batched``'s with its launches over phases 4-9 and 12
by K = T*k) and ``{"ok": true, "device": {...}}``.  Without CUDA, or outside a
checkout, the script prints no result and exits non-zero.
"""

from __future__ import annotations

import itertools
import json
import re
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
# phase 3's cold row timings rotate over at least this many RowSets, and
# over enough to touch twice the H100's 50 MB L2 where the view is large
ROW_COLD_SETS, L2_BYTES = 8, 50 * 2 ** 20
# the four apps of phase 8 run at n = 10000 with fewer updates, to keep
# the script short
APP_N, APP_UPDATES = 10000, (4, 8, 8)

# phase 6: the left chain of benchmarks/bench_sparse.py at its widths
# (m = 384, K = 256, rank-8 carriers, 1 % of rows), n raised to 2^20
CHAIN_N, CHAIN_M, CHAIN_K, CHAIN_RANK = 2 ** 20, 384, 256, 8
CHAIN_ROWS = CHAIN_N // 100
# phase 7: the general iterative form under 100-row carriers on A
GI_N, GI_P, GI_K, GI_ROWS = 10000, 128, 16, 100

# phases 10-12: h2o-danube-1.8b serving (arXiv:2401.16818)
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "h2o-danube-1.8b", 8, \
    4096, 32
EXACT_LAYERS = 4            # phase 11's depth, cut from 24
HOT_SWAPS = 8               # phase 12's rank-1 head deltas

# Tolerance of an attention kernel against its plain version.  f32: the
# kernel tolerance above.  bf16: the plain versions keep p in f32, the
# decode kernel too, and the prefill kernel carries p as two bf16 terms
# (about 2^-17 |p|); each output is rounded once to bf16, so they differ
# by at most one rounding step, <= 2**-7 |x|.
ATTN_TOL = {"float32": (KERNEL_RTOL, KERNEL_ATOL), "bfloat16": (1e-2, 1e-3)}
# Phase 11's end-to-end tolerance, |decode - forward| <= ATOL + RTOL |fwd|
# on every logit: the repo's serving tolerance (tests/test_serve.py:40).
SERVE_RTOL = SERVE_ATOL = 1e-4

# fp32 (non-tensor-core) peak, memory rate and dense bf16 tensor-core peak
# per part, from NVIDIA's data sheets at the part's full power limit:
# (name match, fp32 TFLOP/s, TB/s, bf16 TFLOP/s).
PEAKS = (("H100 PCIe", 51.0, 2.0, 756.0), ("H100 NVL", 60.0, 3.9, 835.0),
         ("H100", 67.0, 3.35, 989.0))

SOURCES = {
    "rank_update_batched": "src/repro_torch/kernels/csrc/rank_update.cu",
    "rank_update": "src/repro_torch/kernels/csrc/rank_update.cu",
    "rank_update_rows": "src/repro_torch/kernels/csrc/rank_update_rows.cu",
    "dual_matmul": "src/repro_torch/kernels/csrc/dual_matmul.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu"}
# the bf16 prefill kernel's name in csrc/flash_attention.cu, as the
# profiler lists it
FLASH_BF16_KERNEL = "flash_attention_bf16_mma"
REPLACES = {
    "rank_update_batched": "src/repro/kernels/rank_update.py:84",
    "rank_update": "src/repro/kernels/rank_update.py:40",
    "rank_update_rows": "src/repro/kernels/rank_update_rows.py:50",
    "dual_matmul": "src/repro/kernels/dual_matmul.py:45",
    "flash_attention": "src/repro/kernels/flash_attention.py:77",
    "flash_decode": "src/repro/kernels/flash_decode.py:69"}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def peaks(name: str):
    for key, tflops, tbs, bf16 in PEAKS:
        if key in name:
            return key, tflops * 1e12, tbs * 1e12, bf16 * 1e12
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


def ptxas_lines(text: str):
    """(kernel instance, line) for each register and spill line of
    ``ptxas -v`` output; the instance is its mangled name shortened."""
    entry = "?"
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            entry = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_"
                           r"[0-9a-f]{8}(?:\d+tc)?\d+|^_Z\d+", "",
                           found.group(1)).split("EEv")[0]
        elif "registers" in line or "spill" in line:
            yield entry, line.strip()


def kernel_modules():
    from repro_torch.kernels import (dual_matmul, flash_attention,
                                     flash_decode, rank_update,
                                     rank_update_rows)
    return (rank_update, rank_update_rows, dual_matmul, flash_attention,
            flash_decode)


def reset_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


def launches() -> dict:
    out = {}
    for mod in kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def dense_ranks() -> dict:
    """rank_update_batched's launches since the last reset, by K = T*k."""
    from repro_torch.kernels import rank_update
    return dict(sorted(rank_update.RANKS["rank_update_batched"].items()))


def check_launches(label: str, got: dict, expect: dict) -> None:
    """Every kernel's launches equal ``expect``'s count (0 if not named)."""
    expect = {**{name: 0 for name in got}, **expect}
    if got != expect:
        raise AssertionError(f"{label}: kernel launches {got} != the "
                             f"phase's applies {expect}")


def check_close(label: str, got, want, rtol: float = KERNEL_RTOL,
                atol: float = KERNEL_ATOL) -> float:
    """Raise unless |got - want| <= atol + rtol |want|; max abs err."""
    import torch
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: shape {tuple(got.shape)} or "
                             "non-finite output")
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    worst = float(((got - want).abs() - rtol * want.abs()).max()) \
        if got.numel() else 0.0
    if worst > atol:
        raise AssertionError(f"{label}: max abs err {err} exceeds atol "
                             f"{atol} + rtol {rtol} |want|")
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
    cuda_ru, cuda_rows, cuda_dual = kernel_modules()[:3]

    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen)

    def record(entry, shape, err, ms, plain_ms, lib_ms, nbytes, flops,
               **times):
        b_ms, b_by = bound(nbytes, flops, flops_peak, bytes_peak)
        # achieved fp32 rate, and the kernel's time over the library call's
        rec = {"entry": entry, **shape, "max_abs_err": err, "ms": ms,
               **times, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "tflops": flops / (ms * 1e-3) / 1e12,
               "vs_library": ms / lib_ms}
        log("kernel " + json.dumps(rec))
        out[entry].append(rec)

    out = {name: [] for name in SOURCES}

    # (n, p, T, k): the main path's applies (matrix powers' views at every K
    # of a batch of 16, OLS X and Z/W), a ragged shape, and T > 1 stacks
    batched_cases = [(10000, 10000, 1, K)
                     for K in (1, 16, 32, 64, 128, 256)] + [
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
    # to A and S2 and to T1 (one carrier, a batch of 8), a ragged shape.
    # ms and device_ms are warm: every launch on the same rows, which stay
    # in L2 where they fit.  cold_ms and cold_device_ms rotate over
    # ROW_COLD_SETS or more RowSets with their own blocks, touching at least
    # twice the L2 where the view is large enough, as the engine's carriers
    # touch other rows every firing.  device_ms is the profiler's kernel
    # time, host_us the binding's enqueue time: where the kernel is shorter
    # than the host's work, ms is the host's.
    rng = np.random.default_rng(0)
    row_cases = [(CHAIN_N, CHAIN_M, CHAIN_ROWS, CHAIN_RANK),
                 (CHAIN_N, CHAIN_K, CHAIN_ROWS, CHAIN_RANK),
                 (CHAIN_N, CHAIN_M, 15 * CHAIN_ROWS, 16 * CHAIN_RANK),
                 (GI_N, GI_N, GI_ROWS, 1), (GI_N, GI_P, GI_ROWS, 1),
                 (GI_N, GI_N, 8 * GI_ROWS, 8), (37, 101, 5, 3)]
    for n, p, r, k in row_cases:
        m0 = randn(n, p)
        v = randn(p, k)
        count = max(ROW_COLD_SETS,
                    min(64, -(-2 * L2_BYTES // (4 * r * p))))
        sets = [(cuda_rows.RowSet(np.sort(rng.choice(n, r, replace=False)),
                                  n), randn(r, k)) for _ in range(count)]
        for rs, _ in sets:   # each set's ids uploaded before any timing
            rs.ids(m0.device)
        rows, block = sets[0]
        idx = rows.index(DEVICE)
        want = ref.rank_update_rows(m0, idx, block, v)
        got = cuda_rows.rank_update_rows(m0.clone(), rows, block, v)
        torch.cuda.synchronize()
        err = check_close(f"rank_update_rows {(n, p, r, k)}", got, want)
        del want, got
        work = m0.clone()
        turn = itertools.count()

        def warm():
            cuda_rows.rank_update_rows(work, rows, block, v)

        def cold():
            cuda_rows.rank_update_rows(work, *sets[next(turn) % count], v)

        ms = time_ms(warm)
        times = {"cold_ms": time_ms(cold),
                 "device_ms": device_ms_per_call(warm, reps=40)[1],
                 "cold_device_ms": device_ms_per_call(cold, reps=40)[1],
                 "host_us": host_us(warm), "cold_sets": count}
        plain_ms = time_ms(lambda: ref.rank_update_rows(m0, idx, block, v))
        lib_ms = time_ms(lambda: work.index_add_(0, idx, block @ v.T))
        record("rank_update_rows", {"n": n, "p": p, "r": r, "k": k}, err, ms,
               plain_ms, lib_ms, 8.0 * r * p + 4.0 * k * (r + p) + 4.0 * r,
               2.0 * r * p * k, **times)
        del m0, v, sets, rows, block, work

    # (n, m, k): phase 9's W (8192^2, k = 1) and ragged shapes.  device_ms
    # is the union of the kernels' intervals under the profiler (the final
    # sum is a programmatic dependent launch), kernel_sum_ms their summed
    # time, host_us the binding's enqueue time; where the kernels take less
    # than the host, ms (events) reads the host.  The same for the library
    # pair.
    for n, m, k in [(8192, 8192, 1), (1000, 777, 5), (37, 101, 1)]:
        a = randn(n, m)
        u = randn(m, k)
        v = randn(n, k)
        got = cuda_dual.dual_matmul(a, u, v)
        want = ref.dual_matmul(a, u, v)
        torch.cuda.synchronize()
        err = max(check_close(f"dual_matmul {(n, m, k)} {name}", g, w)
                  for name, g, w in zip("PQ", got, want))

        def kernel():
            cuda_dual.dual_matmul(a, u, v)

        def library():
            return a @ u, a.T @ v

        ms = time_ms(kernel)
        plain_ms = time_ms(lambda: ref.dual_matmul(a, u, v))
        lib_ms = time_ms(library)
        busy, summed = device_ms_per_call(kernel, "dual_", reps=40)
        lib_busy, lib_summed = device_ms_per_call(library, reps=40)
        record("dual_matmul", {"n": n, "m": m, "k": k}, err, ms, plain_ms,
               lib_ms, 4.0 * n * m + 4.0 * k * (2 * n + 2 * m),
               4.0 * n * m * k, device_ms=busy, kernel_sum_ms=summed,
               host_us=host_us(kernel), library_device_ms=lib_busy,
               library_kernel_sum_ms=lib_summed,
               library_host_us=host_us(library))
        del a, u, v, got, want
    torch.cuda.empty_cache()
    return out


# -- phase 3, the flash kernels -------------------------------------------------

def attention_pairs(s: int, causal: bool, window) -> int:
    """Query-key pairs the mask keeps over a length-s sequence."""
    import numpy as np
    qp = np.arange(s, dtype=np.int64)
    hi = qp if causal else np.full(s, s - 1, dtype=np.int64)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(s, np.int64)
    return int((hi - lo + 1).sum())


def attention_record(entry, shape, err, ms, plain_ms, lib_ms, nbytes, flops,
                     dtype, bytes_peak, flops_peak, bf16_peak,
                     log_it=True) -> dict:
    """A kernel record whose operations bound is taken at the peak of the
    inputs' type (bf16 tensor cores, or fp32 FMA); the fp32 bound is kept
    beside it."""
    peak = bf16_peak if dtype == "bfloat16" else flops_peak
    b_ms, b_by = bound(nbytes, flops, peak, bytes_peak)
    rec = {"entry": entry, **shape, "dtype": dtype, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_fp32_ms": bound(nbytes, flops, flops_peak, bytes_peak)[0],
           "flops": flops, "bytes": nbytes}
    if entry == "flash_attention":
        # achieved rate: the tensor cores are in use above the fp32 peak
        rec["tflops"] = flops / (ms * 1e-3) / 1e12
        rec["bf16_peak_frac"] = flops / (ms * 1e-3) / bf16_peak
    if log_it:
        log("kernel " + json.dumps(rec))
    return rec


def check_flash_attention(q, k, v, causal, window, peaks_, label,
                          timed=True) -> dict:
    """The flash-attention kernel against its plain version (and timed
    against it and SDPA) on q (B,S,H,hd), k/v (B,S,KV,hd)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as cuda_fa
    from repro_torch.kernels import ref
    b, s, h, hd = q.shape
    dtype = str(q.dtype).replace("torch.", "")
    got = cuda_fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = check_close(f"flash_attention {label}", got, want,
                      *ATTN_TOL[dtype])
    del got, want
    shape = {"b": b, "s": s, "h": h, "kvh": k.shape[2], "hd": hd,
             "causal": causal, "window": window, "case": label}
    if not timed:
        return {"case": label, "max_abs_err": err}
    ms = time_ms(lambda: cuda_fa.flash_attention(q, k, v, causal=causal,
                                                  window=window))
    plain_ms = time_ms(lambda: ref.flash_attention(q, k, v, causal=causal,
                                                   window=window))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if window is not None and window < s:
        pos = torch.arange(s, device=q.device)
        mask = ref.attention_keep(pos, pos, causal=causal, window=window)
        # SDPA's fused kernels take no mask under enable_gqa (its math
        # path would build every score), so give it the expanded heads
        kt, vt = (x.repeat_interleave(h // k.shape[2], dim=1)
                  for x in (kt, vt))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=mask is None))
    del kt, vt
    item = q.element_size()
    nbytes = item * (2 * q.numel() + 2 * k.numel())
    flops = 4.0 * b * h * hd * attention_pairs(s, causal, window)
    return attention_record("flash_attention", shape, err, ms, plain_ms,
                            lib_ms, nbytes, flops, dtype, *peaks_)


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds per call of ``fn``: the time to enqueue ``reps``
    calls back to back (the card drains them afterwards)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


def device_ms_per_call(fn, match=None, reps: int = 20):
    """(busy, summed) device ms per call of ``fn`` from ``torch.profiler``:
    the union of the intervals of the kernels whose names hold ``match``
    (else of all kernels), and the sum of their times; None when the
    profiler saw no device activity."""
    prof = device_profile(lambda: [fn() for _ in range(reps)],
                          match=(match,) if match else ())
    if prof["device_ms"] is None:
        return None, None
    if match:
        summed, _, busy = prof["match"][match]
    else:
        summed, busy = prof["device_ms"], prof["busy_ms"]
    return busy / reps, summed / reps


def check_flash_decode(q, kc, vc, n_valid, peaks_, label,
                       timed=True) -> dict:
    """The flash-decode kernel against its plain version, with n_valid as
    an int and as a device tensor (the decode step's form; the two agree
    bit for bit, and so do repeated calls), and timed against the plain
    version and SDPA: CUDA events over back-to-back calls (``ms``), the
    profiler's kernel time (``device_ms``) and the host's enqueue time
    (``host_us``), the last two for SDPA as well."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as cuda_fd
    from repro_torch.kernels import ref
    b, h, hd = q.shape
    dtype = str(q.dtype).replace("torch.", "")
    n_t = torch.tensor(n_valid, dtype=torch.int32, device=q.device)
    got = cuda_fd.flash_decode(q, kc, vc, n_t)
    want = ref.flash_decode(q, kc, vc, n_valid)
    torch.cuda.synchronize()
    err = check_close(f"flash_decode {label}", got, want, *ATTN_TOL[dtype])
    for again in (cuda_fd.flash_decode(q, kc, vc, n_valid),
                  cuda_fd.flash_decode(q, kc, vc, n_t)):
        if not torch.equal(again, got):
            raise AssertionError(f"flash_decode {label}: two calls differ")
    del got, want
    if not timed:
        return {"case": label, "max_abs_err": err}
    shape = {"b": b, "L": kc.shape[1], "h": h, "kvh": kc.shape[2], "hd": hd,
             "n_valid": n_valid, "case": label}

    def kernel():
        return cuda_fd.flash_decode(q, kc, vc, n_t)

    qt = q[:, :, None]
    kt, vt = (x[:, :n_valid].transpose(1, 2) for x in (kc, vc))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)

    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: ref.flash_decode(q, kc, vc, n_t))
    lib_ms = time_ms(library)
    item = q.element_size()
    nbytes = item * (2 * q.numel() + 2 * b * n_valid * kc.shape[2] * hd)
    flops = 4.0 * b * h * hd * n_valid
    rec = attention_record("flash_decode", shape, err, ms, plain_ms, lib_ms,
                           nbytes, flops, dtype, *peaks_, log_it=False)
    busy, summed = device_ms_per_call(kernel, "flash_decode")
    lib_busy, lib_summed = device_ms_per_call(library)
    rec.update({"device_ms": busy, "kernel_sum_ms": summed,
                "host_us": host_us(kernel), "library_device_ms": lib_busy,
                "library_kernel_sum_ms": lib_summed,
                "library_host_us": host_us(library)})
    log("kernel " + json.dumps(rec))
    return rec


def check_flash_kernels(peaks_) -> dict:
    """Phase 3's flash cases: danube's prefill (B=8, S=4096, H=32, KV=8,
    hd=80, its 4096 window) in bf16 and, at phase 11's ragged 4128, in
    bf16 and f32; starcoder2's heads (H=36, KV=4, hd=128); a window
    shorter than S; a ragged S; decode over danube's 4096-slot ring at n_valid 1, 2049 and
    4096 (a wrapped ring is full), bf16 and f32, and starcoder2's."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(*shape, device=DEVICE, generator=gen).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    out = {"flash_attention": [], "flash_decode": []}
    # (label, b, s, h, kvh, hd, window, dtype)
    for label, b, s, h, kvh, hd, window, dt in [
            ("danube_prefill_bf16", 8, 4096, 32, 8, 80, 4096, bf16),
            ("danube_prefill_bf16_s4128", 8, 4128, 32, 8, 80, 4096, bf16),
            ("danube_prefill_f32_s4128", 8, 4128, 32, 8, 80, 4096, f32),
            ("starcoder2_bf16", 2, 4096, 36, 4, 128, None, bf16),
            ("window1024_bf16", 2, 4096, 32, 8, 80, 1024, bf16),
            ("ragged_s1000_bf16", 2, 1000, 32, 8, 80, None, bf16)]:
        q = randn(b, s, h, hd, dtype=dt)
        k, v = randn(b, s, kvh, hd, dtype=dt), randn(b, s, kvh, hd, dtype=dt)
        out["flash_attention"].append(check_flash_attention(
            q, k, v, True, window, peaks_, label))
        del q, k, v
        torch.cuda.empty_cache()
    # (label, b, L, h, kvh, hd, n_valid, dtype)
    for label, b, L, h, kvh, hd, n_valid, dt in [
            ("danube_decode_bf16_n1", 8, 4096, 32, 8, 80, 1, bf16),
            ("danube_decode_bf16_n2049", 8, 4096, 32, 8, 80, 2049, bf16),
            ("danube_decode_bf16_wrapped", 8, 4096, 32, 8, 80, 4096, bf16),
            ("danube_decode_f32_wrapped", 8, 4096, 32, 8, 80, 4096, f32),
            ("starcoder2_decode_bf16", 8, 4096, 36, 4, 128, 4096, bf16)]:
        q = randn(b, h, hd, dtype=dt)
        kc, vc = (randn(b, L, kvh, hd, dtype=dt) for _ in range(2))
        out["flash_decode"].append(check_flash_decode(
            q, kc, vc, n_valid, peaks_, label))
        del q, kc, vc
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
    got, ranks = launches(), dense_ranks()
    check_launches(label, got, {"rank_update_batched": applies,
                                "rank_update": total,
                                "rank_update_rows": 0, "dual_matmul": 0})
    rel = check_views(label, eng.views, ree.views)
    eng.reevaluate(block=True)
    rec = {"phase": label, "views": {k: list(v.shape)
                                     for k, v in eng.views.items()},
           "initialize_s": init_s, "firings": firings,
           "lowrank_applies": applies, "launches": got,
           "dense_ranks": ranks,
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
    got, ranks = launches(), dense_ranks()
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
           "launches": got, "dense_ranks": ranks, "rows_touched": {
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
    outs, seconds = [], []
    for u, v in uvs:
        t0 = time.perf_counter()
        outs.append(ops.sherman_morrison_delta(w, u, v))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    got = launches()
    check_launches("sherman_morrison", got, {
        "dual_matmul": calls, "rank_update_batched": 0, "rank_update": 0,
        "rank_update_rows": 0})
    err = 0.0
    for (u, v), (l, r) in zip(uvs, outs):
        wl, wr = ref.sherman_morrison_delta(w, u, v)
        err = max(err, check_close("sherman_morrison L", l, wl),
                  check_close("sherman_morrison R", r, wr))
    # after the counted calls: the dual kernels' device time a call (the
    # union of their intervals) and the whole call's, by the profiler
    u, v = uvs[-1]
    dual_ms = device_ms_per_call(
        lambda: ops.sherman_morrison_delta(w, u, v), "dual_", reps=10)[0]
    call_ms = device_ms_per_call(
        lambda: ops.sherman_morrison_delta(w, u, v), reps=10)[0]
    rec = {"phase": f"sherman_morrison_w{n}", "calls": calls,
           "launches": got, "seconds_per_call": sum(seconds) / calls,
           "first_call_s": seconds[0],
           "warm_median_s": statistics.median(seconds[1:]),
           "dual_device_ms_per_call": dual_ms,
           "call_device_ms": call_ms, "max_abs_err": err}
    log("main " + json.dumps(rec))
    return rec


# -- phases 10-12: LM serving -----------------------------------------------------

def serve_engine(n_layers=None, dtype=None, seed=0):
    """A ServeEngine over h2o-danube-1.8b (random weights from ``seed``)
    for 8 prompts of 4096 tokens and 32 new ones."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine
    cfg = get_config(SERVE_ARCH)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                              dtype=dtype or cfg.dtype)
    model = LM(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(seed))
    return ServeEngine(model, params, batch_size=SERVE_BATCH,
                       max_seq=SERVE_PROMPT + SERVE_NEW)


def serve(eng, prompts):
    """Prefill and SERVE_NEW greedy decode steps through the engine's
    entry points; returns (last logits of the prefill, the logits of each
    step, the tokens, prefill seconds, seconds of each step)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = eng.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = eng.sample(last)
    steps, toks, step_s = [], [tok], []
    for _ in range(SERVE_NEW):
        t0 = time.perf_counter()
        logits = eng.decode(tok)
        tok = eng.sample(logits)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        steps.append(logits)
        toks.append(tok)
    return last, steps, torch.stack(toks, dim=1), prefill_s, step_s


def layer0_qkv(eng, tokens, pos0: int):
    """Layer 0's rope'd q, k, v (B, S, heads, hd) for ``tokens`` at
    positions pos0 .. pos0+S-1: the kernels' real inputs in this run."""
    import torch
    from repro_torch.models import attention, layers
    cfg, params = eng.model.cfg, eng.params
    bp = {name: {k: v[0] for k, v in leaf.items()}
          for name, leaf in params["blocks"].items()}
    tokens = torch.as_tensor(tokens, device=DEVICE).long()
    x = layers.rmsnorm(bp["ln1"], layers.embed(params["embed"], tokens),
                       cfg.norm_eps)
    q, k, v = attention._project_qkv(bp["attn"], cfg, x)
    pos = torch.arange(pos0, pos0 + tokens.shape[1], device=DEVICE)
    cos, sin = layers.rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta)
    return (layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin),
            v)


def flat_params(tree, prefix=""):
    """(dotted name, tensor) for every leaf of a param tree."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from flat_params(leaf, f"{prefix}{name}.")
        else:
            yield prefix + name, leaf


def busy_ms(events) -> float:
    """ms in which at least one of the kernel ``events`` ran: the union of
    their intervals (a kernel launched as a programmatic dependent starts
    while the one before it drains, so summed times count that twice)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def device_profile(fn, top: int = 8, match=()) -> dict:
    """Kernel time on the card for one call of ``fn``, by
    ``torch.profiler``: device ms (summed kernel time), busy ms (the union
    of the kernels' intervals), kernels launched, the kernels that took the
    most time, and [summed ms, launches, busy ms] of the kernels whose
    names hold each string of ``match``.  ``device_ms`` and ``busy_ms``
    are None when the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kern) / 1e3
    kern.sort(key=lambda e: -e.self_device_time_total)
    return {"device_ms": total if kern else None,
            "busy_ms": busy_ms(events) if kern else None,
            "kernels": sum(e.count for e in kern),
            "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                    for e in kern[:top]],
            "match": {m: [sum(e.self_device_time_total for e in kern
                              if m in e.key) / 1e3,
                          sum(e.count for e in kern if m in e.key),
                          busy_ms([e for e in events if m in e.name])]
                      for m in match}}


def phase_serve_full(peaks_):
    """Phase 10: h2o-danube-1.8b at published width and depth, bf16.
    Returns (record, engine, prompts) for phase 12."""
    import numpy as np
    import torch
    eng = serve_engine()
    cfg = eng.model.cfg
    prompts = np.random.default_rng(10).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    last, steps, toks, prefill_s, step_s = serve(eng, prompts)
    got = launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    label = "serve_danube_full"
    check_launches(label, got, {"flash_attention": cfg.n_layers,
                                "flash_decode": cfg.n_layers * SERVE_NEW})
    if last.shape != (SERVE_BATCH, cfg.vocab) or not all(
            torch.isfinite(x).all() for x in (last, *steps)) \
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"{label}: non-finite logits or bad tokens")
    # the kernels against their plain versions on layer 0's real inputs:
    # the prompts' q/k/v, and the ring after the run with the next query
    q, k, v = layer0_qkv(eng, prompts, 0)
    real = [check_flash_attention(q, k, v, True, cfg.sliding_window,
                                  peaks_, "danube_layer0_prompts",
                                  timed=False)]
    del q, k, v
    q, _, _ = layer0_qkv(eng, toks[:, -1:], eng._pos)
    kv = eng.cache["kv"]
    real.append(check_flash_decode(q[:, 0].contiguous(), kv["k"][0],
                                   kv["v"][0], kv["k"].shape[2], peaks_,
                                   "danube_layer0_ring"))
    # where the time goes: one more prefill and two decode steps under the
    # profiler (kernel time; the host clock above gives the wall time)
    prof_prefill = device_profile(lambda: eng.prefill(prompts),
                                  match=(FLASH_BF16_KERNEL,))
    if prof_prefill["device_ms"] is not None and \
            prof_prefill["match"][FLASH_BF16_KERNEL][1] != cfg.n_layers:
        raise AssertionError(
            f"{label}: the profiled prefill ran {FLASH_BF16_KERNEL} "
            f"{prof_prefill['match'][FLASH_BF16_KERNEL][1]} times, not "
            f"{cfg.n_layers}")
    tok = toks[:, -1]
    prof_decode = device_profile(lambda: [eng.decode(tok) for _ in range(2)],
                                 match=("flash_decode",))
    if prof_decode["device_ms"] is not None:
        for key in ("device_ms", "busy_ms", "kernels"):
            prof_decode[key] /= 2
        prof_decode["match"] = {k: [x / 2 for x in v]
                                for k, v in prof_decode["match"].items()}
    weight_bytes = sum(t.numel() * t.element_size()
                       for name, t in flat_params(eng.params)
                       if name != "embed.table")
    kv_bytes = sum(t.numel() * t.element_size() for t in kv.values())
    decode_ms = 1e3 * statistics.median(step_s)
    rec = {"phase": label, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "params": sum(t.numel() for _, t in flat_params(eng.params)),
           "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "new": SERVE_NEW,
           "launches": got, "prefill_ms": 1e3 * prefill_s,
           "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_s,
           "decode_ms_per_step_median": decode_ms,
           "decode_ms_per_step_first": 1e3 * step_s[0],
           "decode_tokens_per_s": SERVE_BATCH / decode_ms * 1e3,
           "decode_bound_ms": (weight_bytes + kv_bytes) / peaks_[0] * 1e3,
           "decode_bound_bytes": weight_bytes + kv_bytes,
           "peak_mem_gib": peak, "real_input_checks": real,
           "profile_prefill": prof_prefill,
           "profile_decode_per_step": prof_decode}
    for name, prof, wall_ms in (("prefill", prof_prefill, 1e3 * prefill_s),
                                ("decode", prof_decode, decode_ms)):
        if prof["device_ms"] is not None:
            rec[f"{name}_device_idle_share"] = 1 - prof["busy_ms"] / wall_ms
    log("main " + json.dumps(rec))
    return rec, eng, prompts


def phase_serve_exact() -> dict:
    """Phase 11: danube's widths in f32 at EXACT_LAYERS layers; decode
    logits and greedy tokens against forward's over the whole sequence."""
    import numpy as np
    import torch
    eng = serve_engine(n_layers=EXACT_LAYERS, dtype="float32", seed=1)
    cfg = eng.model.cfg
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    last, steps, toks, prefill_s, step_s = serve(eng, prompts)
    got = launches()
    label = "serve_danube_f32_exact"
    check_launches(label, got, {"flash_attention": cfg.n_layers,
                                "flash_decode": cfg.n_layers * SERVE_NEW})
    # forward over the prompt and every token fed to a decode step
    seq = torch.cat([torch.as_tensor(prompts, device=DEVICE).long(),
                     toks[:, :SERVE_NEW].long()], dim=1)
    full, _ = eng.model.forward(eng.params, {"tokens": seq})
    want = full[:, SERVE_PROMPT - 1:]                 # (B, 1 + NEW, V)
    del full
    got_logits = torch.stack([last, *steps], dim=1)[:, :want.shape[1]]
    diff = (got_logits - want).abs()
    excess = float((diff - SERVE_RTOL * want.abs()).max())
    if not torch.isfinite(got_logits).all() or excess > SERVE_ATOL:
        raise AssertionError(f"{label}: decode logits differ from forward's "
                             f"by {float(diff.max())} (atol {SERVE_ATOL} + "
                             f"rtol {SERVE_RTOL} |forward|)")
    # greedy tokens are forward's argmax, up to ties within the tolerance
    fwd_tok = want.argmax(dim=-1)
    chosen = want.gather(-1, toks[:, :want.shape[1], None].long())[..., 0]
    margin = want.max(dim=-1).values - chosen
    tied = (toks[:, :want.shape[1]].long() != fwd_tok)
    tol = 2 * (SERVE_ATOL + SERVE_RTOL * want.abs().max(dim=-1).values)
    if bool((tied & (margin > tol)).any()):
        raise AssertionError(f"{label}: a greedy token is not forward's "
                             "argmax")
    rec = {"phase": label, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "positions": [SERVE_PROMPT - 1, SERVE_PROMPT + SERVE_NEW - 1],
           "launches": got, "max_abs_err": float(diff.max()),
           "max_rel_err": float(diff.max() / want.abs().max()),
           "tolerance": [SERVE_RTOL, SERVE_ATOL],
           "greedy_mismatches_within_tolerance": int(tied.sum()),
           "prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_step_median": 1e3 * statistics.median(step_s),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    return rec


def phase_logit_view(eng, prompts) -> dict:
    """Phase 12: the logit view over phase 10's 8 x 4096 final-norm hidden
    states and its lm_head, under rank-1 hot-swaps through the engine."""
    import numpy as np
    import torch
    from repro_torch.serve import IncrementalLogitView
    cfg = eng.model.cfg
    H = eng.model.hidden(eng.params, {"tokens": prompts})
    H = H.reshape(-1, cfg.d_model).float()
    W = eng.params["lm_head"]["table"].float()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    view = IncrementalLogitView(H, W)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng.attach_logit_view("lm_head", view)
    applies0 = view.engine.stats.lowrank_applies
    rng = np.random.default_rng(12)
    deltas = [(rng.standard_normal((cfg.vocab, 1)).astype(np.float32) * .01,
               rng.standard_normal((cfg.d_model, 1)).astype(np.float32)
               * .01) for _ in range(HOT_SWAPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flushed = [eng.hot_swap("lm_head", u, v) for u, v in deltas]
    eng.flush_views()
    Y = eng.view_logits("lm_head")
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    got, ranks = launches(), dense_ranks()
    applies = view.engine.stats.lowrank_applies - applies0
    label = "logit_view_danube"
    check_launches(label, got, {"rank_update_batched": applies})
    for u, v in deltas:
        W += torch.from_numpy(u).to(DEVICE) @ torch.from_numpy(v).to(DEVICE).T
    t0 = time.perf_counter()
    want = H @ W.T
    torch.cuda.synchronize()
    reeval_s = time.perf_counter() - t0
    rel = check_views(label, {"Y": Y}, {"Y": want})
    rec = {"phase": label, "H": list(H.shape), "W": list(W.shape),
           "Y": list(Y.shape), "hot_swaps": HOT_SWAPS,
           "flushed_on_enqueue": sum(flushed),
           "firings": view.engine.stats.triggers_fired,
           "lowrank_applies": applies, "launches": got,
           "dense_ranks": ranks,
           "initialize_s": init_s, "hot_swap_and_flush_s": swap_s,
           "reeval_matmul_s": reeval_s, "rel_err_vs_reeval": rel,
           "tolerance": MAIN_TOL,
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
    from repro_torch.kernels import cuda_build

    # 1. device
    smi = nvidia_smi()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    part, flops_peak, bytes_peak, bf16_peak = peaks(kind)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {kind}; peaks from the {part} data sheet: "
        f"{flops_peak / 1e12} TFLOP/s fp32, {bytes_peak / 1e12} TB/s, "
        f"{bf16_peak / 1e12} TFLOP/s bf16 (tensor cores, dense)")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    build_s = cuda_build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{json.dumps(build_s)}")
    for name, text in sorted(cuda_build.BUILD_LOGS.items()):
        for entry, line in ptxas_lines(text):
            log(f"ptxas {name} {entry}: {line}")

    # 3. kernels
    shapes = check_kernels(flops_peak, bytes_peak)
    peaks_ = (bytes_peak, flops_peak, bf16_peak)
    shapes.update(check_flash_kernels(peaks_))

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
    del w
    torch.cuda.empty_cache()

    # 10.-12. LM serving
    rec, eng, prompts = phase_serve_full(peaks_)
    phases.append(rec)
    phases.append(phase_serve_exact())
    torch.cuda.empty_cache()
    phases.append(phase_logit_view(eng, prompts))
    del eng

    # the kernels record: per entry, the main path's launches and the
    # numbers of its headline shape (the most common call of the path)
    headline = {"rank_update_batched": (10000, 10000, 1, 16),
                "rank_update": (10000, 10000, 1, 1),
                "rank_update_rows": (CHAIN_N, CHAIN_M, CHAIN_ROWS,
                                     CHAIN_RANK),
                "dual_matmul": (8192, 8192, 1),
                "flash_attention": "danube_prefill_bf16",
                "flash_decode": "danube_decode_bf16_wrapped"}
    # rank_update_batched's launches over phases 4-9 and 12 by K, so that
    # each K's gap to its bound can be weighed by its launches
    by_k = {}
    for ph in phases:
        for K, count in ph.get("dense_ranks", {}).items():
            by_k[K] = by_k.get(K, 0) + count
    if sum(by_k.values()) != sum(ph["launches"]["rank_update_batched"]
                                 for ph in phases):
        raise AssertionError(f"launches by K {by_k} do not sum to the "
                             "launches of rank_update_batched")
    kernels = []
    for entry, recs in shapes.items():
        head = next(r for r in recs
                    if r.get("case", tuple(r[k] for k in r if k in
                                           ("n", "p", "m", "T", "r", "k")))
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
                      if k in ("n", "p", "m", "T", "r", "k", "b", "s", "L",
                               "h", "kvh", "hd", "window", "n_valid",
                               "dtype")}})
        if entry == "rank_update_batched":
            kernels[-1]["launches_by_K"] = dict(sorted(by_k.items()))
        for key in ("device_ms", "kernel_sum_ms", "host_us",
                    "library_device_ms", "library_kernel_sum_ms",
                    "library_host_us"):
            if key in head:
                kernels[-1][key] = head[key]
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
