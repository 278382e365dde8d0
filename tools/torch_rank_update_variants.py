#!/usr/bin/env python3
"""Side-by-side timing of build variants of the dense rank-update kernel on
one GPU.

    python3 tools/torch_rank_update_variants.py [VARIANT ...]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Each variant is ``src/repro_torch/kernels/csrc/
rank_update.cu`` with a few lines of its text replaced (``VARIANTS``
below; ``checkout`` is the file as it is), compiled with the port's own
``nvcc`` flags into a temporary directory, all builds started together.
``stream_all`` and ``compute_all`` move the crossover ``KSTREAM`` so that
every K takes one tile: side by side they show where the two tiles cross.
For each variant the script prints each kernel instance's registers and
spills, then times ``rank_update_batched_f32`` (CUDA events over a run of
launches after warm-ups) at the main path's shapes (``SHAPES``), in two
rounds of all variants in turn, beside one ``addmm_`` on the same
operands and an in-place ``add_`` on M (the same 8np bytes at K = 0, the
card's practical floor for the byte-bound regime), and holds each output
against the plain version at the kernel tolerance (rtol = atol = 2e-4).  Without arguments every variant runs; a
variant whose text no longer matches the source raises.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

_KSTREAM = "constexpr int KSTREAM = 40;"
_KM_FIRST = "constexpr int KM_FIRST = 16;"
_RING = "CBK = 16, STAGES = 2;"
_PREFETCH = """\
  // warm M's tile (128 rows x 4 lines of 128 bytes) in L2 for the
  // epilogue, once the ring's first chunks are requested: prefetches issued
  // before them delay the first chunk behind M's traffic
  for (int q = tid; q < CBM * 4; q += THREADS) {
    const int r = row0 + q / 4, c = col0 + (q % 4) * 32;
    if (r < n && c < p) prefetch_l2(m + (int64_t)r * p + c);
  }

"""
_FILL = "  const int nch = (t * k + CBK - 1) / CBK;\n"
VARIANTS = {
    "checkout": [],
    # every K on one tile: side by side they show the crossover KSTREAM
    "stream_all": [(_KSTREAM, "constexpr int KSTREAM = 256;")],
    "compute_all": [(_KSTREAM, "constexpr int KSTREAM = 0;")],
    # the streaming tile with M's loads first, or the factors first, at
    # every K: side by side they show the crossover KM_FIRST
    "m_first_all": [(_KM_FIRST, "constexpr int KM_FIRST = 256;")],
    "factors_first_all": [(_KM_FIRST, "constexpr int KM_FIRST = 0;")],
    # the compute tile's ring: flat columns a stage x stages
    "compute_bk16_s3": [(_RING, "CBK = 16, STAGES = 3;")],
    "compute_bk32_s2": [(_RING, "CBK = 32, STAGES = 2;")],
    "compute_bk8_s4": [(_RING, "CBK = 8, STAGES = 4;")],
    # the compute tile's L2 prefetch of M issued before the ring is filled,
    # once the first chunk has landed, or not at all
    "prefetch_first": [(_PREFETCH, ""), (_FILL, _PREFETCH + _FILL)],
    "prefetch_after_chunk0": [
        (_PREFETCH, ""),
        ("    const int buf = ch % STAGES;\n",
         "    const int buf = ch % STAGES;\n    if (ch == 0) {\n"
         + _PREFETCH + "    }\n")],
    "no_prefetch": [("q < CBM * 4; q += THREADS", "q < 0; q += THREADS")],
    # the streaming tile's M moved with evict-first (.cs) loads and stores
    "stream_cs": [
        ("ld.global.v4.f32", "ld.global.cs.v4.f32"),
        ("        *reinterpret_cast<float4*>(dst) =\n            make_float4(",
         "        __stcs(reinterpret_cast<float4*>(dst), make_float4("),
        ("mv[i][3] + acc[i][3]);", "mv[i][3] + acc[i][3]));")],
}

# (n, p, T, k): matrix powers' applies at n = 10000 (K = 1 ... 256 under a
# batch of 16), OLS's Z/W at 8192, and a T = 16 stack of rank-1 pairs
SHAPES = [(10000, 10000, 1, K)
          for K in (1, 16, 24, 32, 40, 48, 64, 96, 128, 256)] \
    + [(8192, 8192, 1, 32), (10000, 10000, 16, 1)]
FP32_TFLOPS, TBS = 67.0, 3.35   # H100 SXM data sheet, 700 W


def build(tmp: Path, names) -> dict:
    from repro_torch.kernels import cuda_build
    source = (cuda_build.CSRC / "rank_update.cu").read_text()
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"variant {name}: text not found:\n{old}")
            text = text.replace(old, new)
        src = tmp / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
             "-o", str(tmp / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                inst = line.split("'")[1]
                print(f"ptxas {name} {inst}: " + " | ".join(
                    x.strip() for x in lines[i + 2:i + 4]), flush=True)
        fn = ctypes.CDLL(str(tmp / f"{name}.so")).rank_update_batched_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def time_ms(fn, reps: int) -> float:
    import torch
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("torch_rank_update_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(Path(tmp), names)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for n, p, t, k in SHAPES:
            K = t * k
            m0 = torch.randn(n, p, device="cuda", generator=gen)
            u = torch.randn(t, n, k, device="cuda", generator=gen)
            v = torch.randn(t, p, k, device="cuda", generator=gen)
            want = ref.rank_update_batched(m0, u, v)
            u2 = u.permute(1, 0, 2).reshape(n, K).contiguous()
            v2 = v.permute(1, 0, 2).reshape(p, K).contiguous()
            work = m0.clone()
            flops = 2.0 * n * p * K
            bound = max((8.0 * n * p + 4.0 * K * (n + p)) / TBS / 1e9,
                        flops / FP32_TFLOPS / 1e9)
            reps = max(10, min(200, int(40 / max(bound, 0.05))))
            lib_ms = time_ms(lambda: work.addmm_(u2, v2.T), reps)
            add_ms = time_ms(lambda: work.add_(1.0), reps)
            stream = torch.cuda.current_stream().cuda_stream

            def launch(fn, out):
                code = fn(out.data_ptr(), u.data_ptr(), v.data_ptr(), n, p,
                          t, k, stream)
                if code:
                    raise RuntimeError(f"launch failed with {code}")

            for rnd in range(2):
                for name in names:
                    fn = entries[name]
                    out = m0.clone()
                    launch(fn, out)
                    torch.cuda.synchronize()
                    excess = float(((out - want).abs()
                                    - 2e-4 * want.abs()).max())
                    ms = time_ms(lambda: launch(fn, work), reps)
                    print(json.dumps({
                        "variant": name, "round": rnd, "n": n, "p": p,
                        "T": t, "k": k, "ms": ms,
                        "tflops": flops / ms / 1e9, "bound_ms": bound,
                        "addmm_ms": lib_ms, "vs_addmm": ms / lib_ms,
                        "add_ms": add_ms,
                        "within_tolerance": excess <= 2e-4}), flush=True)
                    if excess > 2e-4:
                        raise AssertionError(f"{name} at {(n, p, t, k)} is "
                                             "outside the tolerance")
            del m0, u, v, u2, v2, want, work
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
