#!/usr/bin/env python3
"""Side-by-side timing of build variants of the dual-matmul kernel on one GPU.

    python3 tools/torch_dual_matmul_variants.py [--parent ROOT] [--rounds N]
        [--shapes N,M,K;...] [--no-host] [VARIANT[+VARIANT] ...]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Each variant is ``src/repro_torch/kernels/csrc/dual_matmul.cu``
with a few lines of its text replaced (``VARIANTS`` below; ``checkout`` is
the file as it is): the rows of a ring stage, the ring's depth, the warps of
a block, the blocks an SM the plan fills, the rows a block's P sums cover,
the fewest rows of a band, and the final sum as a programmatic dependent
launch or a plain one.  ``PROBES`` are not kernels: they drop the FMAs, the
loads of A, or the epilogue (P's and Q's writes and the second kernel), to
show what each costs.  ``--parent ROOT`` adds the variant ``parent``: the
``dual_matmul.cu`` of another checkout (e.g. the parent commit unpacked with
``git archive`` into the git-ignored ``_parent/``), whose entry has the same
arguments and takes a workspace of ceil(m / 32) * n * k floats, so old and
new kernels are timed in one call.

All variants are compiled with the port's own ``nvcc`` flags into a
temporary directory, all builds started together, and each instance's
registers and spills are printed.  Then, at every shape (``SHAPES``: phase
9's 8192^2 at k = 1, the ragged shapes of ``chip_smoke.py``'s phase 3, k = 8,
a misaligned A), each variant's output is held against the plain version in
float64 at the kernel tolerance (rtol = atol = 2e-4) and against a second
call bit for bit, and timed in rounds (variants in turn, then in reverse,
and so on):

* ``ms``: CUDA events over back-to-back launches through ctypes (pointers
  taken once), so the host adds little;
* ``device_ms``: the same launches under ``torch.profiler``, the union of
  the kernels' intervals (``kernel_sum_ms`` their summed time, which counts
  the wait of the programmatic dependent launch).

Beside them: PyTorch's own read of A (``torch.mv(a, u[:, 0])``, one GEMV:
the card's practical floor for reading A once), the library pair
``(a @ u, a.T @ v)``, and the byte bound at 3.35 TB/s.  The last lines
(``summary``) give each variant's median times over the rounds and their
ratio to the first variant's.  Unless ``--no-host``, the script then splits
the binding's host time per call at the smallest shape into its parts
(checks, allocations, stream, the ctypes launch).  A variant whose text no
longer matches the source raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

CSRC = Path("src/repro_torch/kernels/csrc")
SOURCE = "dual_matmul.cu"

_K1 = "struct Cfg<1> {\n  static constexpr int ROWS = 4, STAGES = 3, OCC = 1;"
_WARPS = "constexpr int WARPS = 8;"
_GROUP = "constexpr int GROUP = 32;"
_MIN_BAND = "constexpr int MIN_BAND = 8;"
_COMPUTE = "      for (int i = 0; i < ROWS; ++i) {\n        const float4 t4"
_PROLOGUE = "      if (s < nst) issue(s);"
_REFILL = "      if (t + STAGES - 1 < nst) issue(t + STAGES - 1);"
_PWRITE = "          pdst[(int64_t)(g0 + e / KC) * k + j0 + j] = sum;"
_QWRITE = "          if (j < kc) qdst[(int64_t)col[c] * k + j0 + j] = qa[c][j];"
_SUMS = "  if (err != cudaSuccess || (pl.strips == 1 && pl.bands == 1))"


def _k1(rows: int, stages: int, occ: int):
    return (_K1, _K1.replace("ROWS = 4, STAGES = 3, OCC = 1",
                             f"ROWS = {rows}, STAGES = {stages}, OCC = {occ}"))


# name -> [(old text, new text)]
VARIANTS = {
    "checkout": [],
    # the k = 1 ring: rows a stage, stages, blocks an SM
    "ring2": [_k1(4, 2, 1)],
    "ring4": [_k1(4, 4, 1)],
    "occ2": [_k1(4, 3, 2)],
    "rows8": [_k1(8, 3, 1)],
    "rows2_ring6": [_k1(2, 6, 1)],
    # 4 warps a block (a strip of 512 columns), two blocks an SM
    "warps4_occ2": [(_WARPS, "constexpr int WARPS = 4;"), _k1(4, 3, 2)],
    # P's cross-warp sums every 64 rows
    "group64": [(_GROUP, "constexpr int GROUP = 64;")],
    # bands of at least 4 or 16 rows
    "band4": [(_MIN_BAND, "constexpr int MIN_BAND = 4;")],
    "band16": [(_MIN_BAND, "constexpr int MIN_BAND = 16;")],
    # the final sum launched after the stream pass has ended
    "no_pdl": [("cfg.numAttrs = 1;", "cfg.numAttrs = 0;")],
    # probes, not kernels: the stream of A without the FMAs, the FMAs on
    # whatever shared memory holds without the stream, and the pass without
    # P's and Q's writes and the second kernel
    "loads_only": [(_COMPUTE, _COMPUTE.replace("i < ROWS", "i < (n < 0 ? "
                                               "ROWS : 0)"))],
    "compute_only": [(_PROLOGUE, ""), (_REFILL, "")],
    "no_epilogue": [(_PWRITE, "          if (sum == 1234.5f) " +
                     _PWRITE.strip()),
                    (_QWRITE, _QWRITE.replace("if (j < kc)",
                                              "if (qa[c][j] == 1234.5f)")),
                    (_SUMS, "  if (true)")],
}
PROBES = ("loads_only", "compute_only", "no_epilogue")

# (n, m, k, misaligned): phase 9's W, phase 3's ragged shapes, k = 8, and
# A at a 4-byte storage offset
SHAPES = [(8192, 8192, 1, False), (1000, 777, 5, False), (37, 101, 1, False),
          (8192, 8192, 8, False), (8192, 8192, 1, True)]
TBS = 3.35          # H100 SXM data sheet, 700 W
TOL = 2e-4


def edits(name: str) -> list:
    return [e for part in name.split("+") for e in VARIANTS[part]]


def source(name: str) -> str:
    text = (ROOT / CSRC / SOURCE).read_text()
    for old, new in edits(name):
        if old not in text:
            raise ValueError(f"variant {name}: text not found:\n{old}")
        text = text.replace(old, new)
    return text


def build(tmp: Path, names, parent) -> dict:
    from repro_torch.kernels import cuda_build
    procs = {}
    for name in names:
        src = tmp / f"{name}.cu"
        src.write_text((Path(parent) / CSRC / SOURCE).read_text()
                       if name == "parent" else source(name))
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
             "-o", str(tmp / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
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
        lib = ctypes.CDLL(str(tmp / f"lib{name}.so"))
        lib.dual_matmul_f32.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.dual_matmul_f32.restype = ctypes.c_int
        if name != "parent":
            lib.dual_matmul_workspace.argtypes = [ctypes.c_int] * 3 + [
                ctypes.POINTER(ctypes.c_longlong)]
            lib.dual_matmul_workspace.restype = ctypes.c_int
        libs[name] = lib
    return libs


def workspace(name: str, lib, n: int, m: int, k: int) -> int:
    if name == "parent":
        return -(-m // 32) * n * k
    out = ctypes.c_longlong()
    if lib.dual_matmul_workspace(n, m, k, out):
        raise RuntimeError(f"{name}: dual_matmul_workspace failed")
    return out.value


def events_ms(fn, reps: int) -> float:
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


def device_ms(fn, reps: int):
    """(busy, summed) kernel ms on the card per call of ``fn`` by
    torch.profiler: the union of the kernels' intervals (a programmatic
    dependent launch starts while the pass before it runs, so its summed
    time counts its wait) and their summed time; (None, None) if the
    profiler saw no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None, None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    summed = sum(e.time_range.end - e.time_range.start for e in events)
    return busy / 1e3 / reps, summed / 1e3 / reps


def orders(names: list, rounds: int) -> list:
    return [names if rnd % 2 == 0 else names[::-1] for rnd in range(rounds)]


def cases(names, libs, rounds, shapes, results) -> None:
    import torch
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for n, m, k, misaligned in shapes:
        base = torch.randn(n * m + 1, device="cuda", generator=gen)
        a = (base[1:] if misaligned else base[:-1]).view(n, m)
        u = torch.randn(m, k, device="cuda", generator=gen)
        v = torch.randn(n, k, device="cuda", generator=gen)
        # the plain version in float64: two fp32 orders of an 8192-term
        # sum that cancels can differ by more than the tolerance
        want = ref.dual_matmul(a.double(), u.double(), v.double())
        nbytes = 4.0 * n * m + 4.0 * k * (2 * n + 2 * m)
        bound = nbytes / TBS / 1e9
        reps = max(20, min(400, int(40 / max(bound, 0.01))))
        u0 = u[:, 0].contiguous()
        floor_ms = events_ms(lambda: torch.mv(a, u0), reps)
        lib_ms = events_ms(lambda: (a @ u, a.T @ v), reps)
        lib_dev = device_ms(lambda: (a @ u, a.T @ v), 20)[0]
        shape = {"n": n, "m": m, "k": k, "misaligned": misaligned}
        print("reference " + json.dumps({
            **shape, "bound_ms": bound, "mv_ms": floor_ms,
            "mv_TBps": 4.0 * n * m / floor_ms / 1e9, "library_ms": lib_ms,
            "library_device_ms": lib_dev}), flush=True)
        p = torch.empty(n, k, device="cuda")
        q = torch.empty(m, k, device="cuda")
        for rnd, order in enumerate(orders(names, rounds)):
            for name in order:
                lib = libs[name]
                ws = torch.empty(max(1, workspace(name, lib, n, m, k)),
                                 device="cuda")
                args = (a.data_ptr(), u.data_ptr(), v.data_ptr(),
                        p.data_ptr(), q.data_ptr(), ws.data_ptr(), n, m, k,
                        stream)

                def launch():
                    code = lib.dual_matmul_f32(*args)
                    if code:
                        raise RuntimeError(f"{name}: launch failed with "
                                           f"cudaError {code}")

                launch()
                torch.cuda.synchronize()
                got = (p.clone(), q.clone())
                launch()
                torch.cuda.synchronize()
                same = torch.equal(got[0], p) and torch.equal(got[1], q)
                excess = max(float(((g.double() - w).abs()
                                    - TOL * w.abs()).max())
                             for g, w in zip(got, want))
                ok = excess <= TOL
                if name not in PROBES and not (ok and same):
                    raise AssertionError(f"variant {name} at {shape}: "
                                         f"within tolerance {ok}, bitwise "
                                         f"repeatable {same}")
                busy, summed = device_ms(launch, 20)
                times = {"ms": events_ms(launch, reps), "device_ms": busy,
                         "kernel_sum_ms": summed}
                rec = {"variant": name, "round": rnd, **shape, **times,
                       "TBps": nbytes / times["ms"] / 1e9,
                       "bound_ms": bound, "mv_ms": floor_ms,
                       "library_ms": lib_ms, "workspace_floats":
                       workspace(name, lib, n, m, k),
                       "within_tolerance": ok, "repeatable": same}
                print(json.dumps(rec), flush=True)
                results.setdefault(tuple(shape.values()), {}).setdefault(
                    name, []).append(times)
                del ws
        del base, a, u, v, want, p, q
        torch.cuda.empty_cache()


def summary(names, results) -> None:
    base = names[0]
    for shape, by in results.items():
        med = {name: {key: statistics.median(vals) for key in by[name][0]
                      if (vals := [x[key] for x in by[name]
                                   if x[key] is not None])}
               for name in names if name in by}
        print("summary " + json.dumps({
            "shape": shape, "base": base,
            **{name: {**t, **{f"{key}_vs_base": t[key] / med[base][key]
                              for key in t if key in med[base]}}
               for name, t in med.items()}}), flush=True)


def _in_device(index: int) -> None:
    import torch
    with torch.cuda.device(index):
        pass


def host_split(reps: int = 2000) -> None:
    """Host µs per call of the binding at (37, 101, 1), and of its parts."""
    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import dual_matmul as dm
    from repro_torch.kernels.rank_update import check_operands
    gen = torch.Generator(device="cuda").manual_seed(1)
    a, u, v = (torch.randn(*s, device="cuda", generator=gen)
               for s in ((37, 101), (101, 1), (37, 1)))
    lib = cuda_build.library("dual_matmul", dm._SIGNATURES)
    ws = dm._workspace(lib, 37, 101, 1, 0)
    p, q, w = (torch.empty(s, device="cuda") for s in ((37, 1), (101, 1),
                                                        (max(ws, 1),)))
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (a.data_ptr(), u.data_ptr(), v.data_ptr(), p.data_ptr(),
            q.data_ptr(), w.data_ptr())
    parts = {
        "binding": lambda: dm.dual_matmul(a, u, v),
        "check_operands": lambda: check_operands(a, inplace=False, u=u, v=v),
        "shape_checks": lambda: (a.dim(), u.dim(), v.dim(), a.shape,
                                 u.shape == (101, 1), v.shape == (37, 1)),
        "library_lookup": lambda: cuda_build.library("dual_matmul",
                                                      dm._SIGNATURES),
        "workspace_lookup": lambda: dm._workspace(lib, 37, 101, 1, 0),
        "current_device": lambda: torch.cuda.current_device(),
        "empty_x2": lambda: (torch.empty((37, 1), device=a.device),
                             torch.empty((101, 1), device=a.device)),
        "workspace_buffer": lambda: dm._BUFFERS.get((0, stream)),
        "current_stream": lambda: torch.cuda.current_stream(0).cuda_stream,
        "device_context": lambda: _in_device(0),
        "data_ptrs": lambda: (a.data_ptr(), u.data_ptr(), v.data_ptr()),
        "ctypes_launch": lambda: lib.dual_matmul_f32(*ptrs, 37, 101, 1,
                                                     stream),
        "library_pair": lambda: (a @ u, a.T @ v),
    }
    for name, fn in parts.items():
        for rnd in range(2):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            us = (time.perf_counter() - t0) / reps * 1e6
            torch.cuda.synchronize()
            print("host " + json.dumps({"part": name, "round": rnd,
                                        "us": us}), flush=True)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout, built as "
                    "the variant 'parent' and timed first")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--shapes", help="n,m,k[,misaligned];... (default: "
                    "SHAPES)")
    ap.add_argument("--no-host", action="store_true",
                    help="skip the binding's host-time split")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dual_matmul_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    names = args.variants or [n for n in VARIANTS if n not in PROBES]
    unknown = [n for n in names
               if any(part not in VARIANTS for part in n.split("+"))]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{', '.join(VARIANTS)}")
    if args.parent:
        names = ["parent"] + names
    shapes = SHAPES
    if args.shapes:
        shapes = [tuple(int(x) for x in s.split(",")[:3])
                  + (len(s.split(",")) > 3 and s.split(",")[3] == "1",)
                  for s in args.shapes.split(";")]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    results: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), names, args.parent)
        cases(names, libs, args.rounds, shapes, results)
    summary(names, results)
    if not args.no_host:
        host_split()
    return 0


if __name__ == "__main__":
    sys.exit(main())
