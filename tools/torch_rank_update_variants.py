#!/usr/bin/env python3
"""Side-by-side timing of build variants of the rank-update kernels on one
GPU: the dense entry (``rank_update_batched_f32``) and the row entry
(``rank_update_rows_f32``).

    python3 tools/torch_rank_update_variants.py [--parent ROOT]
        [--entries dense,skinny,rows] [VARIANT ...]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Each variant is the sources ``rank_update.cu``,
``rank_update_rows.cu`` and their shared ``rank_update_tiles.cuh`` (in
``src/repro_torch/kernels/csrc/``) with a few lines of text replaced
(``VARIANTS`` below; ``checkout`` is the sources as they are), both
libraries compiled with the port's own ``nvcc`` flags into a temporary
directory, all builds started together.  ``--parent ROOT`` adds the variant
``parent``: the same two libraries built from the sources under ROOT (another
checkout, e.g. the parent commit unpacked with ``git archive`` into the
git-ignored ``_parent/``), so old and new kernels are timed in one call.

The ``*_all`` variants move one crossover (``KSTREAM`` or ``KM_FIRST``) of
one entry so that every K takes one side of it: side by side they show where
the two sides cross.  The ``pskinny*`` variants move the dense entry's
``PSKINNY`` (views of fewer columns take the skinny tile), and ``skt_*``
and ``skl_*`` (``_R_BK_S_B``) set the skinny tile's two geometries (rows a
thread, flat columns a chunk, stages of its ring, blocks an SM); ``a+b``
applies both.  For each variant the script prints
each kernel instance's registers and spills, then times every entry at the
main path's shapes (``DENSE_SHAPES``, ``ROW_SHAPES``: ``chip_smoke.py``'s
and a k sweep around the crossovers) by CUDA events over a run of launches
after warm-ups, in rounds (``--rounds``, 4 by default; variants in turn,
then in reverse, and so on):

* ``ms`` (warm): every launch on one M with the same operands, so the rows
  it touches stay in the 50 MB L2 where they fit;
* ``cold_ms``: launches rotate over distinct operands (row entry: at least
  8 RowSets with their own blocks, touching at least twice the L2; dense
  entry: two copies of M and its factors), as the engine's carriers touch
  other rows every firing;
* ``device_ms`` and ``cold_device_ms``: the same launches timed by
  ``torch.profiler``, the kernels alone; where a kernel takes less than
  the host needs to launch it, only these compare the kernels.

Beside them: one library call on the same operands (``addmm_``;
``index_add_`` of ``block @ v.T``), the bound, and the output held against
the plain version at the kernel tolerance (rtol = atol = 2e-4) and, bit for
bit, against the first variant's output (``same_bits``: with ``--parent``,
the parent's).  The ``skinny`` entries time the dense entry in place and
out of place (``rank_update_batched_out_f32``, whose library call is an
out-of-place ``torch.addmm``) at views of p = 1-32 columns
(``SKINNY_SHAPES``, ``--skinny``).  The last
lines (``summary``) give each variant's time over the first variant's at
every shape, each time the median over the rounds.  A variant whose text
no longer matches the source raises.  First, each variant's dense kernels
are compared with the first variant's SASS (``cuobjdump``): with
``--parent``, whether the dense entries still compile to the parent's
instructions.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

CSRC = Path("src/repro_torch/kernels/csrc")
FILES = {"tiles": "rank_update_tiles.cuh", "dense": "rank_update.cu",
         "rows": "rank_update_rows.cu"}
LIBS = ("rank_update", "rank_update_rows")

_KSTREAM = "constexpr int KSTREAM = 40;"
_KM_FIRST = "constexpr int KM_FIRST = 16;"
_RING = "CBK = 16, STAGES = 2;"
_SROWS = "constexpr int SROWS = 8;"
_IDS = "  map.template stage<CBM>(ids, row0, n, tid);\n"
_FILL = "  const int nch = (t * k + CBK - 1) / CBK;\n"
_PREFETCH = "  // warm M's tile (128 rows x 4 lines of 128 bytes) in L2 for " \
    "the\n"
_PSKINNY = "constexpr int PSKINNY = 4;"
_SK = {"t": "using SkTiny = SkinnyGeom<8, 8, 2, 2>;",
       "l": "using SkLarge = SkinnyGeom<1, 32, 2, 4>;"}
# name -> [(file, old text, new text)]
VARIANTS = {
    "checkout": [],
    # every K of one entry on one tile: the crossover KSTREAM
    "stream_all": [("dense", _KSTREAM, "constexpr int KSTREAM = 256;")],
    "compute_all": [("dense", _KSTREAM, "constexpr int KSTREAM = 0;")],
    "rows_stream_all": [("rows", _KSTREAM, "constexpr int KSTREAM = 256;")],
    "rows_compute_all": [("rows", _KSTREAM, "constexpr int KSTREAM = 0;")],
    # the streaming tile with M's loads first, or the factors first, at
    # every K: the crossover KM_FIRST
    "m_first_all": [("dense", _KM_FIRST, "constexpr int KM_FIRST = 256;")],
    "factors_first_all": [("dense", _KM_FIRST,
                           "constexpr int KM_FIRST = 0;")],
    "rows_m_first_all": [("rows", _KM_FIRST, "constexpr int KM_FIRST = 256;")],
    "rows_factors_first_all": [("rows", _KM_FIRST,
                                "constexpr int KM_FIRST = 0;")],
    # the streaming tile's rows a thread (8 or 4) of one entry, and the
    # streaming tile held to 128 registers (two blocks an SM) at any SROWS
    "srows4": [("dense", _SROWS, "constexpr int SROWS = 4;")],
    "rows_srows8": [("rows", "constexpr int SROWS = 4;",
                     "constexpr int SROWS = 8;")],
    "stream_lb2": [("tiles", "__launch_bounds__(THREADS, 16 / SROWS)",
                    "__launch_bounds__(THREADS, 2)")],
    # the compute tile's ring: flat columns a stage x stages
    "compute_bk16_s3": [("tiles", _RING, "CBK = 16, STAGES = 3;")],
    "compute_bk32_s2": [("tiles", _RING, "CBK = 32, STAGES = 2;")],
    # the compute tile's row ids staged once the ring's first chunk is
    # requested (the row entry's id load then overlaps that copy)
    "ids_after_fill": [("tiles", _IDS + _FILL, _FILL),
                       ("tiles", _PREFETCH, _IDS + _PREFETCH)],
    # no L2 prefetch of M's tile in the compute tile
    "no_prefetch": [("tiles", "q < CBM * 4; q += THREADS",
                     "q < 0; q += THREADS")],
    # the streaming tile's M moved with evict-first (.cs) loads and stores
    "stream_cs": [
        ("tiles", "ld.global.v4.f32", "ld.global.cs.v4.f32"),
        ("tiles", "        *reinterpret_cast<float4*>(dst) = x;",
         "        __stcs(reinterpret_cast<float4*>(dst), x);")],
    # the dense entry's PSKINNY: views of p < PSKINNY columns take the
    # skinny tile (the crossover: p = 4, 8, 16 and 32 on it)
    **{f"pskinny{n}": [("dense", _PSKINNY, f"constexpr int PSKINNY = {n};")]
       for n in (5, 9, 17, 33)},
}
# and, by name, the skinny tile's geometries: skt_R_BK_S_B (K <= 4, where
# its tiles fill the SMs) and skl_R_BK_S_B (the rest) set
# SkinnyGeom<R, BK, S, B>: rows a thread, flat columns a chunk, ring
# stages, blocks an SM the registers are held to
_GEOM = re.compile(r"sk([tl])_(\d+)_(\d+)_(\d+)_(\d+)$")

# (n, p, T, k): matrix powers' applies at n = 10000 (K = 1 ... 256 under a
# batch of 16), OLS's Z/W at 8192, and a T = 16 stack of rank-1 pairs
DENSE_SHAPES = [(10000, 10000, 1, K)
                for K in (1, 16, 24, 32, 40, 48, 64, 96, 128, 256)] \
    + [(8192, 8192, 1, 32), (10000, 10000, 16, 1)]
# (n, p, T, k, out of place): the skinny tile's shapes, the learning views'
# 2^20 x 1 Y and W (K = 1-3, in place and out of place), 2^20 x 2 and x 3,
# a T = 16 stack against a k = 16 pair, K = 64 and 1024 (many chunks), the
# apps' vectors (OLS's 8192 x 1, PageRank's 10000 x 1), then the PSKINNY
# crossover: p = 1, 2, 3, 4, 8, 16, 32 at K = 3 and 32 (--skinny picks
# the main shapes, the crossover or both)
SKINNY_MAIN = [(2 ** 20, 1, 1, K, out) for K in (1, 2, 3)
                 for out in (False, True)] \
    + [(2 ** 20, p, 1, K, out) for p in (2, 3) for K in (1, 2, 3)
       for out in (False, True)] \
    + [(2 ** 20, 1, 16, 1, False), (2 ** 20, 1, 1, 16, False),
       (2 ** 20, 1, 1, 64, False), (2 ** 20, 1, 1, 1024, False),
       (8192, 1, 1, 1, False), (8192, 1, 1, 16, False),
       (10000, 1, 1, 1, False), (10000, 1, 1, 16, False)]
SKINNY_CROSSOVER = [(2 ** 20, p, 1, K, False) for K in (3, 32)
                    for p in (1, 2, 3, 4, 8, 16, 32)] \
    + [(n, p, 1, K, False) for n in (10000, 32768, 65536, 262144)
       for K in (3, 32) for p in (4, 8, 16)]
SKINNY_SHAPES = {"main": SKINNY_MAIN, "crossover": SKINNY_CROSSOVER,
                 "all": SKINNY_MAIN + SKINNY_CROSSOVER}
# (n, p, r, k): chip_smoke.py's row cases (phase 6's X, Y1/Y2 and stacked
# batch, phase 7's A/S2, T1 and batch, a ragged shape), then k around the
# crossovers at phase 6's single-carrier shape
ROW_SHAPES = [(2 ** 20, 384, 10485, 8), (2 ** 20, 256, 10485, 8),
              (2 ** 20, 384, 157275, 128), (10000, 10000, 100, 1),
              (10000, 128, 100, 1), (10000, 10000, 800, 8), (37, 101, 5, 3)] \
    + [(2 ** 20, 384, 10485, k) for k in (16, 24, 32, 40, 48, 64)]
FP32_TFLOPS, TBS = 67.0, 3.35   # H100 SXM data sheet, 700 W
L2_BYTES = 50 * 2 ** 20         # H100's L2
TOL = 2e-4


def variant(part: str) -> list:
    """The text edits of one variant name (listed, or a geometry)."""
    geom = _GEOM.match(part)
    if geom:
        which, *nums = geom.groups()
        old = _SK[which]
        return [("tiles", old, old.split("<")[0] + "<" + ", ".join(nums)
                 + ">;")]
    return VARIANTS[part]


def edits(name: str) -> list:
    """The text edits of variant ``name``; ``a+b`` is variant a's edits,
    then b's."""
    return [e for part in name.split("+") for e in variant(part)]


def sources(name: str) -> dict:
    """The three source texts of variant ``name``."""
    text = {key: (ROOT / CSRC / fname).read_text()
            for key, fname in FILES.items()}
    for key, old, new in edits(name):
        if old not in text[key]:
            raise ValueError(f"variant {name}: text not found in "
                             f"{FILES[key]}:\n{old}")
        text[key] = text[key].replace(old, new)
    return text


def build(tmp: Path, names, parent) -> dict:
    from repro_torch.kernels import cuda_build
    procs = {}
    for name in names:
        d = tmp / name
        d.mkdir()
        if name == "parent":   # the parent's sources, whatever they include
            for f in (Path(parent) / CSRC).glob("*.cu*"):
                shutil.copy(f, d / f.name)
        else:
            for key, text in sources(name).items():
                (d / FILES[key]).write_text(text)
        for lib in LIBS:
            procs[name, lib] = subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                 "-o", str(d / f"lib{lib}.so"), str(d / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for (name, lib), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name} ({lib}):\n"
                               f"{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                inst = line.split("'")[1]
                print(f"ptxas {name} {inst}: " + " | ".join(
                    x.strip() for x in lines[i + 2:i + 4]), flush=True)
        so = ctypes.CDLL(str(tmp / name / f"lib{lib}.so"))
        if lib == "rank_update":
            fn = so.rank_update_batched_f32
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
            out = so.rank_update_batched_out_f32
            out.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
            out.restype = ctypes.c_int
            entries[name, "rank_update_out"] = out
        else:
            fn = so.rank_update_rows_f32
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
                + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name, lib] = fn
    return entries


def sass(so: Path) -> dict:
    """The dense kernels' SASS in ``so``, by tile and M's access (VEC), as
    lists of instructions without addresses or encodings; the
    out-of-place instances (``OutOfPlace``) under their own ``_out``
    keys, so the in-place ones are compared with in-place ones."""
    from repro_torch.kernels import cuda_build
    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        found = re.search(
            r"Function : \S*(rank_update_(?:compute|stream)ILb[01])", line)
        if "Function : " in line:
            fn = found.group(1) if found else None
            if fn and "OutOfPlace" in line:
                fn += "_out"
            if fn:
                out[fn] = []
        elif fn:
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
            if ins:
                out[fn].append(ins.group(1).strip())
    return out


def compare_sass(tmp: Path, names) -> None:
    """Print, for each dense kernel, whether each variant's SASS is the
    first variant's instruction for instruction (``--parent``: whether the
    dense entries still compile to the parent's code)."""
    base = sass(tmp / names[0] / "librank_update.so")
    for name in names[1:]:
        other = sass(tmp / name / "librank_update.so")
        for fn in sorted(base):
            same = other.get(fn) == base[fn]
            print(f"sass {name} vs {names[0]} {fn}: {len(base[fn])} / "
                  f"{len(other.get(fn, []))} instructions, "
                  f"{'identical' if same else 'different'}", flush=True)


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


def device_ms(fn, reps: int) -> float:
    """Mean kernel time on the card per call of ``fn``, by torch.profiler:
    the host's launch time and the gaps between kernels excluded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def timings(warm, cold, reps: int) -> dict:
    """Warm and cold ms by events (what a caller that launches back to
    back waits for, the host's launch time included) and by the profiler
    (the kernels alone)."""
    return {"ms": time_ms(warm, reps), "cold_ms": time_ms(cold, reps),
            "device_ms": device_ms(warm, min(reps, 50)),
            "cold_device_ms": device_ms(cold, min(reps, 50))}


def orders(names: list, rounds: int) -> list:
    """The order of the variants in each round: in turn, then in reverse,
    and so on (parent, change, change, parent for two)."""
    return [names if rnd % 2 == 0 else names[::-1] for rnd in range(rounds)]


def rotation(ops: list):
    """A function that launches on the next operands of ``ops`` in turn."""
    state = {"i": 0}

    def step():
        ops[state["i"] % len(ops)]()
        state["i"] += 1
    return step


def check(label: str, got, want) -> None:
    excess = float(((got - want).abs() - TOL * want.abs()).max())
    if excess > TOL:
        raise AssertionError(f"{label} is outside the tolerance")


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / TBS / 1e9, flops / FP32_TFLOPS / 1e9)


def dense_cases(names, rounds, entries, results):
    import torch
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for n, p, t, k in DENSE_SHAPES:
        K = t * k
        ops = [(torch.randn(n, p, device="cuda", generator=gen),
                torch.randn(t, n, k, device="cuda", generator=gen),
                torch.randn(t, p, k, device="cuda", generator=gen))
               for _ in range(2)]
        m0, u, v = ops[0]
        want = ref.rank_update_batched(m0, u, v)
        u2 = u.permute(1, 0, 2).reshape(n, K).contiguous()
        v2 = v.permute(1, 0, 2).reshape(p, K).contiguous()
        work = [m.clone() for m, _, _ in ops]
        flops = 2.0 * n * p * K
        bound = bound_ms(8.0 * n * p + 4.0 * K * (n + p), flops)
        reps = max(10, min(200, int(40 / max(bound, 0.05))))
        lib_ms = time_ms(lambda: work[0].addmm_(u2, v2.T), reps)

        # pointers taken once, so that a launch costs the host a ctypes
        # call and no more
        def launch(fn, out, u, v):
            code = fn(out, u, v, n, p, t, k, stream)
            if code:
                raise RuntimeError(f"launch failed with {code}")

        ptrs = [(w.data_ptr(), o[1].data_ptr(), o[2].data_ptr())
                for w, o in zip(work, ops)]

        firsts = {}
        for rnd, order in enumerate(orders(names, rounds)):
            for name in order:
                fn = entries[name, "rank_update"]
                out = m0.clone()
                launch(fn, out.data_ptr(), u.data_ptr(), v.data_ptr())
                torch.cuda.synchronize()
                check(f"{name} dense {(n, p, t, k)}", out, want)
                firsts.setdefault(name, out)
                times = timings(lambda: launch(fn, *ptrs[0]), rotation(
                    [lambda q=q: launch(fn, *q) for q in ptrs]), reps)
                emit(results, name, rnd, "dense",
                     {"n": n, "p": p, "T": t, "k": k}, times, flops,
                     bound, lib_ms, "addmm_ms", same_bits=torch.equal(
                         out, firsts.get(names[0], out)))
        del ops, m0, u, v, u2, v2, want, work, out, firsts
        torch.cuda.empty_cache()


def skinny_cases(names, rounds, entries, results, shapes):
    """The dense entry at SKINNY_SHAPES, in place or out of place; the
    library call is ``addmm_`` or an out-of-place ``torch.addmm``, timed
    by events and by the profiler (``addmm_device_ms``)."""
    import torch
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    for n, p, t, k, out_of_place in SKINNY_SHAPES[shapes]:
        K = t * k
        ops = [(torch.randn(n, p, device="cuda", generator=gen),
                torch.randn(t, n, k, device="cuda", generator=gen),
                torch.randn(t, p, k, device="cuda", generator=gen))
               for _ in range(2)]
        m0, u, v = ops[0]
        want = ref.rank_update_batched(m0, u, v)
        u2 = u.permute(1, 0, 2).reshape(n, K).contiguous()
        v2 = v.permute(1, 0, 2).reshape(p, K).contiguous()
        work = [m.clone() for m, _, _ in ops]
        dst = [torch.empty_like(m) for m, _, _ in ops]
        flops = 2.0 * n * p * K
        bound = bound_ms(8.0 * n * p + 4.0 * K * (n + p), flops)
        reps = max(20, min(400, int(40 / max(bound, 0.02))))
        if out_of_place:
            def library():
                return torch.addmm(m0, u2, v2.T)
        else:
            def library():
                return work[0].addmm_(u2, v2.T)
        lib_ms = time_ms(library, reps)
        lib_device_ms = device_ms(library, min(reps, 50))

        def launch(fn, *ptrs):
            code = fn(*ptrs, 0, n, p, t, k, stream) if out_of_place \
                else fn(*ptrs, n, p, t, k, stream)
            if code:
                raise RuntimeError(f"launch failed with {code}")

        if out_of_place:   # src, dst, u, v, then the (absent) flag
            ptrs = [(o[0].data_ptr(), d.data_ptr(), o[1].data_ptr(),
                     o[2].data_ptr()) for o, d in zip(ops, dst)]
        else:
            ptrs = [(w.data_ptr(), o[1].data_ptr(), o[2].data_ptr())
                    for w, o in zip(work, ops)]
        key = "rank_update_out" if out_of_place else "rank_update"
        firsts = {}
        for rnd, order in enumerate(orders(names, rounds)):
            for name in order:
                fn = entries[name, key]
                res = m0.clone()
                try:   # a geometry may not fit this p in shared memory
                    if out_of_place:
                        res = torch.empty_like(m0)
                        launch(fn, m0.data_ptr(), res.data_ptr(),
                               u.data_ptr(), v.data_ptr())
                    else:
                        launch(fn, res.data_ptr(), u.data_ptr(),
                               v.data_ptr())
                except RuntimeError as err:
                    print(json.dumps({"variant": name, "entry": "skinny",
                                      "shape": [n, p, t, k, out_of_place],
                                      "refused": str(err)}), flush=True)
                    continue
                torch.cuda.synchronize()
                check(f"{name} skinny {(n, p, t, k, out_of_place)}", res,
                      want)
                firsts.setdefault(name, res)
                times = timings(lambda: launch(fn, *ptrs[0]), rotation(
                    [lambda q=q: launch(fn, *q) for q in ptrs]), reps)
                emit(results, name, rnd, "skinny_out" if out_of_place
                     else "skinny", {"n": n, "p": p, "T": t, "k": k},
                     times, flops, bound, lib_ms, "addmm_ms",
                     same_bits=torch.equal(res, firsts.get(names[0], res)),
                     addmm_device_ms=lib_device_ms)
        del ops, m0, u, v, u2, v2, want, work, dst, res, firsts
        torch.cuda.empty_cache()


def row_cases(names, rounds, entries, results):
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rank_update_rows import RowSet
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for n, p, r, k in ROW_SHAPES:
        m0 = torch.randn(n, p, device="cuda", generator=gen)
        v = torch.randn(p, k, device="cuda", generator=gen)
        count = max(8, min(64, math.ceil(2 * L2_BYTES / (4.0 * r * p))))
        sets = [(RowSet(np.sort(rng.choice(n, r, replace=False)), n),
                 torch.randn(r, k, device="cuda", generator=gen))
                for _ in range(count)]
        rows, block = sets[0]
        idx = rows.index("cuda")
        want = ref.rank_update_rows(m0, idx, block, v)
        work = m0.clone()
        flops = 2.0 * r * p * k
        bound = bound_ms(8.0 * r * p + 4.0 * k * (r + p) + 4.0 * r, flops)
        reps = max(20, min(400, int(40 / max(bound, 0.02))))
        lib_ms = time_ms(lambda: work.index_add_(0, idx, block @ v.T), reps)

        def launch(fn, out, ids, blk):
            code = fn(out, ids, blk, vp, r, p, k, stream)
            if code:
                raise RuntimeError(f"launch failed with {code}")

        vp, wp = v.data_ptr(), work.data_ptr()
        ptrs = [(rs.ids("cuda").data_ptr(), b.data_ptr()) for rs, b in sets]

        for rnd, order in enumerate(orders(names, rounds)):
            for name in order:
                fn = entries[name, "rank_update_rows"]
                out = m0.clone()
                launch(fn, out.data_ptr(), *ptrs[0])
                torch.cuda.synchronize()
                check(f"{name} rows {(n, p, r, k)}", out, want)
                times = timings(lambda: launch(fn, wp, *ptrs[0]), rotation(
                    [lambda q=q: launch(fn, wp, *q) for q in ptrs]), reps)
                emit(results, name, rnd, "rows",
                     {"n": n, "p": p, "r": r, "k": k, "cold_sets": count},
                     times, flops, bound, lib_ms, "index_add_ms")
        del m0, v, sets, rows, block, idx, want, work, out
        torch.cuda.empty_cache()


def emit(results, name, rnd, entry, shape, times, flops, bound, lib_ms,
         lib_key, **extra) -> None:
    ms = times["ms"]
    rec = {"variant": name, "round": rnd, "entry": entry, **shape, **times,
           "tflops": flops / ms / 1e9, "bound_ms": bound, lib_key: lib_ms,
           "vs_library": ms / lib_ms, "within_tolerance": True, **extra}
    print(json.dumps(rec), flush=True)
    key = (entry, tuple(v for k, v in shape.items() if k != "cold_sets"))
    slot = results.setdefault(key, {})
    slot.setdefault(name, []).append(times)
    slot.setdefault("_meta", {"bound_ms": bound, lib_key: lib_ms, **{
        k: v for k, v in extra.items() if k != "same_bits"}})
    if "same_bits" in extra:   # bit for bit in every round
        bits = slot.setdefault("_bits", {})
        bits[name] = bits.get(name, True) and extra["same_bits"]


def summary(names, results) -> None:
    """Each variant's median times over the rounds, and their ratios to the
    first variant's, at every shape."""
    base = names[0]
    for (entry, shape), by in results.items():
        med = {name: {key: statistics.median(x[key] for x in by[name])
                      for key in by[name][0]}
               for name in names if name in by}
        print("summary " + json.dumps({
            "entry": entry, "shape": shape, "base": base,
            **by.get("_meta", {}), "same_bits": by.get("_bits", {}),
            **{name: {**t, **{f"{key}_vs_base": t[key] / med[base][key]
                              for key in t}}
               for name, t in med.items()}}), flush=True)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout, built as "
                    "the variant 'parent' and timed first")
    ap.add_argument("--entries", default="dense,skinny,rows",
                    help="comma-separated: dense, skinny, rows")
    ap.add_argument("--skinny", choices=sorted(SKINNY_SHAPES),
                    default="all", help="the skinny entry's shapes: the "
                    "main path's, the PSKINNY crossover, or all")
    ap.add_argument("--rounds", type=int, default=4,
                    help="rounds of all variants (default 4)")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rank_update_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    names = args.variants or list(VARIANTS)
    unknown = [n for n in names
               if any(part not in VARIANTS and not _GEOM.match(part)
                      for part in n.split("+"))]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{', '.join(VARIANTS)}")
    if args.parent:
        names = ["parent"] + names
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    results: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(Path(tmp), names, args.parent)
        compare_sass(Path(tmp), names)
        wanted = args.entries.split(",")
        if "dense" in wanted:
            dense_cases(names, args.rounds, entries, results)
        if "skinny" in wanted:
            skinny_cases(names, args.rounds, entries, results, args.skinny)
        if "rows" in wanted:
            row_cases(names, args.rounds, entries, results)
    summary(names, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
