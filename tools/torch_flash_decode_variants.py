#!/usr/bin/env python3
"""Side-by-side timing of build variants of the bf16 flash-decode kernel on
one GPU.

    python3 tools/torch_flash_decode_variants.py [--slots L] [VARIANT ...]
    python3 tools/torch_flash_decode_variants.py --sass ROOT

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Each variant is ``src/repro_torch/kernels/csrc/
flash_decode.cu`` with a few lines of its text replaced (``VARIANTS``
below; ``checkout`` is the file as it is): the ring's depth, the warps of a
block and the KV heads it covers, the slots a warp takes of each tile, the
order in which splits walk the tiles, and the merge as a programmatic
dependent launch or a plain one.  All are compiled with the
port's own ``nvcc`` flags into a temporary directory, all builds started
together, and the script prints the registers and spills of each variant's
head_dim-80 instance.  Then, at danube's decode shape (B=8, L=4096, H=32,
KV=8, hd=80, bf16; ``--slots`` sets another L) with n_valid L, 2049 and 1
given as a device tensor, it times every variant at 1 to 4 blocks an SM
(``PER_SM``, the split plan's target; CUDA events over 50 back-to-back
calls, split pass and merge, after 5 warm-ups), in two rounds of all
variants in turn, after what PyTorch's own reduction takes to read the
same two caches.  Each output is held against the plain version at the
bf16 tolerance (rtol 1e-2, atol 1e-3), except the probes' (``PROBES``),
which drop the arithmetic, the loads or the epilogue to show what each
costs.  A variant whose text no longer matches the source raises.

``--sass ROOT`` times nothing: it builds ``flash_decode.cu`` of this
checkout and of the checkout under ROOT (e.g. the parent commit unpacked
with ``git archive`` into the git-ignored ``_parent/``), reads every
kernel instance's SASS with ``cuobjdump -sass`` and prints, for each of
this checkout's instances, whether it is ROOT's instruction for
instruction (``identical``, ``different``, or ``new`` where ROOT has no
such instance: the merge's ``WRITE_LSE`` instances), then one
``sass_check`` line; a merge instance with ``WRITE_LSE`` false goes by
its name from before the flag.  It exits 1 when an instance ROOT has is
missing or different.
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

_STAGES = "constexpr int TC_STAGES = 3;"
_WARPS = "constexpr int TC_WARPS = 4;"
_UNITS = "constexpr int TC_UNITS = 1;"
_HEADS = "constexpr int TC_HEADS = 4;"
_COMPUTE = "for (int u = 0; u < TC_UNITS; ++u) {"
_PROLOGUE = """    if (s < run.nt) load_tile(s);
    cp_async_commit();"""
_REFILL = """    if (t + P::STAGES - 1 < run.nt) load_tile(t + P::STAGES - 1);
    cp_async_commit();"""

_EPILOGUE = "  if (wph == 1) {\n"
_INTERLEAVED = """  r.nt = split < tiles ? (tiles - split + nsplit - 1) / nsplit : 0;
  r.first = split;
  r.stride = nsplit;"""
_BLOCKED = """  const int per = (tiles + nsplit - 1) / nsplit;
  r.nt = max(0, min(per, tiles - split * per));
  r.first = split * per;
  r.stride = 1;"""
_LAUNCH_DEPENDENTS = '''asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");'''


def _set(text: str, value: int):
    """Replace a constant's line with the same line at ``value``."""
    return (text, re.sub(r"= \d+;", f"= {value};", text))


VARIANTS = {
    "checkout": [],
    "ring2": [_set(_STAGES, 2)],
    "ring4": [_set(_STAGES, 4)],
    "units2": [_set(_UNITS, 2)],
    "w8h4": [_set(_WARPS, 8)],
    "w8h4_ring2": [_set(_WARPS, 8), _set(_STAGES, 2)],
    "w8h8": [_set(_WARPS, 8), _set(_HEADS, 8)],
    # each split an equal run of consecutive tiles, not every nsplit-th
    "blocked": [(_INTERLEAVED, _BLOCKED)],
    # the merge launched after the split pass has ended
    "no_pdl": [(_LAUNCH_DEPENDENTS, ""),
               ("cfg.numAttrs = 1;", "cfg.numAttrs = 0;")],
    # probes, not kernels: the stream without the arithmetic, the
    # arithmetic on whatever shared memory holds without the stream, and
    # the split pass without its epilogue (partials and merge)
    "loads_only": [(_COMPUTE, "if (run.n < 0) " + _COMPUTE)],
    "compute_only": [(_PROLOGUE, "cp_async_commit();"),
                     (_REFILL, "cp_async_commit();")],
    "no_epilogue": [(_EPILOGUE, """  float keep = l[0] + l[1];
#pragma unroll
  for (int n = 0; n < P::NT; ++n)
    keep += o[n][0] + o[n][1] + o[n][2] + o[n][3];
  if (keep == 1234.5f) out[tid] = bf16();
  return;
""" + _EPILOGUE)],
}
PROBES = tuple(name for name in VARIANTS
               if name.endswith("_only") or name == "no_epilogue")
PER_SM = (1, 2, 3, 4)

B, L, H, KVH, HD = 8, 4096, 32, 8, 80


def block_heads(name: str) -> int:
    """KV heads a block of this variant covers at danube's KV = 8."""
    return math.gcd(KVH, 8 if "h8" in name else 4)


def build(tmp: Path, names) -> dict:
    from repro_torch.kernels import cuda_build
    source = (cuda_build.CSRC / "flash_decode.cu").read_text()
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
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             str(cuda_build.CSRC), "-o", str(tmp / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling" in line and "flash_decode_bf16_mmaILi80E" in line:
                print(f"ptxas {name} hd80: " + " | ".join(
                    x.strip() for x in lines[i + 2:i + 4]), flush=True)
        fn = ctypes.CDLL(str(tmp / f"{name}.so")).flash_decode_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def _short(mangled: str) -> str:
    """A kernel instance's mangled name without its anonymous namespace
    and parameter list; a trailing ``WRITE_LSE = false`` argument
    dropped, so that the serving merge matches its name before the
    flag."""
    name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", mangled)
    name = name.split("EEv")[0]
    return name[:-4] if name.endswith("Lb0E") else name


def _sass(so: Path) -> dict:
    """Every kernel's SASS in ``so`` by short name: its instructions
    without addresses or encodings."""
    from repro_torch.kernels import cuda_build
    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = _short(found.group(1))
            out[fn] = []
        elif fn:
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
            if ins:
                out[fn].append(ins.group(1).strip())
    return out


def sass_check(root: str) -> int:
    """This checkout's flash_decode.cu against ROOT's, instance by
    instance (see the module docstring)."""
    import json
    from repro_torch.kernels import cuda_build
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, src in (("checkout", cuda_build.CSRC / "flash_decode.cu"),
                          ("parent", Path(root) / "src" / "repro_torch" /
                           "kernels" / "csrc" / "flash_decode.cu")):
            procs[name] = subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                 str(src.parent), "-o", str(Path(tmp) / f"{name}.so"),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        mine = _sass(Path(tmp) / "checkout.so")
        base = _sass(Path(tmp) / "parent.so")
    counts = {"identical": [], "different": [], "new": []}
    for fn, ins in sorted(mine.items()):
        kind = ("new" if fn not in base else
                "identical" if base[fn] == ins else "different")
        counts[kind].append(fn)
        print(f"sass {fn}: {len(ins)} / {len(base.get(fn, []))} "
              f"instructions, {kind}", flush=True)
    missing = sorted(set(base) - set(mine))
    print("sass_check " + json.dumps(
        {"library": "flash_decode", "base": root, "missing": missing,
         "new_instances": counts["new"],
         "different_instances": counts["different"],
         **{k: len(v) for k, v in counts.items()}}), flush=True)
    return 1 if missing or counts["different"] else 0


def events_ms(fn, reps: int = 50) -> float:
    import torch
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
    from repro_torch.kernels.flash_decode import split_plan
    if not torch.cuda.is_available():
        print("torch_flash_decode_variants: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args[:1] == ["--sass"]:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        return sass_check(args[1])
    slots = L
    if args[:1] == ["--slots"]:
        slots, args = int(args[1]), args[2:]
    names = args or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(Path(tmp), names)
        gen = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(B, H, HD, device="cuda", generator=gen).bfloat16()
        kc, vc = (torch.randn(B, slots, KVH, HD, device="cuda",
                              generator=gen).bfloat16() for _ in range(2))
        out = torch.empty_like(q)
        for _ in range(2):
            ms = events_ms(lambda: (kc.sum(dtype=torch.float32),
                                    vc.sum(dtype=torch.float32)))
            print(f"reference: torch sum of both caches ms {ms:.5f} TB/s "
                  f"{2 * kc.numel() * 2 / 1e9 / ms:.3f}", flush=True)
        for n_valid in (slots, 2049, 1):
            n_t = torch.tensor(n_valid, dtype=torch.int32, device="cuda")
            want = ref.flash_decode(q, kc, vc, n_valid).float()
            gbytes = 2 * (2 * B * n_valid * KVH * HD + 2 * q.numel()) / 1e9
            for _ in range(2):
                for name in names:
                    for per_sm in PER_SM:
                        fn = entries[name]
                        nsplit = split_plan(B, KVH // block_heads(name),
                                            slots, sms, per_sm)[1]
                        ws = torch.empty(B * H * nsplit * (HD + 2),
                                         dtype=torch.float32, device="cuda")

                        def launch():
                            code = fn(q.data_ptr(), kc.data_ptr(),
                                      vc.data_ptr(), out.data_ptr(),
                                      ws.data_ptr(), n_t.data_ptr(), 0, B, slots, H, KVH,
                                      HD,
                                      nsplit, 1, HD ** -0.5,
                                      torch.cuda.current_stream().cuda_stream)
                            if code:
                                raise RuntimeError(
                                    f"{name}: launch failed with {code}")

                        out.zero_()
                        launch()
                        torch.cuda.synchronize()
                        diff = (out.float() - want).abs()
                        excess = float((diff - 1e-2 * want.abs()).max())
                        for _ in range(5):
                            launch()
                        ms = events_ms(launch)
                        print(f"n_valid {n_valid:4d} {name:14s} per_sm "
                              f"{per_sm} nsplit {nsplit:3d} ms {ms:.5f} TB/s "
                              f"{gbytes / ms:.3f} max abs err "
                              f"{float(diff.max()):.3g} within tolerance "
                              f"{excess <= 1e-3}", flush=True)
                        if not excess <= 1e-3 and name not in PROBES:
                            raise AssertionError(f"variant {name} per_sm "
                                                 f"{per_sm} is wrong")
    return 0


if __name__ == "__main__":
    sys.exit(main())
