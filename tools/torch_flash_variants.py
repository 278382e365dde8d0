#!/usr/bin/env python3
"""Side-by-side timing of build variants of the bf16 flash-attention kernel
on one GPU.

    python3 tools/torch_flash_variants.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Each variant is ``src/repro_torch/kernels/csrc/
flash_attention.cu`` with a few lines of its text replaced (``VARIANTS``
below; ``checkout`` is the file as it is), compiled with the port's own
``nvcc`` flags into a temporary directory, all builds started together.
For each variant the script prints the bf16 kernel instances' registers
and spills, then times the bf16 entry (CUDA events over 20 launches after
3 warm-ups) at danube's prefill shape (B=8, S=4096, H=32, KV=8, hd=80,
window 4096), starcoder2's heads (B=2, H=36, KV=4, hd=128) and a ragged
S = 1000, in two rounds of all variants in turn, and holds each output
against the plain version at the bf16 tolerance (rtol 1e-2, atol 1e-3).
A variant whose text no longer matches the source raises.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

_SPLIT_PV = """\
        mma_bf16(o[2 * np], lo, bf[0], bf[1]);
        mma_bf16(o[2 * np], hi, bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], lo, bf[2], bf[3]);
        mma_bf16(o[2 * np + 1], hi, bf[2], bf[3]);"""
_MIN_BLOCKS = "constexpr int MIN_BLOCKS = HD <= 80 ? 2 : 1;"
# Q's fragments re-read from shared memory at every k16 step of every tile
# at every head dim (the kernel does so above head dim 128 only)
_Q_SMEM = [("constexpr bool Q_IN_REGS = HD <= 128;",
            "constexpr bool Q_IN_REGS = false;")]

VARIANTS = {
    "checkout": [],
    # p as one bf16 term, as the reference rounds it: fails the tolerance
    "single_p": [(_SPLIT_PV, """\
        mma_bf16(o[2 * np], hi, bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], hi, bf[2], bf[3]);""")],
    "libm_exp2f": [("alpha[r] = exp2_approx(", "alpha[r] = exp2f("),
                   ("sc[j][e] = exp2_approx(", "sc[j][e] = exp2f(")],
    "one_block_hd80": [(_MIN_BLOCKS,
                        "constexpr int MIN_BLOCKS = HD <= 64 ? 2 : 1;")],
    "four_warps": [("constexpr int WARPS = 8;", "constexpr int WARPS = 4;")],
    "q_smem": _Q_SMEM,
    "q_smem_two_blocks": _Q_SMEM + [(_MIN_BLOCKS,
                                     "constexpr int MIN_BLOCKS = 2;")],
}

# (b, s, h, kvh, hd, window), all causal
SHAPES = [(8, 4096, 32, 8, 80, 4096), (2, 4096, 36, 4, 128, None),
          (2, 1000, 32, 8, 80, None)]


def build(tmp: Path) -> dict:
    from repro_torch.kernels import cuda_build
    source = (cuda_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
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
            if "Compiling" in line and "bf16_mma" in line:
                inst = line.split("bf16_mma")[1].split("EEEv")[0]
                print(f"ptxas {name} {inst}: " + " | ".join(
                    x.strip() for x in lines[i + 2:i + 4]), flush=True)
        fn = ctypes.CDLL(str(tmp / f"{name}.so")).flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main() -> int:
    import torch
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("torch_flash_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for b, s, h, kvh, hd, window in SHAPES:
            q, k, v = (torch.randn(b, s, n, hd, device="cuda", generator=gen
                                   ).bfloat16() for n in (h, kvh, kvh))
            want = ref.flash_attention(q, k, v, window=window).float()
            flops = 4.0 * b * h * hd * (s * (s + 1) // 2)
            out = torch.empty_like(q)

            def launch(fn):
                code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b, s, h, kvh, hd, 1, window or 0,
                          0, 1, hd ** -0.5,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed with {code}")

            for _ in range(2):
                for name, fn in entries.items():
                    launch(fn)
                    torch.cuda.synchronize()
                    diff = (out.float() - want).abs()
                    excess = float((diff - 1e-2 * want.abs()).max())
                    for _ in range(3):
                        launch(fn)
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    start.record()
                    for _ in range(20):
                        launch(fn)
                    end.record()
                    torch.cuda.synchronize()
                    ms = start.elapsed_time(end) / 20
                    print(f"{(b, s, h, kvh, hd)} {name:18s} ms {ms:.4f} "
                          f"TFLOP/s {flops / ms / 1e9:.1f} max abs err "
                          f"{float(diff.max()):.3g} within tolerance "
                          f"{excess <= 1e-3}", flush=True)
            del q, k, v, want, out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
