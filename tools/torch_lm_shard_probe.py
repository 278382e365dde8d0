"""Phase 21, 22 or 24 of ``chip_smoke.py`` alone, with phase 3's checks
of the flash kernels at its per-rank shapes: a quicker run than the whole
script when only the sharded path changed.

    python3 tools/torch_lm_shard_probe.py            # on the H100
    python3 tools/torch_lm_shard_probe.py --rehearse # on the CPU, reduced
    python3 tools/torch_lm_shard_probe.py --phase 24 [--rehearse]
    python3 tools/torch_lm_shard_probe.py --phase 21 # on the H100

Builds every kernel (as the script does), holds the forward with LSE and
K1 at the phase's per-rank shapes (22: 22a's and 22b's on (2, 2), 22f's
on (4, 1), the forward at 22c's, flash decode at 22f's and its LSE
instance at 22g's; 24: zamba2's shared block at 24a's, 24b's and 24f's,
the single device's references, and flash decode at 24c's) against their
plain versions, timed beside SDPA, then runs the phase's four gloo
ranks.  ``--rehearse`` skips the build and the kernel checks and runs the
phase's drives at the reduced widths on the CPU (22 and 24).  Prints the
card's name and power limit first; exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))   # tests/flash_bounds.py

import chip_smoke as cs  # noqa: E402


# the K1 cases of each phase (chip_smoke.K1_CASES' labels)
K1_LABELS = {22: ("shard_danube_",),
             24: ("shard_zamba2_", "zamba2_shard_single_")}


def kernel_checks(phase: int) -> None:
    import torch
    if phase == 21:
        return
    kind = torch.cuda.get_device_name(0)
    _, flops_peak, bytes_peak, bf16_peak, tf32_peak = cs.peaks(kind)
    peaks_ = (bytes_peak, flops_peak, bf16_peak, tf32_peak)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(3)
    for case in cs.K1_CASES:
        label, b, s, h, kvh, hd, window, dt, causal, prefix = case
        if not label.startswith(K1_LABELS[phase]):
            continue
        dtype = getattr(torch, dt)
        q, dout = (torch.randn(b, s, h, hd, device=cs.DEVICE,
                               generator=gen).to(dtype) for _ in range(2))
        k, v = (torch.randn(b, s, kvh, hd, device=cs.DEVICE,
                            generator=gen).to(dtype) for _ in range(2))
        cs.check_flash_bwd(q, k, v, dout, causal, window, peaks_, label,
                           prefix=prefix)
    if phase == 24:
        for label, dtype in (("shard_zamba2_exact_f32", torch.float32),
                             ("shard_zamba2_step_bf16", torch.bfloat16)):
            b, s = (cs.RECUR_SHARD_EXACT if "exact" in label
                    else cs.RECUR_SHARD_STEP[:2])
            q, k, v = (torch.randn(b // 2, s, 16, 64, device=cs.DEVICE,
                                   generator=gen).to(dtype)
                       for _ in range(3))
            cs.check_flash_attention(q, k, v, True, None, peaks_, label)
        n = cs.RECUR_SHARD_PROMPT + cs.RECUR_SHARD_NEW
        for label, h in (("shard_zamba2_decode_f32", 8),
                         ("zamba2_shard_single_decode_f32", 32)):
            q = torch.randn(cs.RECUR_SHARD_EXACT[0], h, 64, device=cs.DEVICE,
                            generator=gen)
            kc, vc = (torch.randn(cs.RECUR_SHARD_EXACT[0], n, h, 64,
                                  device=cs.DEVICE, generator=gen)
                      for _ in range(2))
            cs.check_flash_decode(q, kc, vc, n, peaks_, label)
        return
    b, s = cs.LM_SHARD_MOE
    q = torch.randn(b, s, 16, 128, device=cs.DEVICE, generator=gen)
    k, v = (torch.randn(b, s, 1, 128, device=cs.DEVICE, generator=gen)
            for _ in range(2))
    cs.check_flash_attention(q, k, v, True, None, peaks_,
                             "shard_qwen3_forward_f32")
    b, _, n = cs.LM_SHARD_FSDP_DECODE
    for label, rows, h, kvh in (("shard_danube_fsdp_decode_f32", b // 2, 16,
                                 4),
                                ("danube_fsdp_single_decode_f32", b, 32, 8)):
        q = torch.randn(rows, h, 80, device=cs.DEVICE, generator=gen)
        kc, vc = (torch.randn(rows, n, kvh, 80, device=cs.DEVICE,
                              generator=gen) for _ in range(2))
        cs.check_flash_decode(q, kc, vc, n, peaks_, label)
    for (b, slots, _, _), dtype in ((cs.LM_SHARD_CSEQ_BF16, torch.bfloat16),
                                    (cs.LM_SHARD_CSEQ_F32, torch.float32)):
        q = torch.randn(b, 32, 80, device=cs.DEVICE,
                        generator=gen).to(dtype)
        kc, vc = (torch.randn(b, slots // 4, 8, 80, device=cs.DEVICE,
                              generator=gen).to(dtype) for _ in range(2))
        for n_valid in (slots // 4, 0):
            cs.check_flash_decode_lse(q, kc, vc, n_valid, peaks_,
                                      f"danube_cseq_rank_{dtype}_{n_valid}",
                                      timed=n_valid > 0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--phase", type=int, choices=(21, 22, 24), default=22)
    args = ap.parse_args()
    phase = {21: cs.phase_shard, 22: cs.phase_lm_shard,
             24: cs.phase_recur_shard}[args.phase]
    if args.rehearse:
        if args.phase == 21:
            raise SystemExit("phase 21 runs on the card only")
        phase(rehearse=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_lm_shard_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda_build
    cs.log(cs.nvidia_smi())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_build.build_all()
    cs.log(f"build: {time.perf_counter() - t0:.2f} s")
    kernel_checks(args.phase)
    torch.cuda.empty_cache()
    phase()
    cs.log(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
