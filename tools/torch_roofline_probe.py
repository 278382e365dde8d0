"""Phase 23 of ``chip_smoke.py`` alone, after phase 3's K1 cases: a
quicker run than the whole script when only the roofline walk, the
dry-run or K1's bound changed.

    python3 tools/torch_roofline_probe.py      # on the H100

Builds every kernel (as the script does), holds K1 and the forward with
LSE at every ``K1_CASES`` case against their plain versions (bf16 within
``tests/flash_bounds.py``'s bound), then runs phase 23: the roofline
walk of phase 19a's training step and phase 10's decode step on the card
against meta, the walked peak against ``max_memory_allocated``, and the
dry-run CLI on four cells.  Prints the card's name and power limit
first; exits non-zero if a check fails.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))   # tests/flash_bounds.py

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_roofline_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda_build
    cs.log(cs.nvidia_smi())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    _, flops_peak, bytes_peak, bf16_peak, tf32_peak = cs.peaks(kind)
    t0 = time.perf_counter()
    cuda_build.build_all()
    cs.log(f"build: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cs.check_flash_bwd_kernels((bytes_peak, flops_peak, bf16_peak,
                                tf32_peak))
    cs.log(f"K1 cases: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    cs.phase_roofline()
    cs.log(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
