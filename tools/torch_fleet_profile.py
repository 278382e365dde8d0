#!/usr/bin/env python3
"""Where a row-local fleet claim's time goes, on one GPU.

    python3 tools/torch_fleet_profile.py [--claims N] [--cprofile]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit, in a process of its own (a long process's profiler can
drop device events).  The compact left chain of ``chip_smoke.py``'s
phase 15b (n = 2^20, m = 384, K = 256) as one fleet tenant, guarded and
unguarded; every tenant engine writes out of place, so each claim first
copies the row views (X, Y1, Y2) the row kernel then updates in place.
Each carrier is rank 8 on 1 % of the rows (``row_local_stream`` seed
42).  Per variant, one JSON line gives:

* the copy alone: the row views cloned, ms by CUDA events, and its
  bytes (each view read and written once);
* ``--claims`` claims of one carrier each (5 by default; the first is a
  warm-up), wall ms to a synchronize, and the caching allocator's device
  allocations and frees over them;
* one more claim under ``torch.profiler`` (CPU and CUDA): wall ms, the
  device's summed ms, the kernels and copies that took the most device
  time and the host operations that took the most self time;
* with ``--cprofile``, ``--claims`` more claims under ``cProfile``: the
  Python functions with the most cumulative time a claim.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def profiled(fn, top: int = 10) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    dev = sorted((e for e in ka if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    host = sorted((e for e in ka if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    return {"wall_ms": wall,
            "device_ms": sum(e.self_device_time_total for e in dev) / 1e3,
            "device": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                       for e in dev[:top]],
            "host": [[e.key[:50], e.self_cpu_time_total / 1e3, e.count]
                     for e in host[:top]]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--claims", type=int, default=5)
    ap.add_argument("--cprofile", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_fleet_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.data import row_local_stream
    from repro_torch.fleet import FleetConfig, FleetScheduler, TenantSpec
    from repro_torch.kernels import cuda_build
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all()
    print(cs.nvidia_smi(), flush=True)
    n, m, k = cs.CHAIN_N, cs.CHAIN_M, cs.CHAIN_K
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {"X": torch.randn(n, m, device="cuda", generator=g),
              "W1": torch.randn(m, k, device="cuda", generator=g) / m ** .5,
              "W2": torch.randn(k, k, device="cuda", generator=g) / k ** .5}
    for guarded in (True, False):
        fleet = FleetScheduler(FleetConfig(lease_ttl=60.0))
        tenant = fleet.add_tenant(TenantSpec(
            "chain", cs.chain_program(n, m, k), {"X": cs.CHAIN_RANK},
            guarded=guarded), inputs)
        eng = tenant.engine
        s = row_local_stream(n, cs.CHAIN_ROWS, m=m, rank=cs.CHAIN_RANK,
                             seed=42)
        fn = eng._rowlocal_trigger_fn("X", cs.CHAIN_RANK)
        copy_ms = cs.time_ms(lambda: [eng.views[v].clone()
                                      for v in fn.row_views], 20.0)
        copy_bytes = 2 * sum(4 * eng.views[v].numel() for v in fn.row_views)

        def claim():
            fleet.submit("chain", "X", s.next_carrier())
            if fleet.run_claim("w") != "committed":
                raise AssertionError("the claim did not commit")
        walls = []
        stats0 = torch.cuda.memory_stats()
        for _ in range(args.claims):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            claim()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        stats1 = torch.cuda.memory_stats()
        rec = {"guarded": guarded, "row_views": list(fn.row_views),
               "copy_ms": copy_ms, "copy_bytes": copy_bytes,
               "claim_wall_ms": walls,
               "claim_wall_ms_median": statistics.median(walls[1:]),
               "device_allocs": stats1.get("num_device_alloc", 0)
               - stats0.get("num_device_alloc", 0),
               "device_frees": stats1.get("num_device_free", 0)
               - stats0.get("num_device_free", 0),
               "profiled_claim": profiled(claim)}
        if args.cprofile:
            prof = cProfile.Profile()
            prof.runcall(lambda: [claim() for _ in range(args.claims)])
            st = pstats.Stats(prof)
            rows = sorted(((key, cum) for key, (_, _, _, cum, _)
                           in st.stats.items()), key=lambda r: -r[1])
            rec["cprofile_ms_a_claim"] = [
                [f"{Path(f).name}:{line}({fn})", cum / args.claims * 1e3]
                for (f, line, fn), cum in rows[:25]]
        print(json.dumps(rec), flush=True)
        del fleet, tenant, eng, fn
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
