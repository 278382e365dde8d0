#!/usr/bin/env python3
"""Where a guarded firing's time goes, beside the unguarded firing's, on
one GPU.

    python3 tools/torch_guard_profile.py [--firings N]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Two cells of ``chip_smoke.py``'s phase 14, each engine
warmed up with a few firings first:

* matrix powers A^16 (n = 10000, exp; ``UpdateStream`` seed 41): one
  single update unguarded, guarded on the fused path, guarded on the
  snapshot path (a static all-incremental plan);
* the compact left chain (n = 2^20, m = 384, K = 256) under one rank-8
  carrier on 1 % of the rows (``row_local_stream`` seed 42), unguarded
  and guarded.

For each, ``--firings`` firings (3 by default) run under
``torch.profiler`` (CPU and CUDA), and one JSON line gives the wall ms a
firing (host clock, to a synchronize), the device's busy ms (the union
of the kernels' intervals) and summed kernel ms a firing, the kernels a
firing, the kernels that took the most device time and the host
operators that took the most self CPU time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def split(fn, firings: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(firings):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    kern = sorted((e for e in avg if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    host = sorted((e for e in avg if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return {"wall_ms": wall * 1e3 / firings,
            "busy_ms": busy / 1e3 / firings,
            "device_ms": sum(e.self_device_time_total
                             for e in kern) / 1e3 / firings,
            "kernels": sum(e.count for e in kern) / firings,
            "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3
                             / firings, e.count] for e in kern[:6]],
            "top_host_ops": [[e.key[:40], e.self_cpu_time_total / 1e3
                              / firings, e.count] for e in host[:12]]}


def powers(firings: int) -> None:
    import torch
    from repro_torch.apps import MatrixPowers
    from repro_torch.data import UpdateStream
    from repro_torch.guard import GuardConfig
    from repro_torch.plan import TriggerCache, static_plan
    n = 10000
    inputs = MatrixPowers.synthesize(n, seed=0)
    for way in ("unguarded", "guarded_fused", "guarded_snapshot"):
        kw = {} if way == "unguarded" else {"guard": GuardConfig()}
        if way == "guarded_snapshot":
            kw["trigger_cache"] = TriggerCache()
        app = MatrixPowers(n=n, k=16, model="exp", **kw)
        if way == "guarded_snapshot":
            app.engine.set_plan(static_plan(app.engine, "incremental"))
        app.engine.initialize(inputs)
        stream = UpdateStream(n=n, m=n, seed=41)
        for _ in range(3):
            app.engine.apply_update("A", *stream.next_update())
        ups = iter([stream.next_update() for _ in range(firings)])
        rec = split(lambda: app.engine.apply_update("A", *next(ups)),
                    firings)
        print(json.dumps({"cell": f"matrix_powers_n{n}_single", "way": way,
                          **rec}), flush=True)
        del app
        torch.cuda.empty_cache()


def rows(firings: int) -> None:
    import torch
    from repro_torch.core import IncrementalEngine, Program, dim, matmul
    from repro_torch.data import row_local_stream
    from repro_torch.guard import GuardConfig
    n, m, k = 2 ** 20, 384, 256
    p = Program(name="chain")
    X = p.input("X", (dim("N"), dim("M")))
    W1 = p.input("W1", (dim("M"), dim("K")))
    W2 = p.input("W2", (dim("K"), dim("K")))
    Y1 = p.let("Y1", matmul(X, W1))
    p.let("Y2", matmul(Y1, W2))
    p.outputs = ["Y1", "Y2"]
    prog = p.bind_dims(N=n, M=m, K=k)
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {"X": torch.randn(n, m, device="cuda", generator=g),
              "W1": torch.randn(m, k, device="cuda", generator=g) / m ** 0.5,
              "W2": torch.randn(k, k, device="cuda", generator=g) / k ** 0.5}
    for way in ("unguarded", "guarded"):
        kw = {} if way == "unguarded" else {"guard": GuardConfig()}
        eng = IncrementalEngine(prog, {"X": 8}, **kw)
        eng.initialize(inputs)
        s = row_local_stream(n, n // 100, m=m, rank=8, seed=42)
        for _ in range(3):
            eng.apply_update("X", s.next_carrier())
        cs = iter([s.next_carrier() for _ in range(firings)])
        rec = split(lambda: eng.apply_update("X", next(cs)), firings)
        print(json.dumps({"cell": f"compact_chain_n{n}_single", "way": way,
                          **rec}), flush=True)
        del eng
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--firings", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_guard_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    powers(args.firings)
    rows(args.firings)
    return 0


if __name__ == "__main__":
    sys.exit(main())
