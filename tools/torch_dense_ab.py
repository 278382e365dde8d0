#!/usr/bin/env python3
"""Side-by-side timing of the PyTorch port's dense update path on one GPU.

    python3 tools/torch_dense_ab.py [--profile] ROOT [ROOT ...]

Each ROOT is a checkout of the repository (for example the parent commit
unpacked beside this one).  For each ROOT in the order given, a fresh
process imports that checkout's ``repro_torch``, initializes matrix
powers A^16 (n = 10000, exp model, seed 0) on the card, applies one
warm-up update and one warm-up batch of 16, then 8 single updates and
three batches of 16 (``UpdateStream``, seed 1), and prints one JSON
line: the median seconds per single update and the median over the
three batches of the seconds per update (each batch's beside it), host
clock around work that ends in ``torch.cuda.synchronize()``.  The
warm-up batch keeps the first batch's one-time costs (allocations of
new sizes) out of the timing.  Give the roots as parent, change,
change, parent to see the spread beside the difference.

With ``--profile`` each root also runs one more single update and one
more batch of 16 under ``torch.profiler`` and adds their split to its
line: wall ms, summed and busy (union of intervals) device ms, kernels
launched, the kernels that took the most device time, and the host
operators that took the most self CPU time.
"""

from __future__ import annotations

import subprocess
import sys

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.apps import MatrixPowers
from repro_torch.data import UpdateStream
torch.backends.cuda.matmul.allow_tf32 = False
n = 10000
app = MatrixPowers(n=n, k=16, model="exp")
app.engine.initialize(MatrixPowers.synthesize(n, seed=0))
stream = UpdateStream(n=n, m=n, seed=1)
ups = [stream.next_update() for _ in range(1 + 16 + 8 + 3 * 16)]
eng = app.engine
eng.apply_update("A", *ups[0], block=True)
eng.apply_updates("A", ups[1:17], block=True)
single = []
for u, v in ups[17:25]:
    t0 = time.perf_counter()
    eng.apply_update("A", u, v, block=True)
    single.append(time.perf_counter() - t0)
batches = []
for i in range(25, len(ups), 16):
    t0 = time.perf_counter()
    eng.apply_updates("A", ups[i:i + 16], block=True)
    batches.append((time.perf_counter() - t0) / 16)
out = {"root": sys.argv[1], "device": torch.cuda.get_device_name(0),
       "apply_update_s_median": statistics.median(single),
       "apply_updates_s_per_update": statistics.median(batches),
       "apply_updates_s_per_update_runs": batches}
if sys.argv[2] == "1":
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def split(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        avg = prof.key_averages()
        kern = sorted((e for e in avg if e.device_type == DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        host = sorted((e for e in avg if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, float("-inf")
        for start, stop in spans:
            if stop > end:
                busy += stop - max(start, end)
                end = stop
        return {"wall_ms": wall * 1e3,
                "device_ms": sum(e.self_device_time_total
                                 for e in kern) / 1e3,
                "busy_ms": busy / 1e3,
                "kernels": sum(e.count for e in kern),
                "top_kernels": [[e.key[:70], e.self_device_time_total / 1e3,
                                 e.count] for e in kern[:6]],
                "top_host_ops": [[e.key[:50], e.self_cpu_time_total / 1e3,
                                  e.count] for e in host[:10]]}

    more = [stream.next_update() for _ in range(17)]
    out["profile_single"] = split(
        lambda: eng.apply_update("A", *more[0], block=True))
    out["profile_batch16"] = split(
        lambda: eng.apply_updates("A", more[1:], block=True))
print(json.dumps(out))
"""


def main() -> int:
    args = sys.argv[1:]
    profile = "--profile" in args
    roots = [a for a in args if a != "--profile"]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        out = subprocess.run([sys.executable, "-c", CHILD, root,
                              "1" if profile else "0"],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
