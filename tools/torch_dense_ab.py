#!/usr/bin/env python3
"""Side-by-side timing of the PyTorch port's dense update path on one GPU.

    python3 tools/torch_dense_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (for example the parent commit
unpacked beside this one).  For each ROOT in the order given, a fresh
process imports that checkout's ``repro_torch``, initializes matrix
powers A^16 (n = 10000, exp model, seed 0) on the card, applies one
warm-up update, 8 single updates and one batch of 16 (``UpdateStream``,
seed 1), and prints one JSON line: the median seconds per single update
and the seconds per update of the batch, host clock around work that
ends in ``torch.cuda.synchronize()``.  Give the roots as parent, change,
change, parent to see the spread beside the difference.
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
ups = [stream.next_update() for _ in range(25)]
eng = app.engine
eng.apply_update("A", *ups[0], block=True)
single = []
for u, v in ups[1:9]:
    t0 = time.perf_counter()
    eng.apply_update("A", u, v, block=True)
    single.append(time.perf_counter() - t0)
t0 = time.perf_counter()
eng.apply_updates("A", ups[9:], block=True)
batch = (time.perf_counter() - t0) / 16
print(json.dumps({"root": sys.argv[1], "device": torch.cuda.get_device_name(0),
                  "apply_update_s_median": statistics.median(single),
                  "apply_updates_s_per_update": batch}))
"""


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, "-c", CHILD, root],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
