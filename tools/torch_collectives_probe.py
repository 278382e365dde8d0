#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives take CUDA tensors, and what
they cost, on one card.

    python3 tools/torch_collectives_probe.py [--world 4]

Sets up a one-rank NCCL group in this process (all-reduce and all-gather
on the card), then ``--world`` gloo ranks in spawned processes, all on
``cuda:(rank % device_count)``, and tries all-reduce (f32 sum, int32
max), the list all-gather, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and broadcast on card tensors, printing each
result or refusal; then times one all-gather of a 2500 × 10000 f32 block
a rank (``chip_smoke.py`` phase 21b's shard of a 10000² view) and ten
all-reduces of a 10000 × 16 f32 tensor (a batch's skinny factor).  One
JSON line a rank, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback


def rank_body(rank: int, world: int, store: str, results) -> None:
    out: dict = {"rank": rank}
    try:
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        mesh = DeviceMesh("cuda", torch.arange(world),
                          mesh_dim_names=("rows",))
        g = mesh.get_group("rows")
        dev = torch.device("cuda", torch.cuda.current_device())

        def full(shape, value, dtype=torch.float32):
            return torch.full(shape, value, dtype=dtype, device=dev)

        def all_reduce():
            x = full((4,), float(rank + 1))
            dist.all_reduce(x, group=g)
            return x.tolist()

        def all_reduce_int32_max():
            x = full((1,), rank, torch.int32)
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
            return x.tolist()

        def all_gather_list():
            x = full((2, 3), float(rank))
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x, group=g)
            return torch.cat(parts)[:, 0].tolist()

        def all_gather_into_tensor():
            x = full((2, 3), float(rank))
            o = torch.empty((2 * world, 3), device=dev)
            dist.all_gather_into_tensor(o, x, group=g)
            return o[:, 0].tolist()

        def reduce_scatter_tensor():
            x = full((world * 2,), 1.0)
            o = torch.empty(2, device=dev)
            dist.reduce_scatter_tensor(o, x, group=g)
            return o.tolist()

        def broadcast():
            x = full((3,), float(rank))
            dist.broadcast(x, src=0, group=g)
            return x.tolist()

        for fn in (all_reduce, all_reduce_int32_max, all_gather_list,
                   all_gather_into_tensor, reduce_scatter_tensor,
                   broadcast):
            try:
                res = fn()
                torch.cuda.synchronize()
                out[fn.__name__] = f"ok {res}"
            except RuntimeError as e:
                out[fn.__name__] = f"refused {e!r}"[:300]
        block = torch.randn(2500, 10000, device=dev)
        parts = [torch.empty_like(block) for _ in range(world)]
        dist.barrier(group=g)
        t0 = time.perf_counter()
        dist.all_gather(parts, block, group=g)
        torch.cuda.synchronize()
        out["all_gather_2500x10000_s"] = time.perf_counter() - t0
        skinny = torch.randn(10000, 16, device=dev)
        dist.barrier(group=g)
        t0 = time.perf_counter()
        for _ in range(10):
            dist.all_reduce(skinny, group=g)
        torch.cuda.synchronize()
        out["all_reduce_10000x16_ms"] = (time.perf_counter() - t0) * 100
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — reported to the parent
        out["error"] = traceback.format_exc()
    results.put(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args()
    import multiprocessing as mp
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not torch.cuda.is_available():
        print("torch_collectives_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = DeviceMesh("cuda", torch.arange(1),
                              mesh_dim_names=("rows",))
            g = mesh.get_group("rows")
            x = torch.ones(3, device="cuda")
            dist.all_reduce(x, group=g)
            parts = [torch.empty_like(x)]
            dist.all_gather(parts, x, group=g)
            print(json.dumps({"nccl_one_rank": dist.get_backend(g),
                              "all_reduce": x.tolist(),
                              "all_gather": parts[0].tolist()}))
        finally:
            dist.destroy_process_group()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=rank_body,
                             args=(r, args.world, os.path.join(tmp, "store"),
                                   results))
                 for r in range(args.world)]
        for p in procs:
            p.start()
        outs = [results.get(timeout=300) for _ in procs]
        for p in procs:
            p.join(timeout=60)
    failed = False
    for out in sorted(outs, key=lambda o: o["rank"]):
        print(json.dumps(out))
        failed |= "error" in out
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
