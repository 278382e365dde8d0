"""Multi-pod dry-run: walk one step of every (arch × shape × mesh) cell
on meta tensors.

One process opens a fake world of 256 ranks (or 512: two pods) with
``torch.distributed``'s ``"fake"`` backend and builds the production
mesh over it (``launch/mesh.py``: 16×16 or 2×16×16).  Nothing is
allocated: under ``use_sharding`` rank 0's local blocks of the params,
the optimizer state (``opt_state_axes``: the params' placement) and the
batch or the decode cache are meta tensors, and one step --
``make_train_step``, ``make_prefill_step`` or ``make_serve_step`` -- runs
on them under the roofline walk (``roofline/op_walk.py``).  The walk's
argument, output, temp and peak bytes say whether a chip holds the cell;
its FLOPs, bytes and collectives give the roofline terms against the
H100's data sheet (``roofline/hw.py``): predictions, not measurements.
The collectives run on the fake backend (they move nothing) and are
priced by the ring formulas over their mesh axis.  The reference's
``remat="full"`` is kept.  A train cell hands the step the global batch
(the port's step takes its data rows); a prefill or decode cell the
rank's rows and cache.

Cells skip as the reference skips them (``shape_applicable``); every
other cell walks (``"status": "ok"``), the recurrent families' too.
``build_cell`` and ``run_cell`` take the reference's ``rules=`` (placement
rules over the defaults, e.g. ``{"fsdp": "data"}`` or ``{"fsdp":
("pod", "data")}``, which split the params and the optimizer state over
the data axes too; ``{"seq_sp": "model"}``, the residual stream over the
sequence between blocks; ``{"cache_seq": "model"}``, the decode cache's
slots) and ``microbatches=``; as in the reference, the CLI sets
neither, and a run with rules names its cells by ``tag``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-32b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Results go to ``results/dryrun_torch/`` (``--results DIR`` elsewhere), one
JSON a cell with the reference's keys (``walk_s`` in place of
``lower_s`` and ``compile_s``); ``python -m
repro_torch.roofline.report_md`` renders them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..configs.base import ModelConfig
from ..data.pipeline import make_batch_specs
from ..dist.sharding import shard_tree, use_sharding
from ..models.model import LM
from ..roofline.analysis import (analyze_step, model_bytes_estimate,
                                 model_flops_estimate)
from ..roofline.op_walk import Walk
from ..serve.engine import make_prefill_step, make_serve_step
from ..train.optimizer import adamw_init
from ..train.train_step import (TrainState, data_rows, make_train_step,
                                require_grad)
from .mesh import POD_CHIPS, make_production_mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

_MESHES: Dict[bool, object] = {}


class SkipCell(Exception):
    pass


def _dryrun_config(cfg: ModelConfig, overrides: Optional[Dict] = None
                   ) -> ModelConfig:
    """Dry-run defaults: full remat (activation fit at pod scale)."""
    base = dataclasses.replace(cfg, remat="full")
    if overrides:
        base = dataclasses.replace(base, **overrides)
    return base


def fake_world(world: int) -> None:
    """A process group of ``world`` ranks on the ``"fake"`` backend, this
    process rank 0 (another world's group is torn down first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
        _MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(multi_pod: bool):
    """The production mesh over a fake world of its size, made once a
    world."""
    fake_world(2 * POD_CHIPS if multi_pod else POD_CHIPS)
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = make_production_mesh(multi_pod,
                                                  device_type="cpu")
    return _MESHES[multi_pod]


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: Optional[Dict] = None,
               rules: Optional[Dict] = None,
               microbatches: int = 1) -> Tuple[Walk, Dict]:
    """Rank 0's local blocks of one cell on meta, its step walked: returns
    (walk, meta).  ``rules`` override the placement rules (the
    reference's ``use_sharding(mesh, rules=...)``, e.g. ``{"fsdp":
    "data"}``), ``microbatches`` splits a train cell's batch.  Raises
    :class:`SkipCell` for a shape the arch skips."""
    cfg = _dryrun_config(get_config(arch), overrides)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    mesh = production_mesh(multi_pod)
    model = LM(cfg, device="meta")
    t0 = time.perf_counter()
    with use_sharding(mesh, rules=rules):
        params = shard_tree(model.init(None), model.param_specs())
        if shape.kind == "train":
            state = TrainState(require_grad(params), adamw_init(params),
                               torch.Generator())
            batch = make_batch_specs(cfg, shape)
            step = make_train_step(model, microbatches=microbatches)
            args = (state, batch)
        elif shape.kind == "prefill":
            step = make_prefill_step(model)
            args = (params, data_rows(make_batch_specs(cfg, shape)))
        else:
            long_ctx = shape.seq_len > 100_000
            specs = model.cache_specs(shape.global_batch, shape.seq_len,
                                      long_context=long_ctx)
            step = make_serve_step(model, specs)
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     specs)
            # the rank's rows, as the cache's batch dimension resolves
            rows = shard_tree({"r": torch.empty(shape.global_batch,
                                                device="meta")},
                              {"r": ("batch",)})["r"].shape[0]
            token = torch.empty((rows, 1), dtype=torch.int32,
                                device="meta")
            args = (params, cache, token, shape.seq_len - 1)
        walk = Walk(args)
        with torch.set_grad_enabled(shape.kind == "train"), walk:
            out = step(*args)
        walk.finish(out)
    meta = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "chips": mesh.size(),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "model_flops": model_flops_estimate(cfg, shape),
            "model_bytes": model_bytes_estimate(cfg, shape),
            "bf16": cfg.dtype == "bfloat16",
            "walk_s": round(time.perf_counter() - t0, 1)}
    return walk, meta


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             force: bool = False, overrides: Optional[Dict] = None,
             rules: Optional[Dict] = None, tag: str = "baseline",
             microbatches: int = 1, verbose: bool = True,
             results_dir: str = RESULTS_DIR) -> Dict:
    os.makedirs(results_dir, exist_ok=True)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    key = f"{arch}__{shape_name}__{mesh_name}__{tag}".replace("/", "_")
    out_path = os.path.join(results_dir, key + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "tag": tag}
    try:
        walk, meta = build_cell(arch, shape_name, multi_pod,
                                overrides=overrides, rules=rules,
                                microbatches=microbatches)
    except SkipCell as e:
        result = {**head, "status": "skipped", "reason": str(e)}
    else:
        report = analyze_step(
            walk, arch=arch, shape=shape_name, mesh_name=mesh_name,
            chips=meta["chips"], model_flops=meta["model_flops"],
            model_bytes=meta["model_bytes"])
        result = {**meta, "tag": tag, "status": "ok",
                  "memory_analysis": report.memory_per_chip,
                  "roofline": report.to_dict(),
                  "entries": {k: list(v)
                              for k, v in walk.entry_counts().items()},
                  "aten_ops": walk.ops}
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    if verbose:
        if result["status"] != "ok":
            print(f"[dryrun] {result['status'].upper()} {key}: "
                  f"{result['reason']}", flush=True)
        else:
            mem, r = result["memory_analysis"], result["roofline"]
            print(f"[dryrun] OK {key}: walk {result['walk_s']:.1f}s | "
                  f"mem/chip arg={mem['argument_bytes'] / 2**30:.2f}GiB "
                  f"temp={mem['temp_bytes'] / 2**30:.2f}GiB "
                  f"peak={mem['peak_bytes'] / 2**30:.2f}GiB | "
                  f"T(comp/mem/coll)={r['t_compute'] * 1e3:.1f}/"
                  f"{r['t_memory'] * 1e3:.1f}/"
                  f"{r['t_collective'] * 1e3:.1f} ms | "
                  f"bottleneck={r['bottleneck']} "
                  f"frac={r['roofline_fraction']:.2f} "
                  f"bwfrac={r['bandwidth_fraction']:.2f}", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", type=str, default="baseline")
    ap.add_argument("--results", type=str, default=RESULTS_DIR,
                    help="directory of the cells' JSON files")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    # mesh by mesh, so that the fake world is opened once each
    cells = [(a, s, mp) for mp in meshes for a in archs for s in shapes]

    t0 = time.perf_counter()
    failures, status = [], {}
    try:
        for a, s, mp in cells:
            try:
                res = run_cell(a, s, mp, force=args.force, tag=args.tag,
                               results_dir=args.results)
                status[res["status"]] = status.get(res["status"], 0) + 1
            except Exception as e:   # noqa: BLE001 — listed below
                traceback.print_exc()
                failures.append((a, s, mp, str(e)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    wall = time.perf_counter() - t0
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print(f"[dryrun] all {len(cells)} cells done in {wall:.1f} s: "
          + ", ".join(f"{n} {k}" for k, n in sorted(status.items())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
