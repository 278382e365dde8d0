"""The body of ``tests/test_torch_dryrun.py``, run in a spawned process:
the dry-run opens a fake world of 256 or 512 ranks (a global process
group), which the test process must not hold.

    python tests/torch_dryrun_workers.py RESULTS_DIR

Prints one JSON object of results on its last line.
"""

from __future__ import annotations

import dataclasses
import json
import sys


def _nbytes(tree, itemsize=None) -> int:
    """Bytes of a tree's leaves (at ``itemsize`` bytes an element if
    given)."""
    if isinstance(tree, dict):
        return sum(_nbytes(v, itemsize) for v in tree.values())
    return tree.numel() * (itemsize or tree.element_size())


def meshes() -> dict:
    """make_production_mesh on fake worlds of 256 and 512 ranks (shape,
    axes, plan_mesh's), then on a world of 8 (its error)."""
    from repro_torch.dist.fault_tolerance import plan_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    out = {}
    for multi, world in ((False, 256), (True, 512)):
        mesh = dryrun.production_mesh(multi)
        out[str(world)] = {
            "shape": list(mesh.shape), "axes": list(mesh.mesh_dim_names),
            "plan": [list(x) for x in plan_mesh(
                world, 16, multi_pod_size=256 if multi else None)]}
    dryrun.fake_world(8)
    try:
        make_production_mesh(device_type="cpu")
        out["8"] = None
    except ValueError as e:
        out["8"] = str(e)
    return out


def argument_bytes() -> dict:
    """build_cell of a reduced danube (16 query heads, vocab 512, so the
    model axis splits heads, ff and vocab) on 16x16, train_4k: the walk's
    argument bytes, and the sum of LM.param_specs' local blocks, the
    optimizer's (f32 master and moments of those blocks, the step) and
    the global batch."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import make_batch_specs
    from repro_torch.dist.sharding import shard_tree, use_sharding
    from repro_torch.launch import dryrun
    from repro_torch.models.model import LM
    red = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(),
                              n_heads=16, n_kv_heads=4, dtype="bfloat16")
    over = {f.name: getattr(red, f.name)
            for f in dataclasses.fields(red) if f.name != "remat"}
    walk, meta = dryrun.build_cell("h2o-danube-1.8b", "train_4k", False,
                                   overrides=over)
    cfg = dataclasses.replace(red, remat="full")
    model = LM(cfg, device="meta")
    with use_sharding(dryrun.production_mesh(False)):
        local = shard_tree(model.init(None), model.param_specs())
    params = _nbytes(local)
    # f32 master, m and v of the local blocks, and the int32 step
    opt = 3 * _nbytes(local, 4) + torch.zeros(
        (), dtype=torch.int32).element_size()
    batch = _nbytes(make_batch_specs(cfg, SHAPES["train_4k"]))
    return {"walk": walk.argument_bytes, "params": params, "opt": opt,
            "batch": batch, "chips": meta["chips"],
            "entries": {k: list(v) for k, v in walk.entry_counts().items()},
            "peak": walk.peak_bytes, "temp": walk.temp_bytes,
            "fsdp": fsdp_cell(over, cfg, local, opt - 3 * _nbytes(local, 4),
                              batch)}


def fsdp_cell(over: dict, cfg, default_local, step_bytes: int,
              batch: int) -> dict:
    """The same cell under ``rules={"fsdp": "data"}`` in 2 microbatches:
    the walk's argument bytes, the local blocks' (each leaf's bytes
    against its default block's), the wire bytes by mesh axis."""
    from repro_torch.dist.sharding import shard_tree, use_sharding
    from repro_torch.launch import dryrun
    from repro_torch.models.model import LM
    rules = {"fsdp": "data"}
    walk, _ = dryrun.build_cell("h2o-danube-1.8b", "train_4k", False,
                                overrides=over, rules=rules, microbatches=2)
    model = LM(cfg, device="meta")
    with use_sharding(dryrun.production_mesh(False), rules):
        local = shard_tree(model.init(None), model.param_specs())

    def ratios(a, b, prefix=""):
        out = {}
        for k in a:
            if isinstance(a[k], dict):
                out.update(ratios(a[k], b[k], f"{prefix}{k}."))
            else:
                out[prefix + k] = _nbytes(b[k]) // _nbytes(a[k])
        return out

    by_axis = {}
    for op in walk.collectives.ops:
        by_axis[op.line] = by_axis.get(op.line, 0.0) + op.wire_bytes
    return {"walk": walk.argument_bytes, "params": _nbytes(local),
            "opt": 3 * _nbytes(local, 4) + step_bytes, "batch": batch,
            "ratios": ratios(local, default_local), "wire": by_axis,
            "entries": {k: list(v) for k, v in walk.entry_counts().items()}}


def cells(results: str) -> dict:
    """A zamba2 cell (walked on a model axis of 16) and an encoder-only
    decode cell (skipped) through run_cell; then the CLI on a full danube
    decode cell, its JSON rendered by report_md."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import report_md
    out = {}
    for arch, shape in (("zamba2-1.2b", "train_4k"),
                        ("hubert-xlarge", "decode_32k")):
        res = dryrun.run_cell(arch, shape, False, force=True,
                              results_dir=results, verbose=False)
        out[f"{arch}/{shape}"] = {"status": res["status"],
                                  "reason": res.get("reason", "")}
    code = dryrun.main(["--arch", "h2o-danube-1.8b", "--shape",
                        "decode_32k", "--results", results, "--force"])
    rows = report_md.load(results)
    out["cli"] = {"code": code, "statuses": sorted(
        r["status"] for r in rows), "table": report_md.render(rows)}
    return out


def main() -> int:
    results = sys.argv[1]
    out = {"meshes": meshes(), "argument_bytes": argument_bytes(),
           "cells": cells(results)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
