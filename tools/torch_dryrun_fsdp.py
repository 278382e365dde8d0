"""The dry-run's cells under placement rules beside the baseline:
``launch/dryrun.py``'s ``run_cell`` with ``rules=`` (the reference's
rules, which the CLI does not set), by default ``{"fsdp": "data"}`` on
16x16 and ``{"fsdp": ("pod", "data")}`` on 2x16x16 at tag ``fsdp`` for
the train_4k cells, and at tag ``baseline`` with the default rules, on
meta over a fake world (no card).

    PYTHONPATH=src python3 tools/torch_dryrun_fsdp.py
    PYTHONPATH=src python3 tools/torch_dryrun_fsdp.py --archs qwen1.5-32b
    PYTHONPATH=src python3 tools/torch_dryrun_fsdp.py --no-baseline \
        --microbatches 2 --archs command-r-plus-104b
    PYTHONPATH=src python3 tools/torch_dryrun_fsdp.py --no-baseline \
        --shape decode_32k --rules '{"cache_seq": "model"}' \
        --archs qwen1.5-32b command-r-plus-104b
    PYTHONPATH=src python3 tools/torch_dryrun_fsdp.py --no-baseline \
        --rules '{"fsdp": "data", "seq_sp": "model"}' --meshes single \
        --archs command-r-plus-104b

``--rules`` (JSON) replaces the 16x16 rules; on 2x16x16 an ``"fsdp"``
onto ``"data"`` becomes ``("pod", "data")``, the other rules as given.
The tag is the rules' names joined (``fsdp``, ``cache_seq``,
``fsdp_seq_sp``; ``_mbN`` with microbatches).  Writes the cells' JSON
files to ``results/dryrun_torch/`` (``--results`` elsewhere) and prints,
for each cell, the baseline's and the rules' memory a chip (arguments,
temp, their sum: the report's mem/chip) and roofline terms, then each
tag's ``report_md`` tables.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCHS = ("command-r-plus-104b", "qwen1.5-32b", "qwen3-moe-235b-a22b",
         "starcoder2-7b", "h2o-danube-1.8b")
FSDP = {"fsdp": "data"}


def pod_rules(rules: dict) -> dict:
    """The 16x16 ``rules`` on 2x16x16: ``"fsdp"`` onto ``"data"`` also
    over the pods, as the reference's rule for the multi-pod mesh."""
    return {k: (("pod", "data") if k == "fsdp" and v == "data" else v)
            for k, v in rules.items()}


def summary(res: dict) -> dict:
    """A cell's memory a chip in GiB and its roofline terms in ms."""
    if res["status"] != "ok":
        return {"status": res["status"], "reason": res.get("reason")}
    mem, r = res["memory_analysis"], res["roofline"]
    gib = 2 ** 30
    return {"arg_gib": round(mem["argument_bytes"] / gib, 2),
            "temp_gib": round(mem["temp_bytes"] / gib, 2),
            "mem_gib": round((mem["argument_bytes"] + mem["temp_bytes"])
                             / gib, 2),
            "t_comp_ms": round(r["t_compute"] * 1e3, 1),
            "t_mem_ms": round(r["t_memory"] * 1e3, 1),
            "t_coll_ms": round(r["t_collective"] * 1e3, 1),
            "bottleneck": r["bottleneck"], "walk_s": res["walk_s"]}


def main() -> int:
    from repro_torch.launch import dryrun
    from repro_torch.roofline import report_md
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+", default=list(ARCHS))
    ap.add_argument("--results", default=dryrun.RESULTS_DIR)
    ap.add_argument("--no-baseline", action="store_true",
                    help="walk the fsdp cells only")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="split the rules' cells' batch (tag ..._mbN)")
    ap.add_argument("--rules", default=json.dumps(FSDP),
                    help="the 16x16 placement rules, JSON (default "
                         "'{\"fsdp\": \"data\"}')")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--meshes", choices=["single", "multi", "both"],
                    default="both")
    args = ap.parse_args()
    t0 = time.perf_counter()
    rules = json.loads(args.rules)
    tag = "_".join(sorted(rules)) + (
        "" if args.microbatches == 1 else f"_mb{args.microbatches}")
    multis = {"single": (False,), "multi": (True,),
              "both": (False, True)}[args.meshes]
    rows = []
    try:
        for multi in multis:              # mesh by mesh: one fake world each
            placed = pod_rules(rules) if multi else rules
            for arch in args.archs:
                row = {"arch": arch, "shape": args.shape,
                       "mesh": "2x16x16" if multi else "16x16",
                       "rules": placed}
                if not args.no_baseline:
                    row["baseline"] = summary(dryrun.run_cell(
                        arch, args.shape, multi, force=True,
                        results_dir=args.results, verbose=False))
                row[tag] = summary(dryrun.run_cell(
                    arch, args.shape, multi, force=True, rules=placed,
                    tag=tag, microbatches=args.microbatches,
                    results_dir=args.results, verbose=False))
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    for t in ("baseline", tag):
        cells = [r for r in report_md.load(args.results, t)
                 if r["shape"] == args.shape and r["arch"] in args.archs]
        for mesh in ("16x16", "2x16x16"):
            print(f"\n### {args.shape}, mesh {mesh} ({t})\n")
            print(report_md.render(cells, mesh))
    print(f"\n[dryrun_fsdp] {len(rows)} rows in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
