"""Render results/dryrun_torch/*.json (``python -m
repro_torch.launch.dryrun``) into roofline tables, the JAX package's
``roofline/report_md.py`` rendering; skipped cells get a row with their
reason, each in its own mesh's table.

  PYTHONPATH=src python -m repro_torch.roofline.report_md [tag]
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List


def load(results_dir: str, tag: str = "baseline") -> List[Dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(results_dir, f"*__{tag}.json"))):
        rows.append(json.load(open(f)))
    return rows


def render(rows: List[Dict], mesh: str = "16x16") -> str:
    out = ["| arch | shape | T_comp (ms) | T_mem (ms) | T_coll (ms) | "
           "bottleneck | MFU-bound | BW-frac | useful/HLO | mem/chip (GiB) |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        if d.get("mesh") != mesh:
            continue
        if d.get("status") == "skipped":
            reason = d["reason"].split(":")[0]
            out.append(f"| {d['arch']} | {d['shape']} | — | — | — | "
                       f"skipped: {reason} | — | — | — | — |")
            continue
        r = d["roofline"]
        mem = d["memory_analysis"]
        peak = (mem["argument_bytes"] + mem["temp_bytes"]) / 2 ** 30
        out.append(
            f"| {d['arch']} | {d['shape']} | {r['t_compute']*1e3:.0f} | "
            f"{r['t_memory']*1e3:.0f} | {r['t_collective']*1e3:.0f} | "
            f"{r['bottleneck']} | {r['roofline_fraction']:.3f} | "
            f"{r['bandwidth_fraction']:.3f} | {r['useful_flops_ratio']:.2f} | "
            f"{peak:.1f} |")
    return "\n".join(out)


def main():
    tag = sys.argv[1] if len(sys.argv) > 1 else "baseline"
    results_dir = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                               "results", "dryrun_torch")
    rows = load(results_dir, tag)
    for mesh in ("16x16", "2x16x16"):
        print(f"\n### mesh {mesh} ({tag})\n")
        print(render(rows, mesh))


if __name__ == "__main__":
    main()
