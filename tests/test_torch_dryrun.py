"""The port's dry-run (``repro_torch.launch.dryrun``) and
``make_production_mesh`` on fake worlds of 256 and 512 ranks, on the
CPU.  The fake world is a global process group, so its body runs in one
spawned process (``tests/torch_dryrun_workers.py``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dryrun_workers.py"),
         str(tmp)], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("world,shape,axes", [
    ("256", [16, 16], ["data", "model"]),
    ("512", [2, 16, 16], ["pod", "data", "model"])])
def test_production_mesh_is_plan_mesh(results, world, shape, axes):
    """16x16 on 256 ranks, 2x16x16 on 512: plan_mesh's shapes and axes,
    as the reference's make_production_mesh."""
    got = results["meshes"][world]
    assert got["shape"] == shape and got["axes"] == axes
    assert got["plan"] == [shape, axes]


def test_production_mesh_raises_on_a_small_world(results):
    assert "needs 256 ranks" in results["meshes"]["8"]


def test_cell_argument_bytes_are_the_local_blocks(results):
    """A reduced danube train cell on 16x16: the walk's argument bytes
    are the params' local blocks (LM.param_specs), the optimizer's f32
    master and moments of them and its step, and the global batch."""
    got = results["argument_bytes"]
    assert got["chips"] == 256
    assert got["walk"] == got["params"] + got["opt"] + got["batch"]
    assert got["peak"] == got["walk"] + got["temp"] > got["walk"]
    assert got["entries"]["flash_attention_bwd"][0] == 2
    # full remat: the forward with LSE twice a layer (forward, recompute)
    assert got["entries"]["flash_attention_fwd_lse"][0] == 4


def test_fsdp_cell_splits_the_params_over_data(results):
    """The same cell through ``build_cell(rules={"fsdp": "data"},
    microbatches=2)``: the walk's argument bytes are the fsdp blocks and
    their optimizer state, every leaf with an ``"fsdp"`` axis 1/16 of its
    default block (the data axis of 16x16), the norm scales whole; the
    gathers put bytes on the data axis; two microbatches run the flash
    backward twice a layer."""
    got = results["argument_bytes"]["fsdp"]
    assert got["walk"] == got["params"] + got["opt"] + got["batch"]
    ratios = got["ratios"]
    assert ratios["blocks.mlp.w_in"] == ratios["blocks.attn.wq"] == 16
    assert ratios["embed.table"] == 16
    assert ratios["blocks.ln1.scale"] == ratios["final_norm.scale"] == 1
    assert got["params"] < results["argument_bytes"]["params"]
    assert got["wire"]["data"] > 0
    assert got["entries"]["flash_attention_bwd"][0] == 4


@pytest.mark.parametrize("cell,status,reason", [
    ("zamba2-1.2b/train_4k", "ok", ""),
    ("hubert-xlarge/decode_32k", "skipped", "encoder-only")])
def test_recurrent_and_skipped_cells(results, cell, status, reason):
    """zamba2's train_4k walks on 16x16 (its Mamba2 blocks split by whole
    heads, the packed in_proj's local block: 4 of 64 heads); hubert has
    no decode cell, as the reference skips it."""
    got = results["cells"][cell]
    assert got["status"] == status and reason in got["reason"]


def test_cli_writes_json_that_report_md_renders(results):
    """The CLI exits 0 and its JSON renders: a row with each walked
    cell's three terms and bottleneck, and a row for the skipped cell."""
    cli = results["cells"]["cli"]
    assert cli["code"] == 0
    assert cli["statuses"] == ["ok", "ok", "skipped"]
    table = cli["table"]
    assert "| h2o-danube-1.8b | decode_32k |" in table
    assert "| zamba2-1.2b | train_4k |" in table
    assert "memory" in table
    assert "skipped:" in table and "refused" not in table
