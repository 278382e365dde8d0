"""The ``"fsdp"`` rule on four gloo ranks, against the JAX package's
single-device paths and the port's single device, on the CPU.

Under ``use_sharding(mesh, rules={"fsdp": "data"})`` the params and the
optimizer state split over the data axis too (the reference's rule;
``{"fsdp": ("pod", "data")}`` on a pod mesh), each block gathers its
params whole before it runs (``dist.sharding.gather_from_data``, whose
backward reduce-scatters the gradient) and the step's gradient mean does
not sum those leaves again.  One spawned world of four ranks
(``tests/torch_fsdp_workers.py``) runs every scenario on the (2, 2) and
(4, 1) meshes: every family whose params carry ``"fsdp"`` axes (dense,
moe, hybrid, ssm) against ``jax.value_and_grad`` and the port's single
device, a clipped step, compression of leaves split over data and model,
checkpoints across the rule, a decode, and the gather itself.  The same
world runs the ``"seq_sp"`` rule (Megatron's sequence parallelism: the
residual stream split over the sequence between blocks) on (2, 2) and
(1, 4), against the reference's single device too, and the sequence
collectives.  Bounds: 1e-5, the port's sharded paths summing in other
orders only; the seq_sp losses 1e-6.
"""

import json
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.dist.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.models import build_model as jax_build
from repro.train import optimizer as jax_opt
from repro.train.train_step import TrainState as JaxTrainState
from repro_torch.configs import get_config
from repro_torch.dist import CheckpointManager, sharding
from repro_torch.dist.sharding import MeshShape, ShardingCtx, use_sharding
from repro_torch.models import LM, params_from_numpy
from repro_torch.train import (TrainState, adamw_init, compress_tree,
                               decompress_tree, init_compression,
                               make_train_step, require_grad)
from repro_torch.train.optimizer import leaves
from repro_torch.train.train_step import mean_over_data

import torch_fsdp_workers as w
import torch_shard_workers

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _assert_tree(got, want, **tol):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   err_msg=k, **tol)


def _value_and_grad(cfg, params, batch):
    """The reference's single-device loss and gradients (numpy)."""
    model = jax_build(cfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(p, b)[0]))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_grads(family, case):
    """The port's single-device loss and gradients."""
    model = LM(w.family_cfg(get_config, family), device="cpu")
    params = require_grad(params_from_numpy(case["params"], "cpu"))
    loss, _ = model.loss(params, case["batch"])
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), {k: g.numpy() for (k, _), g in zip(
        sorted(_flat(params)), grads)}


def _references(inputs) -> dict:
    refs = {}
    for family in w.FAMILIES:
        case = inputs[family]
        refs[family] = {
            "jax": _value_and_grad(w.family_cfg(jax_config, family),
                                   case["params"], case["batch"]),
            "port": _port_grads(family, case)}
    # the dense family's clipped step and compression on one device
    model = LM(w.family_cfg(get_config, "dense"), device="cpu")
    params = require_grad(params_from_numpy(inputs["dense"]["params"],
                                            "cpu"))
    state = TrainState(params, adamw_init(params), torch.Generator())
    state, metrics = make_train_step(model, lr=w.CLIP_LR, warmup=1,
                                     grad_clip=w.CLIP)(
        state, inputs["dense"]["batch"])
    refs["step"] = {"grad_norm": float(metrics["grad_norm"]),
                    "params": {k: v.detach().numpy()
                               for k, v in _flat(state.params)}}
    whole = params_from_numpy(inputs["dense"]["params"], "cpu")
    cstate = init_compression(whole, rank=w.COMP_RANK, min_dim=w.COMP_MIN_DIM,
                              generator=torch.Generator().manual_seed(9))
    compressed, _ = compress_tree(whole, cstate)
    refs["g_hat"] = {k: v.numpy() for k, v in
                     _flat(decompress_tree(compressed))}
    for label, family, _, positions in w.SEQ_CASES:
        case = w.seq_case(inputs, family, positions)
        refs[f"seq_{label}"] = {
            "jax": _value_and_grad(w.family_cfg(jax_config, family),
                                   case["params"], case["batch"]),
            "port": _port_grads(family, case)}
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs (the reference's params, a batch a family), every
    scenario of the four-rank world run once, and the single-device
    references computed meanwhile."""
    tmp = tmp_path_factory.mktemp("fsdp_world")
    inputs = {}
    for i, family in enumerate(w.FAMILIES):
        cfg = w.family_cfg(jax_config, family)
        params = jax.tree.map(np.asarray, jax.jit(jax_build(cfg).init)(
            jax.random.PRNGKey(20 + i)))
        tokens = np.random.default_rng(30 + i).integers(
            0, cfg.vocab, w.TOKENS, dtype=np.int32)
        inputs[family] = {"params": params, "batch": {"tokens": tokens}}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    box = {}

    def spawn():
        try:
            box["results"] = torch_shard_workers.spawn_world(
                w.WORLD, tmp, timeout=600.0, target=w.run_rank,
                extra=(str(tmp / "inputs.pkl"),))
        except BaseException as e:   # noqa: BLE001 — raised below
            box["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        refs = _references(inputs)
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return inputs, box["results"], tmp, refs


CASES = [(f, m) for f in w.FAMILIES for m in ("22", "41")] + [
    ("dense", "pod")]


@pytest.mark.parametrize("family,mesh", CASES,
                         ids=[f"{f}_{m}" for f, m in CASES])
def test_fsdp_loss_and_grads_against_the_reference(world, family, mesh):
    """Each family's reduced config under ``{"fsdp": "data"}`` on (2, 2)
    and (4, 1) (dense also ``{"fsdp": ("pod", "data")}`` on (2, 2, 1)):
    the loss on every rank and the gradients, averaged over the data
    ranks and gathered whole, against ``jax.value_and_grad`` of the
    reference's single-device loss."""
    _, res, _, refs = world
    loss, grads = refs[family]["jax"]
    key = f"grads_{family}_{mesh}"
    for rank in range(w.WORLD):
        np.testing.assert_allclose(res[rank][key]["loss"], loss, **TOL)
    _assert_tree(res[0][key]["grads"], grads, **TOL)


@pytest.mark.parametrize("family,mesh", CASES,
                         ids=[f"{f}_{m}" for f, m in CASES])
def test_fsdp_loss_and_grads_against_single_device(world, family, mesh):
    """The same against the port's single device, and the gradients'
    collectives: the gathers' all-gathers and reduce-scatters on the
    data axes (``on_data``, ``on_pod``)."""
    _, res, _, refs = world
    loss, grads = refs[family]["port"]
    got = res[0][f"grads_{family}_{mesh}"]
    np.testing.assert_allclose(got["loss"], loss, **TOL)
    flat = dict(_flat(got["grads"]))
    for k, want in grads.items():
        np.testing.assert_allclose(flat[k], want, err_msg=k, **TOL)
    nbytes = got["bytes"]
    assert nbytes["all_gather"] > 0 and nbytes["on_data"] > 0
    assert ("on_pod" in nbytes) == (mesh == "pod")


def _local_shapes(model, ctx) -> dict:
    """Rank 0's local shapes of every param leaf under ``ctx`` (a
    shape-only mesh), from a meta init."""
    with use_sharding(ctx.mesh, ctx.rules):
        local = sharding.shard_tree(LM(model.cfg, device="meta").init(None),
                                    model.param_specs())
    return {k: tuple(v.shape) for k, v in _flat(local)}


@pytest.mark.parametrize("family,mesh", CASES,
                         ids=[f"{f}_{m}" for f, m in CASES])
def test_fsdp_leaves_split_over_data(world, family, mesh):
    """Every leaf whose ``"fsdp"`` dimension the rule splits holds 1/data
    of its default block a rank; the leaves without one (norm scales,
    the router, the experts) hold their default block."""
    _, res, _, _ = world
    model = LM(w.family_cfg(get_config, family), device="cpu")
    shape, names = w.MESHES[mesh]
    rules = w.POD_RULES if mesh == "pod" else w.RULES
    data = shape[0] * (shape[1] if mesh == "pod" else 1)
    default = _local_shapes(model, ShardingCtx(
        mesh=MeshShape(shape, names), rules=sharding.DEFAULT_RULES))
    specs = dict(_flat(model.param_specs(_ctx(shape, rules))))
    axes = dict(_flat(model.param_axes()))
    local = res[0][f"grads_{family}_{mesh}"]["local"]
    split = 0
    for path, spec in specs.items():
        d = axes[path].index("fsdp") if "fsdp" in axes[path] else None
        cut = d is not None and d < len(spec) and spec[d] is not None
        split += cut
        assert np.prod(local[path]) * (data if cut else 1) == np.prod(
            default[path]), (path, local[path], default[path])
    assert split > 0


@pytest.mark.parametrize("mesh", ["22", "41"])
def test_clipped_step_equals_single_device(world, mesh):
    """One step of the dense family with a clip far below the gradients'
    norm (the clipped gradients under AdamW's eps, where the update is
    linear in the clip scale): the global norm is the single device's,
    summed over the axes that split each leaf, and the params after the
    step equal the single device's; the master weights are split over
    data with the params."""
    _, res, _, refs = world
    got = res[0][f"step_{mesh}"]
    want = refs["step"]
    assert want["grad_norm"] > 1e3 * w.CLIP
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-5)
    _assert_tree(got["params"], want["params"], **TOL)
    data = w.MESHES[mesh][0][0]
    # wq (layers, d_model, heads · hd): d_model over data
    assert got["master_local"]["blocks.attn.wq"][1] == 128 // data


def test_compression_of_leaves_split_over_data_and_model(world):
    """Compression under ``{"fsdp": "data"}`` on (2, 2), where the MLP
    and attention leaves split over data on one dimension and model on
    the other: each leaf's Ĝ within 1e-5 of the single device's
    compression of the whole leaf (its largest entry's)."""
    _, res, _, refs = world
    got = res[0]["compression"]
    specs = dict(_flat(got["specs"]))
    assert specs["blocks.mlp.w_in"] == (None, "data", "model")
    assert specs["blocks.mlp.w_out"] == (None, "model", "data")
    flat = dict(_flat(got["g_hat"]))
    for k, want in refs["g_hat"].items():
        scale = max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(flat[k] - want).max()) <= 1e-5 * scale, k
    assert got["bytes"]["on_data"] > 0 and got["bytes"]["on_model"] > 0


def test_fsdp_checkpoint_restores_across_the_rule(world):
    """A state saved under ``{"fsdp": "data"}`` on (2, 2) restores under
    the default rules on (2, 2) bit for bit (each rank's blocks of the
    saved state), and that state, saved again, restores under the rule
    bit for bit onto the fsdp blocks it came from."""
    _, res, _, _ = world
    for rank in range(w.WORLD):
        got = res[rank]["checkpoint"]
        assert got["to_default"] == [] and got["back_to_fsdp"] == []
        assert got["step"] == 1
        # the default placement: wq's d_model whole
        assert got["default_local"]["blocks.attn.wq"][1] == 128


def test_fsdp_checkpoint_restores_on_one_device(world):
    """The fsdp checkpoint restores on one device, through the port's
    CheckpointManager and the reference's: the same whole params as the
    ranks gathered, bit for bit."""
    inputs, res, tmp, _ = world
    want = dict(_flat(res[0]["checkpoint"]["whole"]))
    model = LM(w.family_cfg(get_config, "dense"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    template = TrainState(params, adamw_init(params), torch.Generator())
    got = CheckpointManager(str(tmp / "fsdp_ckpt"),
                            async_save=False).restore(template, step=1)
    for k, v in _flat(got.params):
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    jparams = jax.tree.map(jnp.zeros_like, jax.tree.map(
        jnp.asarray, inputs["dense"]["params"]))
    gen_state = torch.Generator().get_state().numpy()
    jtemplate = JaxTrainState(params=jparams, opt=jax_opt.adamw_init(jparams),
                              rng=np.zeros_like(gen_state))
    jgot = JaxCheckpointManager(str(tmp / "fsdp_ckpt"),
                                async_save=False).restore(jtemplate, step=1)
    for k, v in _flat(jax.tree.map(np.asarray, jgot.params)):
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert int(jgot.opt.step) == 1


def test_decode_under_fsdp_matches_single_device(world):
    """Six decode steps of the dense family under ``{"fsdp": "data"}`` on
    (2, 2), each block gathered a step: the gathered logits within 1e-5
    of the largest logit of the single device's, greedy tokens equal."""
    _, res, _, _ = world
    for rank in range(w.WORLD):
        got = res[rank]["decode"]
        assert got["max_diff"] <= 1e-5 * max(got["max_logit"], 1.0)
        assert got["greedy_equal"]


@pytest.mark.parametrize("mesh", ["22", "pod"])
def test_gather_from_data_forward_and_backward(world, mesh):
    """gather_from_data along a dimension over "data" on (2, 2) and over
    ("pod", "data") on (2, 2, 1): the blocks of the rank's peers in their
    order, as an explicit all-gather gives them; its gradient the sum of
    every peer's upstream gradient, the rank's slice of it."""
    _, res, _, _ = world
    for rank in range(w.WORLD):
        got = res[rank]["gather"][mesh]
        assert tuple(got["axes"]) == (("data",) if mesh == "22"
                                      else ("pod", "data"))
        np.testing.assert_array_equal(got["y"], got["want_y"])
        np.testing.assert_array_equal(got["grad"], got["want_grad"])


def _ctx(shape, rules):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    merged = dict(sharding.DEFAULT_RULES, **rules)
    return ShardingCtx(mesh=MeshShape(shape, names), rules=merged)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (16, 16)])
@pytest.mark.parametrize("rule", ["seq_sp", "cache_seq"])
def test_sequence_rules_are_placed(rule, shape):
    """``{"seq_sp": "model"}`` places every param as the default rules do
    (it splits activations, not params) and raises onto another axis;
    ``{"cache_seq": "model"}`` puts the KV caches' slots on the model axis
    where it divides them (64 slots; 30 stay whole), beside the batch on
    the data axis where that divides it, and the recurrent states of the
    hybrid keep their placement.  That both rules then run is the world's
    (``test_seq_sp_*`` here, the cache_seq decode in
    ``tests/test_torch_lm_shard.py``)."""
    model = LM(get_config("h2o-danube-1.8b").reduced(), device="cpu")
    ctx = _ctx(shape, {rule: "model"})
    if rule == "seq_sp":
        assert model.param_specs(ctx) == model.param_specs(_ctx(shape, {}))
        with pytest.raises(NotImplementedError, match="model axis only"):
            model.param_specs(_ctx(shape, {rule: "data"}))
        return
    data, m = shape
    for batch, slots in ((4, 64), (4, 30)):
        spec = model.cache_specs(batch, slots, ctx=ctx)["kv"]["k"]
        want = (None, "data" if batch % data == 0 else None,
                "model" if slots % m == 0 else None)
        while want and want[-1] is None:
            want = want[:-1]
        assert tuple(spec) == want, (batch, slots, spec)
    hybrid = LM(get_config("zamba2-1.2b").reduced(), device="cpu")
    got = hybrid.cache_specs(4, 64, ctx=ctx)
    base = hybrid.cache_specs(4, 64, ctx=_ctx(shape, {}))
    assert got["mamba"] == base["mamba"]
    assert got["kv"]["k"][3:] == base["kv"]["k"][3:]


SEQ_IDS = [case[0] for case in w.SEQ_CASES]


def _within_leaf_max(got: dict, want: dict, bound: float) -> None:
    """Each leaf of ``got`` within ``bound`` of the largest entry of its
    leaf in ``want``."""
    got = dict(_flat(got))
    for k, exp in dict(_flat(want)).items():
        exp = np.asarray(exp, np.float64)
        scale = max(float(np.abs(exp).max()), 1e-30)
        assert float(np.abs(np.asarray(got[k], np.float64) - exp).max()) \
            <= bound * scale, k


@pytest.mark.parametrize("label", SEQ_IDS)
def test_seq_sp_loss_and_grads_against_the_reference(world, label):
    """Under ``{"seq_sp": "model"}`` (dense and moe on (2, 2) and (1, 4),
    the moe with its router loss on (1, 4), 30 positions on (1, 4), the
    hybrid on (2, 2)): the loss on every rank within 1e-6 of
    ``jax.value_and_grad``'s, relative, and each gradient leaf, averaged
    over the data ranks and gathered whole, within 1e-5 of its largest
    entry."""
    _, res, _, refs = world
    loss, grads = refs[f"seq_{label}"]["jax"]
    for rank in range(w.WORLD):
        assert abs(res[rank][f"seq_{label}"]["loss"] - loss) \
            <= 1e-6 * abs(loss)
    _within_leaf_max(res[0][f"seq_{label}"]["grads"], grads, 1e-5)


@pytest.mark.parametrize("label", SEQ_IDS)
def test_seq_sp_against_single_device_and_its_collectives(world, label):
    """The same against the port's single device; the sequence's gathers
    and reduce-scatters add model-axis bytes to the default rules' where
    the rule splits the sequence, and none where it stays whole (30
    positions on model = 4) or the backbone ignores it (the hybrid)."""
    _, res, _, refs = world
    loss, grads = refs[f"seq_{label}"]["port"]
    got = res[0][f"seq_{label}"]
    assert abs(got["loss"] - loss) <= 1e-6 * abs(loss)
    _within_leaf_max(got["grads"], grads, 1e-5)
    nbytes, default = got["bytes"], got["default_bytes"]
    if label in ("dense_14_s30", "hybrid_22"):
        assert nbytes == default
    else:
        assert nbytes["all_gather"] > default["all_gather"]
        assert nbytes["on_model"] > default["on_model"]
        assert nbytes.get("on_data") == default.get("on_data")


def test_sequence_collectives_forward_and_backward(world):
    """On (1, 4)'s model axis: scatter_to_seq gives the rank's block and
    gathers its gradient whole; gather_from_seq the blocks in rank order,
    its gradient the rank's block of every rank's upstream gradient summed
    (``summed=False``: of its own); reduce_scatter_to_seq the rank's block
    of the sum, its gradient gathered."""
    _, res, _, _ = world
    j = np.arange(8.0)
    owner = j // 2
    for rank in range(w.WORLD):
        got = res[rank]["seq_collectives"]
        block = slice(2 * rank, 2 * rank + 2)
        y, g = got["scatter"]
        np.testing.assert_array_equal(y[0], j[block] + 10 * rank)
        np.testing.assert_array_equal(g[0], j * (owner + 1))
        y, g = got["gather_True"]
        np.testing.assert_array_equal(y[0], owner + 1)
        np.testing.assert_array_equal(g[0], j[block] * 10)
        y, g = got["gather_False"]
        np.testing.assert_array_equal(g[0], j[block] * (rank + 1))
        y, g = got["reduce_scatter"]
        np.testing.assert_array_equal(y[0], j[block] * 10)
        np.testing.assert_array_equal(g[0], j * (owner + 1))


ARCHS = sorted(["h2o-danube-1.8b", "qwen2-moe-a2.7b", "zamba2-1.2b",
                "xlstm-350m", "command-r-plus-104b", "paligemma-3b",
                "hubert-xlarge", "qwen3-moe-235b-a22b", "qwen1.5-32b",
                "starcoder2-7b"])


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_adds_the_data_axes_to_the_default_placement(arch):
    """At published widths on 16x16 and 2x16x16: under the ``"fsdp"``
    rule every leaf's spec is its default spec with the rule's axes on
    its ``"fsdp"`` dimension where they divide it, nothing else moved;
    ``fsdp`` onto the model axis and another rule onto the data axis are
    refused."""
    model = LM(get_config(arch), device="cpu")
    axes = dict(_flat(model.param_axes()))
    for shape, rules in (((16, 16), w.RULES), ((2, 16, 16), w.POD_RULES)):
        default = dict(_flat(model.param_specs(_ctx(shape, {}))))
        fsdp = dict(_flat(model.param_specs(_ctx(shape, rules))))
        moved = 0
        for path, spec in fsdp.items():
            base = list(default[path]) + [None] * (len(axes[path])
                                                   - len(default[path]))
            if "fsdp" in axes[path]:
                d = axes[path].index("fsdp")
                if base[d] is None and d < len(spec) and spec[d]:
                    base[d] = spec[d]
                    moved += 1
            while base and base[-1] is None:
                base.pop()
            assert tuple(spec) == tuple(base), (shape, path, spec)
        assert moved > 0
    with pytest.raises(NotImplementedError, match="model"):
        model.param_specs(_ctx((16, 16), {"fsdp": "model"}))
    with pytest.raises(NotImplementedError, match="data"):
        model.param_specs(_ctx((2, 2), {"ff": "data", "heads": "data",
                                        "vocab": "data"}))


def test_mean_over_data_needs_the_specs_under_fsdp():
    """Without the gradients' specs the mean would all-reduce the leaves
    the gathers' reduce-scatters already summed: it raises before any
    collective."""
    with use_sharding(MeshShape((4, 1), ("data", "model")), w.RULES):
        with pytest.raises(ValueError, match="specs"):
            mean_over_data({"w": torch.zeros(2)})


def test_shard_bytes_tool_predicts_the_fsdp_step(world, tmp_path):
    """``tools/torch_shard_bytes.py --rules`` walks the reduced dense
    step under ``{"fsdp": "data"}`` on meta over a fake world: its
    bytes by axis are the gloo ranks' (the gathers' all-gathers, the
    reduce-scatters as all-reduces on gloo)."""
    _, res, _, _ = world
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for mesh in ("2,2", "4,1"):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "torch_shard_bytes.py"),
             "--arch", "h2o-danube-1.8b", "--reduced", "--dtype", "float32",
             "--batch", str(w.TOKENS[0]), "--seq", str(w.TOKENS[1]),
             "--mesh", mesh, "--rules", json.dumps(w.RULES)],
            env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[mesh] = json.loads(proc.stdout.strip().splitlines()[-1])
    for mesh, key in (("2,2", "22"), ("4,1", "41")):
        want = res[0][f"step_{key}"]["bytes"]
        got = out[mesh]["bytes"]
        for k in ("on_data", "on_model", "all_gather", "all_reduce",
                  "calls"):
            assert got.get(k, 0) == want.get(k, 0), (mesh, k, got, want)
