"""The sharded transformer families on four gloo ranks, against the JAX
package's single-device paths, on the CPU.

The reference's own mesh tests of this half fail under this JAX
(ROADMAP.md Queue 3), so they are no yardstick: the port's explicit SPMD
(``dist/sharding.py``: tensor, expert and data parallelism) is held
against the reference's single-device ``loss``, ``forward`` and
``moe_block`` on the same numpy params, and against the port's
single-device train step.  One spawned world of four ranks
(``tests/torch_lm_shard_workers.py``) runs every scenario once: the
counterparts of ``tests/test_distributed.py:87`` (``compressed_psum``),
``:113`` (the train step), ``:135`` (the MoE) and ``:163`` (the elastic
re-mesh), the training driver's supervised restart on a mesh, and its
``--mesh local``.  Bounds: 2e-4,
``tests/test_torch_train.py``'s; the reference test's 5e-3 of
max(|logits|, 1) for logits whose routing may differ; 1e-3 for
``compressed_psum``, the reference test's.
"""

import dataclasses
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.dist.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.models import build_model as jax_build
from repro.models import moe as jax_moe
from repro.train import optimizer as jax_opt
from repro.train.train_step import TrainState as JaxTrainState
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import synth_batch
from repro_torch.dist.sharding import (MeshShape, P, ShardingCtx,
                                       local_block, shard_tree, use_sharding)
from repro_torch.launch import train as train_mod
from repro_torch.models import LM, params_from_numpy
from repro_torch.train import (TrainState, adamw_init, init_compression,
                               make_train_step, require_grad)

import torch_lm_shard_workers as w
import torch_shard_workers

TOL = dict(rtol=2e-4, atol=2e-4)
LOGIT_TOL = 5e-3
PSUM_TOL = dict(rtol=1e-3, atol=1e-3)


def _jax_params(cfg, seed):
    model = jax_build(cfg)
    return model, jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(seed)))


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


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1.0))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs (the reference's params), and every scenario of the
    four-rank world, run once; results by rank."""
    tmp = tmp_path_factory.mktemp("lm_world")
    rng = np.random.default_rng(0)
    inputs = {}
    _, params = _jax_params(w.danube_cfg(jax_config), 0)
    inputs["danube"] = {"params": params, "tokens": rng.integers(
        0, 512, w.DANUBE_TOKENS, dtype=np.int32)}
    for key, cfg, seed in (("qwen3", w.qwen3_cfg(jax_config), 1),
                           ("qwen2", w.qwen2_cfg(jax_config), 2)):
        _, params = _jax_params(cfg, seed)
        inputs[key] = {"params": params, **w.moe_inputs(cfg, seed)}
    for i, family in enumerate(w.FAMILIES):
        cfg = w.family_cfg(get_config, family)
        _, params = _jax_params(w.family_cfg(jax_config, family), 3 + i)
        b, s = w.FAMILY_BATCH
        inputs[family] = {"params": params, "batch": synth_batch(
            cfg, ShapeConfig("t", s, b, "train"), seed=5 + i)}
    u, v = rng.normal(size=(64, 1)), rng.normal(size=(32, 1))
    inputs["psum"] = {
        "g_same": (u @ v.T).astype(np.float32),
        "g_ranks": [rng.normal(size=(64, 32)).astype(np.float32)
                    for _ in range(w.WORLD)],
        "bias": rng.normal(size=5).astype(np.float32)}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    # the ranks run while this process computes the references
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


def _value_and_grad(cfg, params, batch):
    """The reference's single-device loss and gradients (numpy)."""
    model = jax_build(cfg)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(p, b)[0]))(jax.tree.map(jnp.asarray, params),
                                          batch)
    return float(loss), jax.tree.map(np.asarray, grads)


def _moe_refs(inputs, key, cfg):
    """The reference's logits and layer-0 MoE block (on the block input)."""
    model = jax_build(cfg)
    params = jax.tree.map(jnp.asarray, inputs[key]["params"])
    logits, _ = jax.jit(model.forward)(params, {"tokens": jnp.asarray(
        inputs[key]["tokens"])})
    block = jax.tree.map(lambda x: x[0], params["blocks"]["moe"])
    y = jax.jit(lambda p, x: jax_moe.moe_block(p, cfg, x))(
        block, jnp.asarray(inputs[key]["x"]))
    return {"logits": np.asarray(logits), "block": np.asarray(y)}


def _capacity_refs(inputs):
    """qwen3 at capacity factor 1.25: the reference's block on each data
    shard's tokens, its aux, and the pairs dropped there."""
    cfg = w.qwen3_cfg(jax_config, 1.25)
    params = jax.tree.map(jnp.asarray, inputs["qwen3"]["params"])
    block = jax.tree.map(lambda x: x[0], params["blocks"]["moe"])
    x = inputs["qwen3"]["x_cap"]
    half = x.shape[0] // 2
    outs, auxes, dropped = [], [], 0
    body = jax.jit(lambda p, x: jax_moe.moe_block(p, cfg, x,
                                                  return_aux=True))
    for rows in (slice(0, half), slice(half, None)):
        y, aux = body(block, jnp.asarray(x[rows]))
        outs.append(np.asarray(y))
        auxes.append(float(aux))
        xt = x[rows].reshape(-1, x.shape[-1])
        _, top_e, _ = jax_moe._route(jnp.asarray(xt), block["router"], cfg)
        cap = jax_moe._capacity(xt.shape[0], cfg)
        counts = np.bincount(np.asarray(top_e).reshape(-1),
                             minlength=cfg.moe.n_experts)
        dropped += int(np.maximum(counts - cap, 0).sum())
    return {"block": np.concatenate(outs), "auxes": auxes,
            "dropped": dropped}


def _references(inputs) -> dict:
    refs = {"danube": _value_and_grad(
        w.danube_cfg(jax_config), inputs["danube"]["params"],
        {"tokens": inputs["danube"]["tokens"]})}
    for key, cfg in (("qwen3", w.qwen3_cfg(jax_config)),
                     ("qwen2", w.qwen2_cfg(jax_config))):
        refs[key] = {**_moe_refs(inputs, key, cfg), "value_and_grad":
                     _value_and_grad(cfg, inputs[key]["params"],
                                     {"tokens": inputs[key]["tokens"]})}
    refs["capacity"] = _capacity_refs(inputs)
    for family in w.FAMILIES:
        refs[family] = _value_and_grad(w.family_cfg(jax_config, family),
                                       inputs[family]["params"],
                                       inputs[family]["batch"])
    for key in ("danube", "qwen2"):
        for label, k, _, max_seq, prompt, last in w.CACHE_SEQ_CASES:
            if k == key:
                refs[f"cache_seq_{key}"] = _jax_decode(
                    w.cache_seq_cfg(jax_config, key), inputs[key],
                    max_seq, prompt, last)
                break
    return refs


def _jax_decode(cfg, case, max_seq: int, prompt: int, last: int) -> list:
    """The reference's single-device prefill of ``prompt`` positions and
    decode steps up to ``last``: the prefill's last logits, then each
    step's."""
    model = jax_build(cfg)
    params = jax.tree.map(jnp.asarray, case["params"])
    tokens = jnp.asarray(case["tokens"][:, :last])
    logits, cache = jax.jit(model.prefill, static_argnums=2)(
        params, {"tokens": tokens[:, :prompt]}, max_seq)
    out = [np.asarray(logits[:, -1])]
    step = jax.jit(model.decode_step)
    for i in range(prompt, last):
        logits, cache = step(params, cache, tokens[:, i:i + 1],
                             jnp.int32(i))
        out.append(np.asarray(logits[:, 0]))
    return out


# -- the decode step on a mesh ------------------------------------------------

@pytest.mark.parametrize("key,local_wq,local_wk", [
    ("decode_danube_22", (2, 128, 64), (2, 128, 32)),
    ("decode_qwen2_14", (2, 128, 32), (2, 128, 32))])
def test_decode_step_on_a_mesh_matches_single_device(world, key, local_wq,
                                                     local_wk):
    """Six decode steps from an empty cache on a mesh against the port's
    single-device decode of the same params, every rank's logits
    gathered whole: reduced danube on (2, 2) (2 of 4 query heads a rank,
    the one KV head replicated in the cache and written by every rank)
    and reduced qwen2-moe on (1, 4) (a query and a KV head a rank, each
    rank writing and reading its own KV head of the cache; 6 experts, so
    tensor parallelism inside each).  2e-4 of the largest logit."""
    _, res, _, _ = world
    for rank in range(w.WORLD):
        got = res[rank][key]
        assert got["local_wq"] == local_wq and got["local_wk"] == local_wk
        assert got["max_diff"] <= 2e-4 * max(got["max_logit"], 1.0)


@pytest.mark.parametrize("label", [c[0] for c in w.CACHE_SEQ_CASES])
def test_cache_seq_decode_matches_the_reference(world, label):
    """Under ``{"cache_seq": "model"}`` each rank holds a block of the
    decode cache's slots with every KV head: reduced danube with a
    16-slot ring on (1, 4) (4 slots a rank) and (2, 2) (8 a rank, two data
    rows), prefilled with 3 positions (fewer than one rank's slots, so
    the other ranks hold none valid) and decoded to position 23, past one
    rank's slots and past the ring's wrap; reduced qwen2-moe's full cache
    of 12 slots on (1, 4), its KV heads split and gathered for the write.
    Every step's logits, gathered whole, within 1e-5 of the reference's
    single-device prefill and ``decode_step`` (of the largest logit, at
    least 1), greedy tokens equal."""
    _, res, _, refs = world
    key = label.split("_")[0]
    want = refs[f"cache_seq_{key}"]
    _, _, mesh, max_seq, _, _ = next(c for c in w.CACHE_SEQ_CASES
                                     if c[0] == label)
    for rank in range(w.WORLD):
        got = res[rank][f"cache_seq_{label}"]
        assert len(got["logits"]) == len(want)
        for g, e in zip(got["logits"], want):
            assert np.abs(g - e).max() <= 1e-5 * max(np.abs(e).max(), 1.0)
            assert np.array_equal(g.argmax(-1), e.argmax(-1))
        slots = min(max_seq, w.RING_WINDOW) if key == "danube" else max_seq
        model_ranks = 4 if mesh == "14" else 2
        assert got["cache_shape"][2] == slots // model_ranks
        assert got["cache_spec"][2] == "model"
        # the step's collectives: the merge's all-gather of the partials
        assert got["step_bytes"]["all_gather"] > 0


def test_serve_engine_under_cache_seq(world):
    """A ServeEngine made under ``{"cache_seq": "model"}`` on (1, 4)
    serves on the mesh: each rank holds a quarter of the 16-slot ring,
    and its greedy tokens from 3 prompt positions through 20 new ones
    (past the ring's wrap) equal the single device's engine's, f32, on
    every rank; ``launch/serve.py --mesh local --model-parallel 4 --rules
    '{"cache_seq": "model"}'`` on the four ranks gives the tokens of its
    single-device run."""
    from repro_torch.launch import serve as serve_mod
    _, res, _, _ = world
    for rank in range(w.WORLD):
        got = res[rank]["serve"]
        assert got["cache_block"][2] == w.RING_WINDOW // 4
        np.testing.assert_array_equal(got["got"], got["want"])
    want = serve_mod.main(w.serve_cli_args([]))
    for rank in range(w.WORLD):
        np.testing.assert_array_equal(res[rank]["serve_cli"], want)


@pytest.mark.parametrize("family", sorted(w.FAMILIES))
def test_vlm_and_audio_under_seq_sp(world, family):
    """The vlm (an image prefix, attended bidirectionally) and audio (no
    causal mask) families under ``{"seq_sp": "model"}`` on (2, 2): the
    loss and gathered gradients against the reference's single device at
    the default rules' tolerance, and against the default rules' run on
    the same mesh within 1e-6 (loss, relative) and 1e-5 of each leaf's
    largest entry."""
    _, res, _, refs = world
    loss, grads = refs[family]
    for rank in range(w.WORLD):
        got = res[rank][f"{family}_seq_sp"]
        np.testing.assert_allclose(got["loss"], loss, **TOL)
        base = res[rank][family]
        assert abs(got["loss"] - base["loss"]) <= 1e-6 * abs(base["loss"])
    _assert_tree(res[0][f"{family}_seq_sp"]["grads"], grads, **TOL)
    flat = dict(_flat(res[0][f"{family}_seq_sp"]["grads"]))
    for k, want in _flat(res[0][family]["grads"]):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(flat[k] - want).max()) <= 1e-5 * scale, k


# -- the danube train step on (2, 2) ----------------------------------------


def test_danube_step_loss_and_grads_against_the_reference(world):
    """Reduced danube, f32, tokens (8, 64) on the (2, 2) mesh: the loss
    (the same on every rank) and the gradients, averaged over the data
    ranks and gathered whole, against ``jax.value_and_grad`` of the
    reference's single-device loss (``tests/test_distributed.py:113``)."""
    _, res, _, refs = world
    loss, grads = refs["danube"]
    for rank in range(w.WORLD):
        np.testing.assert_allclose(res[rank]["danube"]["loss"], loss, **TOL)
    _assert_tree(res[0]["danube"]["grads"], grads, **TOL)
    # 2 of 4 query heads a rank, the one KV head replicated
    shapes = res[0]["danube"]["local_shapes"]
    assert shapes["wq"] == (2, 128, 64) and shapes["wk"] == (2, 128, 32)
    assert shapes["wo"] == (2, 64, 128)


def _single_step(inputs, cfg, microbatches=1):
    model = LM(cfg, device="cpu")
    params = require_grad(params_from_numpy(inputs["danube"]["params"],
                                            "cpu"))
    state = TrainState(params, adamw_init(params), torch.Generator())
    state, metrics = make_train_step(model, microbatches=microbatches)(
        state, {"tokens": inputs["danube"]["tokens"]})
    return float(metrics["loss"]), {k: v.detach().numpy()
                                    for k, v in _flat(state.params)}


@pytest.mark.parametrize("case", ["plain", "micro2_remat"])
def test_danube_step_params_against_single_device(world, case):
    """The params after one sharded step (AdamW on local blocks, the clip
    norm over the model axis) against the port's single-device
    ``make_train_step``; also with 2 microbatches and remat on."""
    inputs, res, _, _ = world
    cfg = w.danube_cfg(get_config)
    key = "step" if case == "plain" else "micro"
    if case == "plain":
        loss, want = _single_step(inputs, cfg)
    else:
        loss, want = _single_step(
            inputs, dataclasses.replace(cfg, remat="block"), microbatches=2)
    got = res[0]["danube"][f"{key}_params"]
    if case != "plain":
        # remat's recompute in a thread without the caller's context (as
        # autograd's device thread runs it on the card) keeps the placement
        assert res[0]["danube"]["remat_thread"] == "equal"
    np.testing.assert_allclose(res[0]["danube"][f"{key}_loss"], loss, **TOL)
    _assert_tree(got, {k: v for k, v in want.items()}, **TOL)


def test_danube_step_bytes(world):
    """A step's collectives on (2, 2), ring counted: the tensor-parallel
    reduces on the model axis (each a (4, 64, 128) f32 activation or
    gradient: 2 a layer forward, as many backward, embedding and CE
    besides) and the gradient mean on the data axis (the model-local
    params, f32, once)."""
    _, res, _, _ = world
    nbytes = res[0]["danube"]["bytes"]
    act = 4 * 64 * 128 * 4          # one (B_local, S, D) f32 activation
    assert nbytes["on_model"] >= 2 * 2 * 2 * act * (2 - 1) / 2
    assert nbytes["on_data"] > 0
    assert nbytes["all_reduce"] == nbytes["on_model"] + nbytes["on_data"]


# -- the MoE ---------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["qwen3_14", "qwen3_22"])
def test_moe_expert_parallel_matches_reference(world, mesh):
    """Reduced qwen3-moe (8 experts, top-2, capacity factor 8: nothing
    dropped) on (1, 4) (2 experts a rank) and (2, 2) (4 a rank): the
    gathered logits within the reference test's 5e-3 of its
    single-device forward (``tests/test_distributed.py:135``); the MoE
    block alone, given the same input (so the same routing), at 2e-4."""
    _, res, _, refs = world
    got = res[0][mesh]
    assert got["local_w_in"][1] == (2 if mesh == "qwen3_14" else 4)
    assert _rel(got["logits"], refs["qwen3"]["logits"]) < LOGIT_TOL
    np.testing.assert_allclose(got["block"], refs["qwen3"]["block"], **TOL)


def test_moe_expert_parallel_grads_match_reference(world):
    """The (1, 4) expert-parallel loss and gathered gradients (the routing
    weights and tokens enter the model region, the router is summed)
    against ``jax.value_and_grad`` of the reference's single-device
    loss."""
    _, res, _, refs = world
    loss, grads = refs["qwen3"]["value_and_grad"]
    np.testing.assert_allclose(res[0]["qwen3_14"]["loss"], loss, **TOL)
    _assert_tree(res[0]["qwen3_14"]["grads"], grads, **TOL)


def test_moe_capacity_per_data_shard(world):
    """Capacity factor 1.25 on (2, 2): each data shard's 2200 tokens get
    the reference's capacity from T_local, so outputs and aux equal the
    reference's local body run on each shard's tokens, the aux averaged
    over the shards; pairs are dropped there."""
    _, res, _, refs = world
    want = refs["capacity"]
    assert want["dropped"] > 0
    got = res[0]["capacity"]
    np.testing.assert_allclose(got["block"], want["block"], **TOL)
    np.testing.assert_allclose(got["aux"], np.mean(want["auxes"]), **TOL)
    np.testing.assert_allclose([res[r]["capacity"]["rank_aux"]
                                for r in (0, 2)], want["auxes"], **TOL)


def test_tensor_parallel_inside_experts(world):
    """Reduced qwen2-moe with 6 experts on model = 4: 6 % 4 != 0, so every
    expert's d_ff and the shared expert's are split (32 of 128 columns a
    rank); logits, the block and the loss and gradients match the
    reference's single device at 2e-4."""
    _, res, _, refs = world
    want = refs["qwen2"]
    got = res[0]["qwen2_14"]
    assert got["local_w_in"] == (2, 6, 128, 32)
    assert _rel(got["logits"], want["logits"]) < TOL["rtol"]
    np.testing.assert_allclose(got["block"], want["block"], **TOL)
    loss, grads = want["value_and_grad"]
    np.testing.assert_allclose(got["loss"], loss, **TOL)
    _assert_tree(got["grads"], grads, **TOL)


@pytest.mark.parametrize("family", list(w.FAMILIES))
def test_vlm_and_audio_losses_on_a_mesh(world, family):
    """Reduced paligemma (the image prefix: the loss reads the text
    positions) and hubert (the masked mean: numerator and denominator
    summed over the data ranks apart, the shards' masks unequal) on
    (2, 2): loss and gathered gradients against the reference's
    single-device ``jax.value_and_grad`` at 2e-4."""
    inputs, res, _, refs = world
    loss, grads = refs[family]
    if family == "audio":
        mask = inputs[family]["batch"]["mask"]
        half = mask.shape[0] // 2
        assert mask[:half].sum() != mask[half:].sum()
    for rank in range(w.WORLD):
        np.testing.assert_allclose(res[rank][family]["loss"], loss, **TOL)
    _assert_tree(res[0][family]["grads"], grads, **TOL)


def test_autograd_collectives(world):
    """copy_to_model sums the gradients, reduce_from_model the values,
    gather_from_model concatenates and gives each rank its own slice of
    the gradient, over the four ranks of the model axis."""
    _, res, _, _ = world
    for rank in range(w.WORLD):
        got = res[rank]["collectives"]
        y, g = got["copy"]
        assert (y == rank + 1).all() and (g == 1 + 2 + 3 + 4).all()
        y, g = got["reduce"]
        assert (y == 1 + 2 + 3 + 4).all() and (g == 2).all()
        y, g = got["gather"]
        assert y.tolist() == [[1.0, 2.0, 3.0, 4.0]] * 2
        assert (g == rank).all()


# -- compressed_psum --------------------------------------------------------


def test_compressed_psum_same_rank1_gradient(world):
    """The same rank-1 gradient on every rank: the factored all-reduce
    gives it back within 1e-3 (``tests/test_distributed.py:87``); every
    rank the same."""
    inputs, res, _, _ = world
    for rank in range(w.WORLD):
        np.testing.assert_allclose(res[rank]["psum"]["same"],
                                   inputs["psum"]["g_same"], **PSUM_TOL)


def test_compressed_psum_different_gradients(world):
    """A different gradient on each rank, against the reference's formula
    in numpy: P = orth(Σ G_r Q₀), Ĝ = P Pᵀ mean(G_r); a raw leaf gets the
    plain mean."""
    inputs, res, _, _ = world
    g = np.stack(inputs["psum"]["g_ranks"]).astype(np.float64)
    q0 = res[0]["psum"]["q0"].astype(np.float64)
    p, _ = np.linalg.qr(np.einsum("rnm,mk->nk", g, q0))
    want = p @ p.T @ g.mean(axis=0)
    for rank in range(w.WORLD):
        np.testing.assert_allclose(res[rank]["psum"]["diff"], want,
                                   **PSUM_TOL)
        np.testing.assert_allclose(
            res[rank]["psum"]["bias"],
            inputs["psum"]["bias"] * np.mean(np.arange(1, w.WORLD + 1)),
            rtol=1e-6)


# -- the elastic re-mesh ------------------------------------------------------


def test_elastic_remesh_restores_bit_for_bit(world):
    """A step on (2, 2), saved (gathered, rank 0 writes); plan_mesh(2, 2)
    gives the (1, 2) sub-mesh of the first two ranks, which restores its
    blocks bit for bit and steps to a finite loss
    (``tests/test_distributed.py:163``)."""
    _, res, _, _ = world
    remesh = res[0]["remesh"]
    assert remesh["plan"] == ((1, 2), ("data", "model"))
    assert remesh["mesh"] == ((1, 2), ("data", "model"))
    assert remesh["restored_step"] == 1 and remesh["opt_step"] == 1
    assert remesh["local_wq"] == (2, 128, 64)
    for key, saved in (("params", res[0]["danube"]["step_params"]),
                       ("opt_m", res[0]["danube"]["saved_opt_m"])):
        for k, v in _flat(saved):
            assert np.array_equal(dict(_flat(remesh[key]))[k], v), (key, k)
    assert np.isfinite(remesh["loss"])
    assert "params" not in res[2]["remesh"]


def test_driver_restart_on_a_mesh_restores_one_step(world):
    """The driver on (2, 2) with host 1 failing at the tick right after
    the async save of step 2, rank 0's write of it held back: every rank
    restores step 2, the one rank 0 wrote, and the run ends at the
    checkpoint of the same run with no failure, bit for bit."""
    _, res, _, _ = world
    for rank in range(w.WORLD):
        got = res[rank]["restart"]
        assert got["restored"] == [2], rank
        assert (got["failed_restarts"], got["clean_restarts"]) == (1, 0)
    got = res[0]["restart"]
    assert set(got["failed"]) == set(got["clean"])
    for k, want in got["clean"].items():
        np.testing.assert_array_equal(got["failed"][k], want, err_msg=k)


def test_reference_restores_the_sharded_checkpoint(world):
    """The reference's CheckpointManager restores the port's sharded save
    on one device: the same whole params."""
    inputs, res, tmp, _ = world
    params = jax.tree.map(jnp.zeros_like,
                          jax.tree.map(jnp.asarray,
                                       inputs["danube"]["params"]))
    gen_state = torch.Generator().get_state().numpy()
    template = JaxTrainState(params=params, opt=jax_opt.adamw_init(params),
                             rng=np.zeros_like(gen_state))
    got = JaxCheckpointManager(str(tmp / "ckpt"), async_save=False).restore(
        template, step=1)
    for k, v in _flat(res[0]["danube"]["step_params"]):
        np.testing.assert_array_equal(
            np.asarray(dict(_flat(jax.tree.map(np.asarray,
                                               got.params)))[k]), v)
    assert int(got.opt.step) == 1


# -- the training driver ------------------------------------------------------


def test_launch_train_mesh_local(world, tmp_path):
    """``launch/train.py --mesh local --model-parallel 2`` on the four
    ranks (custom-10m, batch 4 × 64): a run of 4 steps, then its resume
    to 6 from the sharded checkpoint of step 4; the loss at every step
    equals the ``--mesh none`` runs' (the same two runs on one device)
    at 2e-4."""
    _, res, _, _ = world
    sharded = res[0]["launch"]
    single = []
    for steps in w.LAUNCH_STEPS:
        single.append(train_mod.train(
            train_mod.custom_10m(), steps=steps, batch=4, seq=64,
            ckpt_dir=str(tmp_path), save_every=2, log_every=1,
            device="cpu")["history"])
    assert [h["step"] for h in sharded[0]["history"]] == [1, 2, 3, 4]
    assert [h["step"] for h in sharded[1]["history"]] == [5, 6]
    for got, want in zip(sharded, single):
        want = {h["step"]: h["loss"] for h in want}
        for h in got["history"]:
            np.testing.assert_allclose(h["loss"], want[h["step"]], **TOL)


# -- the recurrent families and compression on a model axis ------------------
# (their multi-rank runs: tests/test_torch_recurrent_shard.py)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_recurrent_families_place_on_a_model_axis(arch):
    """A hybrid or ssm model on a model axis wider than 1 places its
    recurrent blocks by whole heads (Mamba2's in_proj packed, the mLSTM's
    projections and gates split, the sLSTM cell replicated); on a
    data-only mesh it places whole."""
    model = LM(get_config(arch).reduced(), device="cpu")
    wide = ShardingCtx(mesh=MeshShape((2, 2), ("data", "model")),
                       rules={"heads": "model", "ff": "model"})
    specs = dict(_flat(model.param_specs(wide)))
    if arch == "zamba2-1.2b":
        packed = specs["mamba_groups.mixer.in_proj"][-1]
        assert [e for _, e in packed] == ["model", "model", None, "model"]
        assert specs["mamba_groups.mixer.out_proj"] == (None, None, "model")
    else:
        assert specs["mlstm_groups.mixer.up_l"] == (None, None, None,
                                                    "model")
        assert specs["mlstm_groups.mixer.w_igate"] == (None, None, "model")
        assert specs["slstm.cell.r_gates"] == ()
    narrow = ShardingCtx(mesh=MeshShape((4, 1), ("data", "model")),
                         rules={"batch": "data"})
    specs = dict(_flat(model.param_specs(narrow)))
    assert all(spec == () for spec in specs.values())


def test_compression_state_is_the_whole_leaves_blocks():
    """Compression on a model axis: ``init_compression`` of a rank's local
    blocks with their specs decides compressibility on the whole leaves
    and keeps the rank's block of the whole Q₀ the single device draws
    from the same generator (its rows of the leaf's last dimension), the
    error buffers at the local shape."""
    model = LM(w.danube_cfg(get_config), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    whole = init_compression(params, rank=2, min_dim=64,
                             generator=torch.Generator().manual_seed(4))
    for coord in range(2):
        ctx = ShardingCtx(mesh=MeshShape((2, 2), ("data", "model"),
                                         coords={"model": coord}),
                          rules={"heads": "model", "ff": "model",
                                 "vocab": "model", "kv_heads": "model"})
        with use_sharding(ctx.mesh, ctx.rules):
            specs = model.param_specs()
            local = shard_tree(params, specs)
            got = init_compression(local, rank=2, min_dim=64,
                                   generator=torch.Generator().manual_seed(
                                       4), specs=specs)
        q_got, q_whole = dict(_flat(got.q)), dict(_flat(whole.q))
        specs, shapes = dict(_flat(specs)), dict(_flat(model.param_shapes()))
        assert set(q_got) == set(q_whole)
        for k, q in q_whole.items():
            assert (q is None) == (q_got[k] is None), k
            if q is not None:
                spec = specs[k]
                last = spec[-1] if len(spec) == len(shapes[k]) else None
                want = local_block(q, P(last), ctx)
                assert torch.equal(q_got[k], want), k
        w_in = dict(_flat(got.q))["blocks.mlp.w_in"]
        assert w_in.shape == (128, 2)      # the rank's 128 of 256 columns
        err = dict(_flat(got.err))["blocks.mlp.w_out"]
        assert err.shape == (2 * 128, 128)  # 2 layers × its 128 rows
