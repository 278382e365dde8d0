"""The recurrent families (zamba2's hybrid, xlstm's ssm) and gradient
compression on a mesh with a model axis, on four gloo ranks, against the
JAX package's single-device paths and the port's single device, on the
CPU.

The reference's mesh path fails under this JAX (ROADMAP.md Queue 3), and
its GSPMD placement cuts the packed Mamba2 projections contiguously, so
the port's explicit SPMD (Mamba2 and the mLSTM split by whole heads, the
sLSTM cell replicated: ``models/ssm.py``, ``models/xlstm.py``) is held
against the reference's single-device ``loss``, ``jax.grad`` and
``decode_step`` on the same numpy params, and against the port's single
device.  One spawned world of four ranks
(``tests/torch_recurrent_shard_workers.py``) runs every scenario once on
(2, 2) and (1, 4): reduced zamba2 (8 Mamba2 heads, 4 attention heads)
and reduced xlstm (4 mLSTM heads; the sLSTM's d_up = 170 splits on
model = 2 and stays replicated on 4).

Tolerances: 2e-4 for losses, gradients and logits
(``tests/test_torch_lm_shard.py``'s, ``tests/test_torch_train.py``'s);
greedy tokens exactly; compression within 1e-4 of each leaf's largest
entry of the single device's compression of the whole leaf (f32 products
summed in another order, then one QR); checkpoints bit for bit.
"""

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
from repro.train import optimizer as jax_opt
from repro.train.train_step import TrainState as JaxTrainState
from repro_torch.configs import get_config
from repro_torch.dist import CheckpointManager, sharding
from repro_torch.dist.sharding import MeshShape, ShardingCtx
from repro_torch.launch import train as train_mod
from repro_torch.models import LM, params_from_numpy
from repro_torch.train import TrainState, adamw_init, require_grad
from repro_torch.train import grad_compression as gc
from repro_torch.train.optimizer import leaves, unflatten

import torch_recurrent_shard_workers as w
import torch_shard_workers

TOL = dict(rtol=2e-4, atol=2e-4)
COMP_TOL = 1e-4
CASES = [(f, m) for f in w.ARCHS for m in w.MESHES]
IDS = [f"{w.ARCHS[f]}_{m}" for f, m in CASES]


def _flat(tree, prefix=""):
    return dict(w._flat(tree, prefix))


def _assert_tree(got, want, **tol):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   err_msg=k, **tol)


def _jax_refs(family, case) -> dict:
    """The reference's single-device loss, gradients and decode (the same
    token-by-token prefill and greedy steps as the ranks')."""
    model = jax_build(w.family_cfg(jax_config, family))
    params = jax.tree.map(jnp.asarray, case["params"])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: model.loss(p, {"tokens": t})[0]))(
            params, jnp.asarray(case["tokens"]))
    step = jax.jit(model.decode_step)
    prompt = case["prompt"]
    cache = model.init_cache(prompt.shape[0], w.PROMPT + w.GREEDY)
    token, logits, tokens = jnp.asarray(prompt[:, :1]), [], []
    for pos in range(w.PROMPT + w.GREEDY - 1):
        out, cache = step(params, cache, token, jnp.asarray(pos, jnp.int32))
        logits.append(np.asarray(out[:, 0]))
        if pos + 1 < w.PROMPT:
            token = jnp.asarray(prompt[:, pos + 1:pos + 2])
        else:
            token = jnp.argmax(out[:, 0], axis=-1)[:, None].astype(
                jnp.int32)
            tokens.append(np.asarray(token[:, 0]))
    return {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
            "logits": np.stack(logits, axis=1),
            "tokens": np.stack(tokens, axis=1)}


def _port_refs(family, case) -> dict:
    """The port's single-device loss, gradients and decode."""
    model = LM(w.family_cfg(get_config, family), device="cpu")
    params = require_grad(params_from_numpy(case["params"], "cpu"))
    loss, _ = model.loss(params, {"tokens": case["tokens"]})
    grads = unflatten(params, torch.autograd.grad(loss, leaves(params)))
    prompt = torch.as_tensor(case["prompt"])
    cache = model.init_cache(prompt.shape[0], w.PROMPT + w.GREEDY)
    token, logits = prompt[:, :1], []
    with torch.no_grad():
        for pos in range(w.PROMPT + w.GREEDY - 1):
            out, cache = model.decode_step(params, cache, token, pos)
            logits.append(out[:, 0].numpy())
            token = (prompt[:, pos + 1:pos + 2] if pos + 1 < w.PROMPT
                     else out[:, 0].argmax(-1, keepdim=True))
    return {"loss": float(loss.detach()), "grads": w._np(grads),
            "logits": np.stack(logits, axis=1)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs (the reference's params, some of its constant leaves
    drawn), every scenario of the four-rank world run once, and the
    single-device references; results by rank."""
    tmp = tmp_path_factory.mktemp("recurrent_world")
    inputs = {}
    for i, family in enumerate(w.ARCHS):
        cfg = w.family_cfg(jax_config, family)
        params = jax.tree.map(np.asarray, jax.jit(jax_build(cfg).init)(
            jax.random.PRNGKey(i)))
        rng = np.random.default_rng(10 + i)
        inputs[family] = {
            "params": w.draw(params, rng),
            "tokens": rng.integers(0, cfg.vocab, w.LOSS_TOKENS,
                                   dtype=np.int32),
            "prompt": rng.integers(0, cfg.vocab, (4, w.PROMPT),
                                   dtype=np.int32)}
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
        refs = {family: {"jax": _jax_refs(family, inputs[family]),
                         "port": _port_refs(family, inputs[family])}
                for family in w.ARCHS}
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return inputs, box["results"], tmp, refs


@pytest.mark.parametrize("family,mesh", CASES, ids=IDS)
def test_loss_and_grads_against_the_reference(world, family, mesh):
    """The loss (the same on every rank) and the gradients, averaged over
    the data ranks and gathered whole, against ``jax.value_and_grad`` of
    the reference's single-device loss and the port's single device, at
    2e-4."""
    _, res, _, refs = world
    for rank in range(w.WORLD):
        got = res[rank][f"train_{family}_{mesh}"]["loss"]
        np.testing.assert_allclose(got, refs[family]["jax"]["loss"], **TOL)
        np.testing.assert_allclose(got, refs[family]["port"]["loss"], **TOL)
    grads = res[0][f"train_{family}_{mesh}"]["grads"]
    _assert_tree(grads, refs[family]["jax"]["grads"], **TOL)
    _assert_tree(grads, refs[family]["port"]["grads"], **TOL)


# the head-aligned leaves' local shapes a rank (the layer axes first)
LOCAL = {
    # 8 Mamba2 heads of 32: in_proj packs z, x (heads·32 each), B and C
    # (16 each, whole) and dt (heads); out_proj's rows are the heads'
    ("hybrid", "22"): {"mamba_groups.mixer.in_proj": (2, 2, 128, 292),
                       "mamba_groups.mixer.conv_w": (2, 2, 4, 160),
                       "mamba_groups.mixer.norm.scale": (2, 2, 128),
                       "mamba_groups.mixer.dt_bias": (2, 2, 8),
                       "shared_attn.attn.wq": (128, 64)},
    ("hybrid", "14"): {"mamba_tail.mixer.in_proj": (1, 128, 162),
                       "mamba_tail.mixer.out_proj": (1, 64, 128),
                       "shared_attn.attn.wq": (128, 32)},
    # 4 mLSTM heads of 64; the sLSTM's up projection (d_up = 170) split
    # on model = 2, replicated on 4, its cell always replicated
    ("ssm", "22"): {"mlstm_groups.mixer.up_l": (1, 3, 128, 128),
                    "mlstm_groups.mixer.w_igate": (1, 3, 128, 4),
                    "mlstm_groups.mixer.b_igate": (1, 3, 2),
                    "slstm.cell.up_l": (1, 128, 85),
                    "slstm.cell.r_gates": (1, 4, 32, 128)},
    ("ssm", "14"): {"mlstm_groups.mixer.wq": (1, 3, 1, 64, 64),
                    "mlstm_groups.mixer.down": (1, 3, 64, 128),
                    "slstm.cell.up_l": (1, 128, 170)},
}


@pytest.mark.parametrize("family,mesh", CASES, ids=IDS)
def test_local_blocks_hold_whole_heads(world, family, mesh):
    """The rank's blocks: whole heads of Mamba2 (the packed in_proj), the
    mLSTM and the shared attention, the sLSTM cell replicated, its up
    projection split only where d_up divides the model axis."""
    _, res, _, _ = world
    shapes = res[1][f"train_{family}_{mesh}"]["local_shapes"]
    for path, want in LOCAL[(family, mesh)].items():
        assert shapes[path] == want, path


@pytest.mark.parametrize("family,mesh", CASES, ids=IDS)
def test_decode_on_a_mesh(world, family, mesh):
    """A token-by-token prefill of 8 tokens and 6 greedy steps through
    ``LM.decode_step`` on the mesh (the cache placed by
    ``LM.cache_specs``: the recurrent states hold the rank's heads, the
    sLSTM's replicated): every step's gathered logits against the
    reference's ``decode_step`` and the port's single device at 2e-4,
    the greedy tokens equal to the reference's."""
    _, res, _, refs = world
    got = res[0][f"decode_{family}_{mesh}"]
    ref = refs[family]
    np.testing.assert_allclose(got["logits"], ref["jax"]["logits"], **TOL)
    np.testing.assert_allclose(got["logits"], ref["port"]["logits"], **TOL)
    np.testing.assert_array_equal(got["tokens"], ref["jax"]["tokens"])
    cache = got["cache_shapes"]
    rows = 2 if mesh == "22" else 4
    if family == "hybrid":
        # the rank's 4 or 2 of 8 Mamba2 heads; its x channels, B and C
        assert cache["mamba.ssm"][2:4] == (rows, 4 if mesh == "22" else 2)
        assert cache["mamba.conv"][-1] == (160 if mesh == "22" else 96)
        assert cache["kv.k"][1:] == (rows, 14, 4, 32)
    else:
        assert cache["mlstm.s"][2:4] == (rows, 2 if mesh == "22" else 1)
        assert cache["slstm.h"][1:] == (rows, 128)


def _compression_bytes(res) -> int:
    """The factor collectives' bytes a rank on the model axis of (2, 2),
    ring counted, from each compressible leaf's whole shape and split:
    columns, one all-reduce of P (n×k); rows, an all-gather of the rank's
    rows of P and an all-reduce of Q (m×k)."""
    model = LM(w.family_cfg(get_config, "hybrid"), device="cpu")
    ctx = ShardingCtx(mesh=MeshShape((2, 2), ("data", "model")),
                      rules=sharding.DEFAULT_RULES)
    specs = _flat(model.param_specs(ctx))
    shapes = _flat(model.param_shapes())
    total, world_ = 0, 2
    k = w.COMP_RANK
    for path, spec in specs.items():
        shape = shapes[path]
        n, m = int(np.prod(shape[:-1])), shape[-1]
        if len(shape) < 2 or min(n, m) < w.COMP_MIN_DIM:
            continue
        split = [d for d, e in enumerate(spec) if e is not None]
        if not split:
            continue
        if split[0] == len(shape) - 1:
            total += 2 * (world_ - 1) * n * k * 4 // world_
        else:
            total += (world_ - 1) * (n // world_) * k * 4 \
                + 2 * (world_ - 1) * m * k * 4 // world_
    return total


def test_compression_on_a_model_axis(world):
    """Rank-4 compression on (2, 2) of reduced zamba2's gradients (its
    packed in_proj and the attention's wq split on their last dimension,
    out_proj, wo and the vocab tables on an earlier one): the
    decompressed gradients, gathered, equal the single device's
    compression of the whole leaves from the same Q₀ (``init_compression``
    from the same generator) within 1e-4 of each leaf's largest entry;
    the factor collectives' bytes on the model axis are their formula's,
    and the data axis carries none."""
    inputs, res, _, _ = world
    got = res[0]["compression"]
    grads = params_from_numpy(got["grads"], "cpu")
    state = gc.init_compression(
        grads, rank=w.COMP_RANK, min_dim=w.COMP_MIN_DIM,
        generator=torch.Generator().manual_seed(w.COMP_SEED))
    want = w._np(gc.decompress_tree(gc.compress_tree(grads, state)[0]))
    lowrank = 0
    for path, leaf in _flat(want).items():
        dec = _flat(got["decompressed"])[path]
        raw = _flat(got["grads"])[path]
        lowrank += not np.array_equal(dec, raw)
        scale = max(float(np.abs(leaf).max()), 1e-30)
        assert float(np.abs(dec - leaf).max()) <= COMP_TOL * scale, path
    assert lowrank >= 10
    specs = got["specs"]
    assert "Packed" in specs["mamba_groups.mixer.in_proj"]
    assert specs["mamba_groups.mixer.out_proj"].count("'model'") == 1
    nbytes = got["bytes"]
    assert nbytes["on_model"] == _compression_bytes(res)
    assert nbytes.get("on_data", 0) == 0


def test_checkpoint_across_meshes(world):
    """zamba2's state after a step on (2, 2), saved gathered in the
    reference's format: restored onto (1, 4) bit for bit (params and the
    first moments, gathered whole), onto one device by the port's
    manager, and by the reference's CheckpointManager, each the same whole
    params."""
    inputs, res, tmp, _ = world
    got = res[0]["checkpoint"]
    assert got["restored_step"] == 1
    assert got["local_in_proj"] == (2, 2, 128, 162)
    for key in ("params", "m"):
        for path, v in _flat(got["saved"][key]).items():
            assert np.array_equal(_flat(got["restored"][key])[path], v), (
                key, path)
    saved = _flat(got["saved"]["params"])
    model = LM(w.family_cfg(get_config, "hybrid"), device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    template = TrainState(params, adamw_init(params), torch.Generator())
    one = CheckpointManager(str(tmp / "ckpt"), async_save=False).restore(
        template, step=1)
    for path, v in _flat(one.params).items():
        assert np.array_equal(v.numpy(), saved[path]), path
    jparams = jax.tree.map(jnp.zeros_like, jax.tree.map(
        jnp.asarray, inputs["hybrid"]["params"]))
    jtemplate = JaxTrainState(params=jparams, opt=jax_opt.adamw_init(
        jparams), rng=np.zeros_like(torch.Generator().get_state().numpy()))
    back = JaxCheckpointManager(str(tmp / "ckpt"), async_save=False).restore(
        jtemplate, step=1)
    for path, v in _flat(jax.tree.map(np.asarray, back.params)).items():
        assert np.array_equal(v, saved[path]), path
    assert int(back.opt.step) == 1


def test_launch_train_hybrid_with_compression_on_a_mesh(world):
    """``launch/train.py --mesh local --model-parallel 2`` for reduced
    zamba2 with ``--compression-rank 2`` on the four ranks: the loss at
    every step equals the ``--mesh none`` run's (the same command on one
    device, Q₀ from the same seed) at 2e-4."""
    _, res, _, _ = world
    sharded = res[0]["launch"]
    single = train_mod.train(
        get_config("zamba2-1.2b").reduced(), steps=w.LAUNCH_STEPS, batch=4,
        seq=32, compression_rank=2, log_every=1, device="cpu")["history"]
    assert [h["step"] for h in sharded] == [1, 2, 3]
    want = {h["step"]: h["loss"] for h in single}
    for h in sharded:
        np.testing.assert_allclose(h["loss"], want[h["step"]], **TOL)
