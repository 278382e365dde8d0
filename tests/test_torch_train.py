"""The port's training path on the CPU against the JAX package: the same
weights (handed over with ``params_from_numpy``) and batches through
both ``LM.loss``es and their gradients (``torch.autograd`` through the
plain attention against ``jax.value_and_grad``), at reduced widths in f32,
to 2e-4, the kernels' tolerance (``tests/conftest.py``); AdamW,
momentum-SGD, the global norm and the cosine schedule over the same
gradients; one train step with microbatches; low-rank compression with
Q₀ handed over (the reference draws it from a per-process string hash);
the prefetching pipeline.  Beside them the reference's own checks
(``tests/test_models_smoke.py``): the loss falls over 8 steps for every
family."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.models import build_model as jax_build
from repro.train import grad_compression as jax_gc
from repro.train import optimizer as jax_opt
from repro.train.train_step import TrainState as JaxTrainState
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import TokenPipeline, synth_batch
from repro_torch.models import LM, params_from_numpy
from repro_torch.train import (adamw_init, adamw_update,
                               compress_tree, compression_ratio,
                               compression_state_from_numpy, cosine_schedule,
                               decompress_tree, global_norm,
                               init_compression, init_train_state,
                               make_train_step, opt_state_from_numpy,
                               require_grad, sgdm_init, sgdm_update)

from conftest import assert_close

TOL = dict(rtol=2e-4, atol=2e-4)
# one reduced config of each family
FAMILIES = {"dense": "h2o-danube-1.8b", "moe": "qwen2-moe-a2.7b",
            "vlm": "paligemma-3b", "audio": "hubert-xlarge",
            "hybrid": "zamba2-1.2b", "ssm": "xlstm-350m"}


def _flat(tree, prefix=""):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _flat(leaf, f"{prefix}{name}.")
        else:
            yield prefix + name, leaf


def _pair(family, seed=0, **changes):
    """(jax model, jax params, port model, port params requiring grad) on
    the same weights, the reduced config with ``changes``."""
    arch = FAMILIES[family]
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    jm = jax_build(jcfg)
    # jitted: the reference's eager init takes seconds at these widths
    params = jax.tree.map(np.asarray,
                          jax.jit(jm.init)(jax.random.PRNGKey(seed)))
    return (jm, jax.tree.map(jnp.asarray, params), LM(tcfg, device="cpu"),
            require_grad(params_from_numpy(params, "cpu")))


def _batch(cfg, b=2, s=40, seed=1):
    return synth_batch(cfg, ShapeConfig("t", s, b, "train"), seed=seed)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_grads(tm, tp, batch):
    loss, metrics = tm.loss(tp, batch)
    names, leaves = zip(*_flat(tp))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss, metrics, dict(zip(names, grads))


def _assert_grads(got, want):
    want = dict(_flat(want))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert got[name].shape == leaf.shape, name
        assert_close(got[name].detach().numpy(), leaf, **TOL, msg=name)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_gradients_match_jax(family):
    jm, jp, tm, tp = _pair(family)
    batch = _batch(tm.cfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, _jax(batch))
    loss, metrics, grads = _port_grads(tm, tp, batch)
    assert_close(loss.detach().numpy(), jloss, **TOL)
    for key in ("ce", "aux"):
        assert_close(metrics[key].detach().numpy(), jmet[key], **TOL)
    _assert_grads(grads, jgrads)


def test_block_remat_gives_the_same_loss_and_gradients():
    """``remat="block"`` runs each block under torch.utils.checkpoint: the
    loss and every gradient as the reference's (under its checkpoint
    policy) and as the port's without remat, bit for bit."""
    jm, jp, tm, tp = _pair("dense", seed=3, remat="block")
    batch = _batch(tm.cfg, seed=4)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, _jax(batch))
    loss, _, grads = _port_grads(tm, tp, batch)
    assert_close(loss.detach().numpy(), jloss, **TOL)
    _assert_grads(grads, jgrads)
    plain = LM(dataclasses.replace(tm.cfg, remat="none"), device="cpu")
    loss0, _, grads0 = _port_grads(plain, tp, batch)
    assert torch.equal(loss0, loss)
    for name, g in grads0.items():
        assert torch.equal(g, grads[name]), name


def test_chunked_ssd_gradients_stay_finite_where_the_decay_overflows(rng):
    """Decays steep enough that exp above the diagonal overflows to inf
    (zamba2 at published width, chunk 256): the Mamba2 scan's gradients
    stay finite (the exp takes -inf there, not inf selected away after
    it, whose gradient is 0·inf) and equal to float64 autograd's."""
    from repro_torch.models import ssm
    x, bmat, cmat = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     for s in ((2, 32, 3, 4), (2, 32, 5), (2, 32, 5)))
    dt = torch.from_numpy(np.log1p(np.exp(rng.normal(size=(2, 32, 3)))
                                   ).astype(np.float32)) * 10
    a_log = torch.full((3,), 5.0)              # A = -148: exp(+4700) = inf
    grads = []
    for dtype in (torch.float32, torch.float64):
        leaves = [t.detach().to(dtype).requires_grad_(True)
                  for t in (x, dt, bmat, cmat)]
        y, state = ssm.chunked_ssd(leaves[0], leaves[1], a_log.to(dtype),
                                   leaves[2], leaves[3], 32)
        (y.sum() + state.sum()).backward()
        grads.append([t.grad for t in leaves])
    for g32, g64 in zip(*grads):
        assert torch.isfinite(g32).all()
        assert_close(g32.numpy(), g64.numpy(), **TOL)


def _tree(rng, scale=1.0):
    """A small param-shaped tree of numpy f32 leaves."""
    return {"a": {"w": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
                  "b": (rng.normal(size=(5,)) * scale).astype(np.float32)},
            "c": (rng.normal(size=(3, 4, 2)) * scale).astype(np.float32)}


def _torch(tree):
    return params_from_numpy(tree, "cpu")


def test_adamw_matches_jax_over_three_steps(rng):
    """Three AdamW steps on the same gradients; the second step's are 100x
    larger, so the global-norm clip bites there (norm > 1)."""
    params = _tree(rng)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_opt.adamw_init(jparams)
    tparams = _torch(params)
    tstate = adamw_init(tparams)
    schedule = cosine_schedule(1e-2, 1, 10)
    jschedule = jax_opt.cosine_schedule(1e-2, 1, 10)
    norms = []
    for scale in (0.01, 1.0, 0.02):
        grads = _tree(rng, scale)
        jlr = jschedule(jstate.step + 1)
        jparams, jstate, jmet = jax_opt.adamw_update(
            jax.tree.map(jnp.asarray, grads), jstate, jparams, lr=jlr)
        lr = schedule(tstate.step + 1)
        assert_close(lr.numpy(), jlr)
        tparams, tstate, met = adamw_update(_torch(grads), tstate, tparams,
                                            lr=lr)
        assert_close(met["grad_norm"].numpy(), jmet["grad_norm"])
        norms.append(float(met["grad_norm"]))
        assert int(tstate.step) == int(jstate.step)
        for got, want in ((tparams, jparams), (tstate.master, jstate.master),
                          (tstate.m, jstate.m), (tstate.v, jstate.v)):
            for name, leaf in _flat(want):
                assert_close(dict(_flat(got))[name].numpy(), leaf, msg=name)
    assert norms[1] > 1.0 > norms[0]


def test_adamw_master_copy_never_aliases_an_f32_param(rng):
    params = _torch(_tree(rng))
    state = adamw_init(params)
    for name, p in _flat(params):
        assert dict(_flat(state.master))[name].data_ptr() != p.data_ptr()


def test_adamw_takes_the_references_state(rng):
    """A reference OptState, handed over leaf by leaf, continues as the
    reference continues."""
    params = _tree(rng)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_opt.adamw_init(jparams)
    grads = jax.tree.map(jnp.asarray, _tree(rng, 0.1))
    jparams, jstate, _ = jax_opt.adamw_update(grads, jstate, jparams,
                                              lr=1e-2)
    tstate = opt_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    tparams = _torch(jax.tree.map(np.asarray, jparams))
    grads = _tree(rng, 0.1)
    jparams, _, _ = jax_opt.adamw_update(jax.tree.map(jnp.asarray, grads),
                                         jstate, jparams, lr=1e-2)
    tparams, tstate, _ = adamw_update(_torch(grads), tstate, tparams,
                                      lr=1e-2)
    assert int(tstate.step) == 2
    for name, leaf in _flat(jparams):
        assert_close(dict(_flat(tparams))[name].numpy(), leaf, msg=name)


def test_sgdm_and_global_norm_match_jax(rng):
    params = _tree(rng)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_opt.sgdm_init(jparams)
    tparams = _torch(params)
    tstate = sgdm_init(tparams)
    for _ in range(3):
        grads = _tree(rng, 0.5)
        assert_close(global_norm(_torch(grads)).numpy(),
                     jax_opt.global_norm(grads))
        jparams, jstate, _ = jax_opt.sgdm_update(
            jax.tree.map(jnp.asarray, grads), jstate, jparams, lr=0.1)
        tparams, tstate, _ = sgdm_update(_torch(grads), tstate, tparams,
                                         lr=0.1)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for got, want in ((tparams, jparams), (tstate["mom"], jstate["mom"])):
        for name, leaf in _flat(want):
            assert_close(dict(_flat(got))[name].numpy(), leaf, msg=name)


def test_cosine_schedule_matches_jax():
    want = jax_opt.cosine_schedule(3e-4, 10, 100)
    got = cosine_schedule(3e-4, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert_close(got(torch.tensor(step, dtype=torch.int32)).numpy(),
                     want(jnp.asarray(step, jnp.int32)), rtol=1e-6,
                     atol=1e-12)


@pytest.mark.parametrize("family,microbatches", [("dense", 2), ("moe", 1)])
def test_train_step_matches_jax(family, microbatches):
    """One step from the same params and a zero AdamW state: the loss, the
    global norm, both moments (which carry the averaged gradients) and the
    new params.  The learning rate is small, so that a gradient that is
    rounding noise in both (whose sign Adam's update follows) moves a
    param by less than the tolerance."""
    jm, jp, tm, tp = _pair(family, seed=5)
    batch = _batch(tm.cfg, b=4, seed=6)
    opts = dict(lr=5e-5, warmup=1, total_steps=10, microbatches=microbatches)
    jstate = JaxTrainState(params=jp, opt=jax_opt.adamw_init(jp),
                           rng=jax.random.PRNGKey(0))
    jstate, jmet = jax.jit(jax_make_train_step(jm, **opts))(jstate,
                                                            _jax(batch))
    from repro_torch.train import TrainState
    tstate = TrainState(params=tp, opt=adamw_init(tp),
                        rng=torch.Generator())
    tstate, met = make_train_step(tm, **opts)(tstate, batch)
    assert_close(met["loss"].numpy(), jmet["loss"], **TOL)
    assert_close(met["grad_norm"].numpy(), jmet["grad_norm"], **TOL)
    assert_close(met["lr"].numpy(), jmet["lr"], rtol=1e-6, atol=1e-12)
    for got, want in ((tstate.params, jstate.params),
                      (tstate.opt.m, jstate.opt.m)):
        _assert_grads(dict(_flat(got)), want)
    # v = 0.05 g^2: relative to each leaf's largest entry
    for name, leaf in _flat(jstate.opt.v):
        got = dict(_flat(tstate.opt.v))[name].numpy()
        scale = float(np.abs(leaf).max()) or 1.0
        assert_close(got / scale, np.asarray(leaf) / scale, **TOL, msg=name)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_decreases_over_few_steps(family):
    """The reference's check: 8 steps on one fixed batch, at lr 3e-3."""
    cfg = get_config(FAMILIES[family]).reduced()
    model = LM(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(2))
    step = make_train_step(model, lr=3e-3, warmup=1, total_steps=100)
    batch = synth_batch(cfg, ShapeConfig("smoke", 64, 2, "train"), seed=7)
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(float(metrics["grad_norm"]))
    assert losses[-1] < losses[0], losses


def test_compression_matches_jax_with_q_handed_over(rng):
    """compress_tree / decompress_tree on the same gradients and Q₀: the
    approximations P Qᵀ, the error buffers and the ratio (P and Q alone
    may differ by the QR's column signs)."""
    params = {"w1": rng.normal(size=(40, 24)).astype(np.float32),
              "w2": rng.normal(size=(3, 16, 20)).astype(np.float32),
              "b": rng.normal(size=(24,)).astype(np.float32),
              "small": rng.normal(size=(4, 30)).astype(np.float32)}
    jstate = jax_gc.init_compression(jax.tree.map(jnp.asarray, params),
                                     rank=3, min_dim=8)
    tstate = compression_state_from_numpy(
        jax.tree.map(np.asarray, jstate), "cpu")
    assert tstate.q["b"] is None and tstate.q["small"] is None
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
    jc, jnew = jax_gc.compress_tree(jax.tree.map(jnp.asarray, grads), jstate)
    tc, tnew = compress_tree(_torch(grads), tstate)
    want = jax_gc.decompress_tree(jc)
    got = decompress_tree(tc)
    for name in params:
        assert got[name].shape == want[name].shape
        assert_close(got[name].numpy(), want[name], msg=name)
    for name in ("w1", "w2"):
        assert_close(tnew.err[name].numpy(), jnew.err[name], msg=name)
    assert compression_ratio(tc) == pytest.approx(
        jax_gc.compression_ratio(jc))
    own = init_compression(_torch(params), rank=3, min_dim=8,
                           generator=torch.Generator().manual_seed(0))
    assert own.q["w2"].shape == (20, 3) and own.err["w2"].shape == (48, 20)
    assert own.q["b"] is None and own.err["small"] is None


def test_compressed_train_step_runs_and_moves_the_params():
    cfg = get_config(FAMILIES["dense"]).reduced()
    model = LM(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(3))
    before = {n: p.detach().clone() for n, p in _flat(state.params)}
    comp = init_compression(state.params, rank=2, min_dim=64,
                            generator=torch.Generator().manual_seed(4))
    step = make_train_step(model, lr=1e-3, warmup=1, total_steps=10,
                           compression=comp)
    state, metrics = step(state, _batch(cfg))
    assert np.isfinite(float(metrics["loss"]))
    assert max(float((p.detach() - before[n]).abs().max())
               for n, p in _flat(state.params)) > 0


def test_token_pipeline_yields_the_references_batches():
    cfg = get_config("paligemma-3b").reduced()
    shape = ShapeConfig("t", 48, 2, "train")
    jcfg = jax_config("paligemma-3b").reduced()
    want = JaxTokenPipeline(jcfg, JaxShape("t", 48, 2, "train"), seed=5,
                            start_step=3)
    got = TokenPipeline(cfg, shape, seed=5, start_step=3, device="cpu")
    try:
        for _ in range(3):
            w, g = next(want), next(got)
            assert sorted(g) == sorted(w)
            for key in w:
                np.testing.assert_array_equal(g[key].numpy(), w[key])
        assert got.step == 6
    finally:
        want.close()
        got.close()
    assert not got._thread.is_alive()
    with pytest.raises(StopIteration):
        next(got)
