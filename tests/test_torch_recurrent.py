"""The port's recurrent families, hybrid (zamba2) and ssm (xlstm), on the
CPU against the JAX package: the Mamba2 SSD scan and the mLSTM chunkwise
form at a length shorter than a chunk, a multiple of it and a padded one;
the three recurrent decode steps; the whole ``LM`` and ``ServeEngine``
(token-by-token prefill, then decode) on the same weights, handed over
with ``params_from_numpy``, at reduced widths in f32, to 1e-4, the
reference's serving tolerance (``tests/test_serve.py``); greedy tokens
exactly.  The leaves the reference initialises to constants (conv and
gate biases, decay and skip, the gates' weights, the sLSTM's equal up
projections) are drawn, so that every path counts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models import ssm as jax_ssm
from repro.models import xlstm as jax_xlstm
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM, params_from_numpy, ssm, xlstm
from repro_torch.serve import ServeEngine

from conftest import assert_close

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = {"zamba2": "zamba2-1.2b", "xlstm": "xlstm-350m"}
# the reduced configs' chunk is 32: shorter, a multiple, padded
LENGTHS = [16, 64, 45]

# leaves the reference initialises to constants, and the scale to draw
# them at
DRAWN = {"conv_b": 0.1, "dt_bias": 0.5, "a_log": 0.5, "d_skip": 0.5,
         "w_igate": 0.1, "b_igate": 1.0, "w_fgate": 0.1, "b_fgate": 1.0,
         "up_r": None}


def _draw(tree, rng):
    """The ``DRAWN`` leaves of a numpy param tree replaced by draws
    (``up_r`` at ``up_l``'s scale, so the two differ), in place."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _draw(leaf, rng)
        elif name in DRAWN:
            scale = DRAWN[name] or float(np.std(tree["up_l"]))
            tree[name] = (rng.normal(size=leaf.shape) * scale).astype(
                leaf.dtype)
    return tree


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(case, seed=0, **changes):
    """(jax model, jax params, port model, port params) on the same
    weights, the reduced config with ``changes``."""
    jcfg = dataclasses.replace(jax_config(ARCHS[case]).reduced(), **changes)
    tcfg = dataclasses.replace(get_config(ARCHS[case]).reduced(), **changes)
    jm = jax_build(jcfg)
    params = _draw(_numpy(jm.init(jax.random.PRNGKey(seed))),
                   np.random.default_rng(seed))
    return (jm, jax.tree.map(jnp.asarray, params), LM(tcfg, device="cpu"),
            params_from_numpy(params, "cpu"))


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _ssd_inputs(s, rng, b=2, h=3, p=4, n=5):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a_log = (rng.normal(size=h) * 0.5).astype(np.float32)
    bmat = rng.normal(size=(b, s, n)).astype(np.float32)
    cmat = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, a_log, bmat, cmat


@pytest.mark.parametrize("s,with_state", [(s, False) for s in LENGTHS]
                         + [(45, True), (64, True)])
def test_chunked_ssd_matches_jax(s, with_state, rng):
    args = _ssd_inputs(s, rng)
    init = (rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
            if with_state else None)
    jy, jstate = jax.jit(jax_ssm.chunked_ssd, static_argnums=5)(
        *map(jnp.asarray, args), 32,
        init_state=None if init is None else jnp.asarray(init))
    ty, tstate = ssm.chunked_ssd(*map(_t, args), 32,
                                 init_state=None if init is None
                                 else _t(init))
    assert ty.shape == (2, s, 3, 4) and tstate.shape == (2, 3, 5, 4)
    assert_close(ty.numpy(), jy, **TOL)
    assert_close(tstate.numpy(), jstate, **TOL)


def test_chunked_ssd_keeps_inf_out_of_the_masked_decay(rng):
    """Decays steep enough that exp above the diagonal overflows to inf:
    the output stays finite, as the reference's does."""
    x, dt, _, bmat, cmat = _ssd_inputs(32, rng)
    a_log = np.full(3, 5.0, np.float32)        # A = -148: exp(+4700) = inf
    ty, _ = ssm.chunked_ssd(*map(_t, (x, dt * 10, a_log, bmat, cmat)), 32)
    jy, _ = jax.jit(jax_ssm.chunked_ssd, static_argnums=5)(
        *map(jnp.asarray, (x, dt * 10, a_log, bmat, cmat)), 32)
    assert torch.isfinite(ty).all()
    assert_close(ty.numpy(), jy, **TOL)


@pytest.mark.parametrize("s", LENGTHS)
def test_mlstm_chunkwise_matches_jax(s, rng):
    b, h, hd = 2, 2, 8
    q, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    log_i = rng.normal(size=(b, s, h)).astype(np.float32)
    log_f = -np.log1p(np.exp(-rng.normal(size=(b, s, h)) - 2)).astype(
        np.float32)
    args = (q, k, v, log_i, log_f)
    want = jax.jit(jax_xlstm.mlstm_chunkwise, static_argnums=5)(
        *map(jnp.asarray, args), 32)
    got = xlstm.mlstm_chunkwise(*map(_t, args), 32)
    assert got.shape == (b, s, h, hd)
    assert_close(got.numpy(), want, **TOL)


def _block_params(kind, cfg, jcfg, seed):
    """One block's params from the JAX initialiser, drawn, for both."""
    init = {"mamba2": jax_ssm.init_mamba2, "mlstm": jax_xlstm.init_mlstm,
            "slstm": jax_xlstm.init_slstm}[kind]
    params = _draw(_numpy(init(jcfg, jnp.float32, jax.random.PRNGKey(seed))),
                   np.random.default_rng(seed))
    return jax.tree.map(jnp.asarray, params), params_from_numpy(params, "cpu")


STEPS = {
    "mamba2": ("zamba2", lambda c, b: jax_ssm.init_mamba2_state(
        c, b, jnp.float32), lambda c, b: ssm.init_mamba2_state(
        c, b, torch.float32, "cpu"), jax_ssm.mamba2_decode_step,
        ssm.mamba2_decode_step, jax_ssm.mamba2_block, ssm.mamba2_block),
    "mlstm": ("xlstm", lambda c, b: jax_xlstm.init_mlstm_state(
        c, b, jnp.float32), lambda c, b: xlstm.init_mlstm_state(
        c, b, torch.float32, "cpu"), jax_xlstm.mlstm_decode_step,
        xlstm.mlstm_decode_step, jax_xlstm.mlstm_block, xlstm.mlstm_block),
    "slstm": ("xlstm", lambda c, b: jax_xlstm.init_slstm_state(c, b),
              lambda c, b: xlstm.init_slstm_state(c, b, "cpu"),
              jax_xlstm.slstm_decode_step, xlstm.slstm_decode_step,
              jax_xlstm.slstm_block, xlstm.slstm_block),
}


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_decode_steps_match_jax(kind, rng):
    """8 steps of one block's recurrent step from a zero state: outputs
    and every state leaf, which the port updates in place."""
    case, jinit, tinit, jstep, tstep, _, _ = STEPS[kind]
    jcfg = jax_config(ARCHS[case]).reduced()
    tcfg = get_config(ARCHS[case]).reduced()
    jp, tp = _block_params(kind, tcfg, jcfg, seed=5)
    jstate, tstate = jinit(jcfg, 2), tinit(tcfg, 2)
    jstep = jax.jit(jstep, static_argnums=1)
    storage = {k: v.data_ptr() for k, v in tstate.items()}
    for i in range(8):
        x = (rng.normal(size=(2, 1, tcfg.d_model)) * 0.5).astype(np.float32)
        jout, jstate = jstep(jp, jcfg, jnp.asarray(x), jstate)
        tout, tstate = tstep(tp, tcfg, _t(x), tstate)
        assert_close(tout.numpy(), jout, **TOL, msg=f"step {i}")
        for name, leaf in jstate.items():
            assert_close(tstate[name].numpy(), leaf, **TOL,
                         msg=f"step {i} state {name}")
    assert {k: v.data_ptr() for k, v in tstate.items()} == storage


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_blocks_match_jax(kind, rng):
    """One block over a padded length (45, chunk 32)."""
    case, _, _, _, _, jblock, tblock = STEPS[kind]
    jcfg = jax_config(ARCHS[case]).reduced()
    tcfg = get_config(ARCHS[case]).reduced()
    jp, tp = _block_params(kind, tcfg, jcfg, seed=6)
    x = (rng.normal(size=(2, 45, tcfg.d_model)) * 0.5).astype(np.float32)
    want = jax.jit(jblock, static_argnums=1)(jp, jcfg, jnp.asarray(x))
    assert_close(tblock(tp, tcfg, _t(x)).numpy(), want, **TOL)


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_forward_matches_jax(case):
    jm, jp, tm, tp = _pair(case)
    toks = _tokens(tm.cfg, 2, 45)
    jl, jaux = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tm.forward(tp, {"tokens": toks})
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert_close(tl.numpy(), jl, **TOL)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_engine_prefill_and_decode_match_jax(case):
    """The token-by-token prefill of 12 tokens, then 8 decode steps,
    logits and the final caches against the JAX engine's."""
    jm, jp, tm, tp = _pair(case, seed=2)
    prompts = _tokens(tm.cfg, 2, 12, seed=3)
    jeng = JaxServeEngine(jm, jp, batch_size=2, max_seq=24)
    teng = ServeEngine(tm, tp, batch_size=2, max_seq=24)
    assert_close(teng.prefill(prompts).numpy(), jeng.prefill(prompts), **TOL)
    assert teng._pos == 12
    steps = _tokens(tm.cfg, 2, 8, seed=4)
    for i in range(8):
        jl, jeng.cache = jeng._decode(jp, jeng.cache,
                                      jnp.asarray(steps[:, i:i + 1]),
                                      jnp.asarray(12 + i, jnp.int32))
        tl = teng.decode(steps[:, i])
        assert_close(tl.numpy(), jl[:, 0], **TOL, msg=f"step {i}")
    want = dict(_flat(_numpy(jeng.cache)))
    got = dict(_flat(teng.cache))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert got[name].shape == leaf.shape, name
        assert_close(got[name].numpy(), leaf, **TOL, msg=name)


def _flat(tree, prefix=""):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _flat(leaf, f"{prefix}{name}.")
        else:
            yield prefix + name, leaf


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_greedy_generation_matches_jax(case):
    jm, jp, tm, tp = _pair(case, seed=7)
    prompts = _tokens(tm.cfg, 2, 10, seed=8)
    want = JaxServeEngine(jm, jp, batch_size=2, max_seq=24).generate(
        prompts, max_new=8)
    got = ServeEngine(tm, tp, batch_size=2, max_seq=24).generate(
        prompts, max_new=8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_decode_matches_forward(case):
    """The reference's own check (``tests/test_models_smoke.py``): every
    decode step's logits against forward's at its position, < 5e-4."""
    _, _, tm, tp = _pair(case, seed=3)
    toks = _tokens(tm.cfg, 2, 16, seed=4)
    full, _ = tm.forward(tp, {"tokens": toks})
    cache = tm.init_cache(2, 32)
    worst = 0.0
    for t in range(16):
        logits, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
        worst = max(worst, float((logits[:, 0] - full[:, t]).abs().max()))
    assert worst < 5e-4, worst


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_prefill_raises_as_the_reference(case):
    jm, jp, tm, tp = _pair(case)
    toks = _tokens(tm.cfg, 1, 4)
    with pytest.raises(NotImplementedError, match="recurrent decode path"):
        jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 8)
    with pytest.raises(NotImplementedError, match="recurrent decode path"):
        tm.prefill(tp, {"tokens": toks}, 8)


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_mixed_dtype_trees_hand_over_unchanged(case):
    """A bf16 model's tree keeps its f32 leaves (decay, skip, gates, the
    sLSTM's gate weights) in f32 and the rest in bf16, leaf for leaf,
    through nested stacking; the port's own init agrees on every
    leaf's name, shape and type."""
    jcfg = dataclasses.replace(jax_config(ARCHS[case]).reduced(),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(get_config(ARCHS[case]).reduced(),
                               dtype="bfloat16")
    params = _numpy(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    got = dict(_flat(params_from_numpy(params, "cpu")))
    own = dict(_flat(LM(tcfg, device="cpu").init(
        torch.Generator().manual_seed(0))))
    want = dict(_flat(params))
    assert sorted(got) == sorted(want) == sorted(own)
    f32 = {"dt_bias", "a_log", "d_skip", "w_igate", "b_igate", "w_fgate",
           "b_fgate", "w_gates", "r_gates", "b_gates"}
    for name, leaf in want.items():
        dtype = torch.float32 if name.split(".")[-1] in f32 \
            else torch.bfloat16
        assert got[name].dtype == own[name].dtype == dtype, name
        assert got[name].shape == own[name].shape == leaf.shape, name
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      leaf.astype(np.float32), err_msg=name)


def test_slstm_init_draws_equal_up_projections():
    """The reference's quirk, reproduced: one key for both up
    projections (ROADMAP.md Queue 3)."""
    tm = LM(get_config("xlstm-350m").reduced(), device="cpu")
    cell = tm.init(torch.Generator().manual_seed(0))["slstm"]["cell"]
    torch.testing.assert_close(cell["up_l"], cell["up_r"], rtol=0, atol=0)
    params = _numpy(jax_build(jax_config("xlstm-350m").reduced()).init(
        jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(params["slstm"]["cell"]["up_l"],
                                  params["slstm"]["cell"]["up_r"])


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_second_prefill_starts_from_a_zero_state(case):
    """The port's engine zeroes the recurrent state before a prefill, so a
    second prefill of the same prompts gives the first's logits (the
    reference's steps on from the state the first left)."""
    _, _, tm, tp = _pair(case, seed=9)
    prompts = _tokens(tm.cfg, 2, 6, seed=10)
    eng = ServeEngine(tm, tp, batch_size=2, max_seq=16)
    first = eng.prefill(prompts)
    eng.decode(eng.sample(first))
    torch.testing.assert_close(eng.prefill(prompts), first, rtol=0, atol=0)


def test_cache_layout_of_the_full_configs():
    """zamba2-1.2b: 6 groups of 6 Mamba2 blocks and a tail of 2, one KV
    cache a group; xlstm-350m: 3 groups of 7 mLSTM blocks and an sLSTM."""
    zamba = LM(get_config("zamba2-1.2b"), device="cpu")
    xl = LM(get_config("xlstm-350m"), device="cpu")
    assert zamba._zamba_layout() == (6, 2)
    assert xl._xlstm_layout() == (3, 7)
    zcfg = dataclasses.replace(get_config("zamba2-1.2b"), d_model=64,
                               n_heads=2, n_kv_heads=2, head_dim=8)
    cache = LM(zcfg, device="cpu").init_cache(2, 5)
    assert cache["kv"]["k"].shape == (6, 2, 5, 2, 8)
    assert cache["mamba"]["ssm"].shape == (6, 6, 2, 2, 64, 64)
    assert cache["mamba_tail"]["conv"].shape == (2, 2, 3, 2 * 64 + 128)


def test_serve_cli_runs_zamba2_on_the_cpu(capsys):
    serve_cli.main(["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "zamba2-1.2b-reduced on cpu: generated (2, 4)" in out
