"""The port's LM serving path on the CPU against the JAX package: the same
weights (handed over with ``params_from_numpy``) through both ``LM``s and
``ServeEngine``s, and the incremental logit view under the same updates.
Logits agree to 1e-4, the reference's serving tolerance
(``tests/test_serve.py``); greedy tokens agree exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serve import IncrementalLogitView as JaxLogitView
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM, params_from_numpy
from repro_torch.serve import IncrementalLogitView, ServeEngine

from conftest import assert_close

TOL = dict(rtol=1e-4, atol=1e-4)

# reduced danube with grouped heads and a window the tests wrap; starcoder2
# (qkv bias, GeLU MLP, no window); command-r-plus (tied head)
CASES = {
    "danube": ("h2o-danube-1.8b", dict(n_kv_heads=2, sliding_window=16)),
    "starcoder2": ("starcoder2-7b", {}),
    "command-r": ("command-r-plus-104b", {}),
}


def _pair(case, seed=0):
    """(jax model, jax params, port model, port params) on the same
    weights; starcoder2's zero-initialised qkv biases are drawn."""
    arch, changes = CASES[case]
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    jm = jax_build(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        for name in ("bq", "bk", "bv"):
            b = params["blocks"]["attn"][name]
            params["blocks"]["attn"][name] = rng.normal(
                size=b.shape).astype(np.float32) * 0.1
    jp = jax.tree.map(jnp.asarray, params)
    return jm, jp, LM(tcfg, device="cpu"), params_from_numpy(params, "cpu")


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_prefill_and_decode_match_jax(case):
    jm, jp, tm, tp = _pair(case)
    toks = _tokens(jm.cfg, 2, 12)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": toks})
    assert_close(tl.numpy(), jl, **TOL)

    max_seq = 32
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq)
    tl, tcache = tm.prefill(tp, {"tokens": toks}, max_seq)
    assert_close(tl.numpy(), jl, **TOL)
    for name in ("k", "v"):
        assert_close(tcache["kv"][name].numpy(), jcache["kv"][name], **TOL)

    # decode 14 steps from position 12: danube's 16-slot ring wraps at 16
    steps = _tokens(jm.cfg, 2, 14, seed=2)
    jax_decode = jax.jit(jm.decode_step)
    for i in range(steps.shape[1]):
        tok = steps[:, i:i + 1]
        jl, jcache = jax_decode(jp, jcache, jnp.asarray(tok),
                                jnp.asarray(12 + i, jnp.int32))
        tl, tcache = tm.decode_step(tp, tcache, tok, 12 + i)
        assert_close(tl.numpy(), jl, **TOL, msg=f"step {i}")
    for name in ("k", "v"):
        assert_close(tcache["kv"][name].numpy(), jcache["kv"][name], **TOL)


@pytest.mark.parametrize("case", ["danube", "starcoder2"])
def test_greedy_generation_matches_jax(case):
    jm, jp, tm, tp = _pair(case, seed=3)
    prompts = _tokens(jm.cfg, 2, 10, seed=4)
    want = JaxServeEngine(jm, jp, batch_size=2, max_seq=32).generate(
        prompts, max_new=12)
    eng = ServeEngine(tm, tp, batch_size=2, max_seq=32)
    got = eng.generate(prompts, max_new=12)
    assert got.dtype == np.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got, want)
    assert eng._pos == 10 + 12


def test_decode_past_the_window_matches_forward():
    """Danube decodes past its ring's wrap; each step's logits equal the
    windowed forward's at that position (test_models_smoke.py:80)."""
    _, _, tm, tp = _pair("danube", seed=5)
    toks = _tokens(tm.cfg, 2, 40, seed=6)
    full, _ = tm.forward(tp, {"tokens": toks})
    cache = tm.init_cache(2, 64)
    assert cache["kv"]["k"].shape[2] == 16      # the ring, not max_seq
    for t in range(toks.shape[1]):
        logits, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
        assert_close(logits[:, 0].numpy(), full[:, t].numpy(), **TOL)


def test_sliding_window_masks_distant_tokens():
    _, _, tm, tp = _pair("danube", seed=7)
    t1 = _tokens(tm.cfg, 1, 32, seed=8)
    t2 = t1.copy()
    t2[:, 0] = (t2[:, 0] + 7) % tm.cfg.vocab
    l1, _ = tm.forward(tp, {"tokens": t1})
    l2, _ = tm.forward(tp, {"tokens": t2})
    torch.testing.assert_close(l1[:, -1], l2[:, -1], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(l1[:, 0], l2[:, 0])


def test_batched_prefill_matches_stepwise():
    _, _, tm, tp = _pair("starcoder2", seed=9)
    toks = _tokens(tm.cfg, 2, 12, seed=10)
    logits, cache = tm.prefill(tp, {"tokens": toks}, max_seq=32)
    step = tm.init_cache(2, 32)
    for t in range(12):
        last, step = tm.decode_step(tp, step, toks[:, t:t + 1], t)
    assert_close(logits[:, -1].numpy(), last[:, 0].numpy(), rtol=2e-4,
                 atol=2e-4)
    torch.testing.assert_close(cache["kv"]["k"], step["kv"]["k"], rtol=1e-5,
                               atol=1e-5)


def test_engine_prefill_and_sampling():
    _, _, tm, tp = _pair("command-r", seed=11)
    eng = ServeEngine(tm, tp, batch_size=2, max_seq=64, temperature=0.8,
                      seed=5)
    prompts = _tokens(tm.cfg, 2, 8, seed=12)
    last = eng.prefill(prompts)
    full, _ = tm.forward(tp, {"tokens": prompts})
    assert_close(last.numpy(), full[:, -1].numpy(), **TOL)
    draws = [eng.sample(last) for _ in range(2)]
    assert draws[0].dtype == torch.int32 and draws[0].shape == (2,)
    again = ServeEngine(tm, tp, batch_size=2, max_seq=64, temperature=0.8,
                        seed=5)
    for d in draws:    # the same seed draws the same tokens
        torch.testing.assert_close(again.sample(last), d)
    stop = int(eng.sample(last)[0])
    assert eng.generate(prompts, max_new=4, stop_token=stop).shape[0] == 2


def test_bf16_params_hand_over_exactly():
    x = jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16)
    got = params_from_numpy({"a": {"w": np.asarray(x)}}, "cpu")["a"]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
    assert params_from_numpy({"w": np.asarray(x)}, "cpu",
                             torch.float32)["w"].dtype == torch.float32


def test_every_family_builds():
    """All ten configs build (hybrid and ssm since their port, which
    tests/test_torch_recurrent.py holds to JAX), each as its family, and
    every decoder takes a decode step from its own init at reduced
    width."""
    assert sorted({cfg.family for cfg in ARCHS.values()}) == [
        "audio", "dense", "hybrid", "moe", "ssm", "vlm"]
    for arch, cfg in ARCHS.items():
        model = LM(cfg.reduced(), device="cpu")
        assert model.cfg.family == cfg.family
        if cfg.encoder_only:
            continue
        params = model.init(torch.Generator().manual_seed(0))
        cache = model.init_cache(1, 4)
        logits, _ = model.decode_step(params, cache, [[1]], 0)
        assert logits.shape == (1, 1, cfg.reduced().vocab), arch
        assert torch.isfinite(logits).all(), arch


def test_other_families_are_not_ported():
    """A family outside the reference's six raises, as the reference's
    ``LM.init`` does."""
    cfg = dataclasses.replace(ARCHS["h2o-danube-1.8b"].reduced(),
                              family="diffusion")
    with pytest.raises(ValueError, match="unknown family 'diffusion'"):
        LM(cfg, device="cpu")


def test_logit_view_matches_jax_under_head_and_corpus_updates(rng):
    m, d, p = 200, 64, 32
    H = rng.normal(size=(m, d)).astype(np.float32)
    W = rng.normal(size=(p, d)).astype(np.float32)
    jv, tv = JaxLogitView(H, W), IncrementalLogitView(H, W, device="cpu")
    assert_close(tv.logits.numpy(), jv.logits, **TOL)
    u = np.zeros((p, 1), np.float32)
    u[3] = 1.0
    v = (rng.normal(size=(d, 1)) * 0.1).astype(np.float32)
    assert_close(tv.update_head(u, v).numpy(), jv.update_head(u, v), **TOL)
    assert_close(tv.logits.numpy(), H @ (W + u @ v.T).T, rtol=1e-3,
                 atol=1e-3)
    ups = [((rng.normal(size=(p, 1)) * .1).astype(np.float32),
            (rng.normal(size=(d, 1)) * .1).astype(np.float32))
           for _ in range(5)]
    assert_close(tv.update_head_batch(ups).numpy(),
                 jv.update_head_batch(ups), **TOL)
    uc = np.zeros((m, 1), np.float32)
    uc[10] = 1.0
    vc = rng.normal(size=(d, 1)).astype(np.float32)
    assert_close(tv.add_items(uc, vc).numpy(), jv.add_items(uc, vc), **TOL)
    assert tv.speedup_estimate() == pytest.approx(jv.speedup_estimate())
    assert IncrementalLogitView.covers("params/lm_head/table")
    assert not IncrementalLogitView.covers("params/blocks/attn/wq")


def test_hot_swap_through_the_engine_matches_jax(rng):
    """Queued rank-1 hot-swaps through both ServeEngines: a burst of 8
    under flush_size 16 stays pending until flush_views."""
    m, d, p = 64, 128, 512
    H = rng.normal(size=(m, d)).astype(np.float32)
    W = rng.normal(size=(p, d)).astype(np.float32)
    jm, jp, tm, tp = _pair("danube")
    jeng = JaxServeEngine(jm, jp, batch_size=1, max_seq=16)
    teng = ServeEngine(tm, tp, batch_size=1, max_seq=16)
    jeng.attach_logit_view("lm_head", JaxLogitView(H, W, flush_age=1e9))
    teng.attach_logit_view("lm_head", IncrementalLogitView(
        H, W, flush_age=1e9, device="cpu"))
    with pytest.raises(ValueError):
        teng.attach_logit_view("blocks.attn.wq", None)
    for _ in range(8):
        u = (rng.normal(size=(p, 1)) * .01).astype(np.float32)
        v = (rng.normal(size=(d, 1)) * .01).astype(np.float32)
        assert teng.hot_swap("lm_head", u, v) is False
        jeng.hot_swap("lm_head", u, v)
        W = W + u @ v.T
    assert teng._logit_views["lm_head"].pending_updates == 8
    teng.flush_views()
    jeng.flush_views()
    got = teng.view_logits("lm_head").numpy()
    assert_close(got, jeng.view_logits("lm_head"), **TOL)
    assert_close(got, H @ W.T, rtol=1e-3, atol=1e-3)
    assert teng.view_health()["lm_head"]["serving"] == "fresh"
    with pytest.raises(KeyError):
        teng.hot_swap("embed", u, v)


def test_serve_cli_runs_on_the_cpu(capsys):
    serve_cli.main(["--arch", "h2o-danube-1.8b", "--reduced", "--device",
                    "cpu", "--batch", "2", "--prompt-len", "8", "--max-new",
                    "4", "--logit-view", "--corpus", "16"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "logit view" in out
