"""The port's moe, vlm and audio families on the CPU against the JAX
package: the same weights (handed over with ``params_from_numpy``) through
both ``LM``s at reduced widths, forward (with its router loss), prefill
with its cache and decode steps, to 1e-4, the reference's serving
tolerance (``tests/test_serve.py``).  Beside them the MoE block and its
router, the prefix-LM mask of the attention kernels' plain versions, the
synthetic batches, and mirrors of the reference's own model tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.data.pipeline import synth_batch as jax_synth_batch
from repro.models import build_model as jax_build
from repro.models import moe as jax_moe
from repro.models.attention import _mask_block, blockwise_attention
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import synth_batch
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM, moe, params_from_numpy
from repro_torch.serve import ServeEngine

from conftest import assert_close

TOL = dict(rtol=1e-4, atol=1e-4)

# qwen2-moe: shared experts and qkv biases; qwen3-moe: routed experts
# only, grouped heads; paligemma: image prefix, MQA, tied head; hubert:
# audio encoder, qkv biases, GeLU MLP
CASES = {"qwen2-moe": "qwen2-moe-a2.7b", "qwen3-moe": "qwen3-moe-235b-a22b",
         "paligemma": "paligemma-3b", "hubert": "hubert-xlarge"}
DECODERS = ["qwen2-moe", "qwen3-moe", "paligemma"]


def _draw_zeros(params, rng):
    """Draw the leaves the reference initialises to zero -- qkv biases,
    frontend bias, shared-expert gate -- so that their paths count."""
    blocks = params["blocks"]
    for name in ("bq", "bk", "bv"):
        if name in blocks["attn"]:
            shape = blocks["attn"][name].shape
            blocks["attn"][name] = rng.normal(size=shape).astype(
                np.float32) * 0.1
    if "moe" in blocks and "shared_gate" in blocks["moe"]:
        shape = blocks["moe"]["shared_gate"].shape
        blocks["moe"]["shared_gate"] = rng.normal(size=shape).astype(
            np.float32) * 0.3
    if "frontend" in params:
        shape = params["frontend"]["b"].shape
        params["frontend"]["b"] = rng.normal(size=shape).astype(
            np.float32) * 0.1


def _pair(case, seed=0, **changes):
    """(jax model, jax params, port model, port params) on the same
    weights, the reduced config with ``changes``."""
    arch = CASES[case]
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    jm = jax_build(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    _draw_zeros(params, np.random.default_rng(seed))
    jp = jax.tree.map(jnp.asarray, params)
    return jm, jp, LM(tcfg, device="cpu"), params_from_numpy(params, "cpu")


def _batch(cfg, b, s, seed=1):
    """A synthetic batch (numpy) of ``s`` positions, image prefix
    included."""
    return synth_batch(cfg, ShapeConfig("t", s, b, "train"), seed=seed)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _capacious(case):
    """moe configs take capacity factor 8, as the reference's decode
    test does, so that no pair is dropped at any token count."""
    if "moe" not in case:
        return {}
    return {"moe": dataclasses.replace(
        jax_config(CASES[case]).reduced().moe, capacity_factor=8.0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_aux_match_jax(case):
    jm, jp, tm, tp = _pair(case)
    batch = _batch(tm.cfg, 2, 40)
    jl, jaux = jm.forward(jp, _jax(batch))
    tl, taux = tm.forward(tp, batch)
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert_close(tl.numpy(), jl, **TOL)
    assert_close(taux.numpy(), jaux, rtol=1e-5, atol=1e-7)
    if "moe" in case:
        assert float(taux) > 0


@pytest.mark.parametrize("case", DECODERS)
def test_prefill_and_decode_match_jax(case):
    jm, jp, tm, tp = _pair(case, seed=2)
    batch = _batch(tm.cfg, 2, 28, seed=3)
    s0 = batch["tokens"].shape[1] + (tm.cfg.n_patches
                                     if case == "paligemma" else 0)
    max_seq = s0 + 10
    jl, jcache = jm.prefill(jp, _jax(batch), max_seq)
    tl, tcache = tm.prefill(tp, batch, max_seq)
    assert_close(tl.numpy(), jl, **TOL)
    for name in ("k", "v"):
        assert_close(tcache["kv"][name].numpy(), jcache["kv"][name], **TOL)

    steps = np.random.default_rng(4).integers(
        0, tm.cfg.vocab, (2, 9)).astype(np.int32)
    jax_decode = jax.jit(jm.decode_step)
    for i in range(steps.shape[1]):
        tok = steps[:, i:i + 1]
        jl, jcache = jax_decode(jp, jcache, jnp.asarray(tok),
                                jnp.asarray(s0 + i, jnp.int32))
        tl, tcache = tm.decode_step(tp, tcache, tok, s0 + i)
        assert_close(tl.numpy(), jl, **TOL, msg=f"step {i}")
    for name in ("k", "v"):
        assert_close(tcache["kv"][name].numpy(), jcache["kv"][name], **TOL)


def test_moe_block_drops_pairs_as_jax(rng):
    """Past the dense-safe capacity (T·k > 4096) at capacity factor 0.5,
    many pairs are dropped: the port drops the same ones."""
    cfg = jax_config("qwen2-moe-a2.7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    params = jax.tree.map(np.asarray, jax_moe.init_moe(
        cfg, jnp.float32, jax.random.PRNGKey(5)))
    params["shared_gate"] = rng.normal(size=(cfg.d_model, 1)).astype(
        np.float32) * 0.3
    x = rng.normal(size=(2, 1100, cfg.d_model)).astype(np.float32)
    assert moe._capacity(2200, cfg) < 2200 * cfg.moe.top_k / cfg.moe.n_experts
    jout, jaux = jax_moe.moe_block(jax.tree.map(jnp.asarray, params), cfg,
                                   jnp.asarray(x), return_aux=True)
    tout, taux = moe.moe_block(params_from_numpy(params, "cpu"), cfg,
                               torch.from_numpy(x), return_aux=True)
    assert_close(tout.numpy(), jout, **TOL)
    assert_close(taux.numpy(), jaux, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_router_matches_jax(arch, rng):
    """The port's top-k choices are JAX's; where a choice differs, the
    k-th and (k+1)-th probabilities are a tie within 1e-6."""
    cfg = jax_config(arch).reduced()
    x = rng.normal(size=(512, cfg.d_model)).astype(np.float32)
    router = rng.normal(size=(cfg.d_model, cfg.moe.n_experts)).astype(
        np.float32) * cfg.d_model ** -0.5
    jp, je, jprobs = (np.asarray(a) for a in jax_moe._route(
        jnp.asarray(x), jnp.asarray(router), cfg))
    tp, te, tprobs = moe._route(torch.from_numpy(x), torch.from_numpy(router),
                                cfg)
    assert_close(tprobs.numpy(), jprobs, rtol=1e-5, atol=1e-7)
    k = cfg.moe.top_k
    differ = (te.numpy() != je).any(axis=1)
    ordered = np.sort(jprobs, axis=1)[:, ::-1]
    assert (ordered[differ, k - 1] - ordered[differ, k] <= 1e-6).all()
    assert_close(tp.numpy()[~differ], jp[~differ], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("prefix", [0, 1, 9, 24])
def test_prefix_mask_matches_blockwise(prefix, window, rng):
    """ref.attention_keep is _mask_block; ref.flash_attention(prefix_len=)
    is blockwise_attention(prefix_len=), grouped heads, ragged chunks."""
    pos = np.arange(24)
    want = np.asarray(_mask_block(jnp.asarray(pos), jnp.asarray(pos),
                                  causal=True, window=window,
                                  prefix_len=prefix))
    got = ref.attention_keep(torch.from_numpy(pos), torch.from_numpy(pos),
                             causal=True, window=window, prefix_len=prefix)
    np.testing.assert_array_equal(got.numpy(), want)
    q = rng.normal(size=(2, 24, 8, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 24, 2, 32)).astype(np.float32)
            for _ in range(2))
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                              window=window, prefix_len=prefix)
    assert_close(out.numpy(), blockwise_attention(
        q, k, v, causal=True, window=window, prefix_len=prefix, q_chunk=8,
        kv_chunk=6), **TOL)
    # the prefix is ignored without the causal mask, as in _mask_block
    torch.testing.assert_close(
        ref.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                            window=window, prefix_len=prefix),
        ref.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                            window=window))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "paligemma-3b",
                                  "hubert-xlarge"])
@pytest.mark.parametrize("seq", [48, 300])
def test_synth_batch_is_the_references(arch, seq):
    for step, host, hosts in ((0, 0, 1), (3, 1, 2)):
        want = jax_synth_batch(jax_config(arch), JaxShape("t", seq, 4,
                                                          "train"),
                               seed=7, step=step, host=host,
                               num_hosts=hosts)
        got = synth_batch(get_config(arch), ShapeConfig("t", seq, 4,
                                                        "train"),
                          seed=7, step=step, host=host, num_hosts=hosts)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])


def test_mixed_dtype_moe_tree_hands_over_unchanged():
    """A bf16 moe tree keeps its f32 router and shared-expert gate, and
    a vlm's frontend its bf16 leaves, leaf by leaf and bit for bit."""
    for arch in ("qwen2-moe-a2.7b", "paligemma-3b"):
        cfg = dataclasses.replace(jax_config(arch).reduced(),
                                  dtype="bfloat16")
        params = jax.tree.map(np.asarray,
                              jax_build(cfg).init(jax.random.PRNGKey(6)))
        got = params_from_numpy(params, "cpu")
        leaves = jax.tree_util.tree_leaves_with_path(params)
        assert leaves
        for path, want in leaves:
            t = got
            for key in path:
                t = t[key.key]
            assert str(t.dtype) == f"torch.{want.dtype.name}", path
            np.testing.assert_array_equal(t.float().numpy(),
                                          want.astype(np.float32))
    assert got["frontend"]["w"].dtype == torch.bfloat16


def test_moe_decode_matches_forward():
    """tests/test_models_smoke.py::test_decode_matches_forward for the
    moe family, at capacity factor 8, in the port alone."""
    _, _, tm, tp = _pair("qwen3-moe", seed=3, **_capacious("qwen3-moe"))
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab, (2, 16))
    full, _ = tm.forward(tp, {"tokens": toks})
    cache = tm.init_cache(2, 32)
    for t in range(16):
        logits, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
        assert_close(logits[:, 0].numpy(), full[:, t].numpy(), rtol=0,
                     atol=5e-4)


def test_moe_router_aux_is_positive():
    _, _, tm, tp = _pair("qwen3-moe", seed=10)
    _, aux = tm.forward(tp, _batch(tm.cfg, 2, 64))
    assert float(aux) > 0.0


def test_prefix_lm_attends_the_whole_prefix():
    """tests/test_models_smoke.py::test_prefix_lm_bidirectional_attention:
    a patch at the end of the prefix moves the logits at position 0, and
    a text token moves no logit before it."""
    _, _, tm, tp = _pair("paligemma", seed=7)
    batch = _batch(tm.cfg, 1, 40)
    l1, _ = tm.forward(tp, batch)
    moved = dict(batch, patches=batch["patches"].copy())
    moved["patches"][:, -1] += 3.0
    l2, _ = tm.forward(tp, moved)
    assert float((l1[:, 0] - l2[:, 0]).abs().max()) > 1e-6
    later = dict(batch, tokens=batch["tokens"].copy())
    later["tokens"][:, 5] = (later["tokens"][:, 5] + 7) % tm.cfg.vocab
    l3, _ = tm.forward(tp, later)
    first = tm.cfg.n_patches + 5
    torch.testing.assert_close(l1[:, :first], l3[:, :first], rtol=0, atol=0)
    assert float((l1[:, first] - l3[:, first]).abs().max()) > 1e-6


def test_vlm_prefill_then_decode_matches_a_longer_forward():
    """tests/test_serve.py::test_vlm_prefill_then_decode_consistency in the
    port: prefill logits are forward's, and each decode step's logits are
    those of a forward over the tokens fed so far."""
    _, _, tm, tp = _pair("paligemma", seed=11)
    extra = 4
    batch = _batch(tm.cfg, 1, tm.cfg.n_patches + 16 + extra, seed=12)
    toks = batch["tokens"]
    short = dict(batch, tokens=toks[:, :-extra])
    s0 = tm.cfg.n_patches + short["tokens"].shape[1]
    logits, cache = tm.prefill(tp, short, max_seq=s0 + extra)
    full, _ = tm.forward(tp, short)
    assert_close(logits.numpy(), full.numpy(), rtol=2e-4, atol=2e-4)
    full_ext, _ = tm.forward(tp, batch)
    for i in range(extra):
        step, cache = tm.decode_step(tp, cache,
                                     toks[:, -extra + i:][:, :1], s0 + i)
        assert_close(step[:, 0].numpy(), full_ext[:, s0 + i].numpy(),
                     rtol=0, atol=5e-4)


def test_audio_is_an_encoder():
    _, _, tm, tp = _pair("hubert", seed=13)
    with pytest.raises(ValueError, match="encoder"):
        tm.init_cache(1, 8)
    with pytest.raises(ValueError, match="encoder"):
        tm.prefill(tp, _batch(tm.cfg, 1, 8), max_seq=8)
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(tm, tp, batch_size=1, max_seq=8)


def test_moe_greedy_generation_matches_jax():
    jm, jp, tm, tp = _pair("qwen2-moe", seed=14)
    prompts = np.random.default_rng(15).integers(
        0, tm.cfg.vocab, (2, 10)).astype(np.int32)
    want = JaxServeEngine(jm, jp, batch_size=2, max_seq=24).generate(
        prompts, max_new=8)
    got = ServeEngine(tm, tp, batch_size=2, max_seq=24).generate(
        prompts, max_new=8)
    np.testing.assert_array_equal(got, want)


def test_serve_cli_runs_moe_on_the_cpu(capsys):
    serve_cli.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device",
                    "cpu", "--batch", "2", "--prompt-len", "8",
                    "--max-new", "4"])
    out = capsys.readouterr().out
    assert "qwen2-moe-a2.7b-reduced on cpu: generated (2, 4)" in out
