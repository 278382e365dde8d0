"""The port's plain flash attention and flash decoding (what the CUDA
kernels are held against on the card, and what CPU tensors take) against
the JAX package: its Pallas kernels in interpret mode, its oracles, and
the model's ``blockwise_attention`` and decode attention.  Tolerance
2e-3, the reference's own for these kernels (``tests/test_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import _mask_block, blockwise_attention
from repro_torch.kernels import flash_attention as cuda_fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_decode import MAX_SPLITS, TILE, split_plan

from conftest import assert_close
from flash_bounds import flash_attention_bwd_bf16_bound

TOL = dict(rtol=2e-3, atol=2e-3)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# (h, h_kv, d, s, extra): tests/test_kernels.py's decode shapes, plus
# danube's heads (head_dim 80, group 4) and a group of 9
@pytest.mark.parametrize("h,hkv,d,s,extra", [
    (8, 2, 64, 512, 0), (4, 4, 32, 256, 100), (16, 1, 64, 1024, 5),
    (8, 8, 128, 256, 0), (32, 8, 80, 256, 31), (36, 4, 128, 128, 127)])
def test_flash_decode_matches_pallas(h, hkv, d, s, extra, rng):
    q, k, v = _normal(rng, h, d), _normal(rng, s, hkv, d), \
        _normal(rng, s, hkv, d)
    n_valid = s - extra
    got = ops.flash_decode(torch.from_numpy(q)[None],
                           torch.from_numpy(k)[None],
                           torch.from_numpy(v)[None], n_valid)[0].numpy()
    ln = jnp.asarray(n_valid, jnp.int32)
    assert_close(got, jax_ops.flash_decode(q, k, v, ln), **TOL)
    assert_close(got, jax_ref.flash_decode(q, k, v, ln), **TOL)


# the same six shapes, n_valid given as a 0-d int32 tensor (the form the
# decode step passes, read on the device) and as a (1,) one
@pytest.mark.parametrize("h,hkv,d,s,extra", [
    (8, 2, 64, 512, 0), (4, 4, 32, 256, 100), (16, 1, 64, 1024, 5),
    (8, 8, 128, 256, 0), (32, 8, 80, 256, 31), (36, 4, 128, 128, 127)])
def test_flash_decode_takes_n_valid_as_a_tensor(h, hkv, d, s, extra, rng):
    q, k, v = _normal(rng, h, d), _normal(rng, s, hkv, d), \
        _normal(rng, s, hkv, d)
    n_valid = s - extra
    tq, tk, tv = (torch.from_numpy(x)[None] for x in (q, k, v))
    by_int = ops.flash_decode(tq, tk, tv, n_valid)
    for n in (torch.tensor(n_valid, dtype=torch.int32),
              torch.tensor([n_valid], dtype=torch.int32)):
        torch.testing.assert_close(ops.flash_decode(tq, tk, tv, n), by_int,
                                   rtol=0, atol=0)
    ln = jnp.asarray(n_valid, jnp.int32)
    assert_close(by_int[0].numpy(), jax_ops.flash_decode(
        q, k, v, ln, interpret=True), **TOL)


def test_flash_decode_matches_the_models_decode_einsum(rng):
    """A batch of sequences against the reference's decode attention
    arithmetic (grouped einsum, NEG_INF mask past n_valid)."""
    b, L, h, kvh, d, n_valid = 3, 40, 8, 2, 80, 29
    q = _normal(rng, b, h, d)
    k, v = _normal(rng, b, L, kvh, d), _normal(rng, b, L, kvh, d)
    qf = jnp.asarray(q).reshape(b, kvh, h // kvh, d)
    logits = jnp.einsum("bkgd,bskd->bkgs", qf, k) * d ** -0.5
    logits = jnp.where(jnp.arange(L) < n_valid, logits, -1e30)
    p = jnp.exp(logits - logits.max(-1, keepdims=True))
    want = jnp.einsum("bkgs,bskd->bkgd", p / p.sum(-1, keepdims=True), v)
    got = ref.flash_decode(*map(torch.from_numpy, (q, k, v)), n_valid)
    assert_close(got.numpy(), want.reshape(b, h, d), **TOL)


def _pallas_case(s, hd, causal, bq, bk, h=1, kvh=1):
    return pytest.param(s, hd, causal, bq, bk, h, kvh,
                        id="-".join(map(str, (s, hd, causal, bq, bk)))
                        + (f"-h{h}-kv{kvh}" if h > 1 else ""))


# single heads; then head dim 80 under a group of 16 query heads on one KV
# head at an S that is no multiple of the card kernel's 128-row tiles
@pytest.mark.parametrize("s,hd,causal,bq,bk,h,kvh", [
    _pallas_case(256, 64, True, 128, 128),
    _pallas_case(512, 32, True, 256, 128),
    _pallas_case(256, 64, False, 64, 256),
    _pallas_case(384, 128, True, 128, 128),
    _pallas_case(256, 80, True, 128, 128),
    _pallas_case(136, 80, True, 68, 68, h=16, kvh=1)])
def test_flash_attention_matches_pallas(s, hd, causal, bq, bk, h, kvh, rng):
    q = _normal(rng, 1, s, h, hd)
    k, v = _normal(rng, 1, s, kvh, hd), _normal(rng, 1, s, kvh, hd)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal).numpy()
    # the Pallas kernel takes one (batch, head) at a time: each query head
    # against its group's KV head
    for head in range(h):
        qh, kh, vh = q[0, :, head], k[0, :, head // (h // kvh)], \
            v[0, :, head // (h // kvh)]
        assert_close(got[0, :, head], flash_attention_pallas(
            qh, kh, vh, bq=bq, bk=bk, causal=causal, interpret=True), **TOL)
        assert_close(got[0, :, head],
                     jax_ref.flash_attention(qh, kh, vh, causal=causal),
                     **TOL)


def test_flash_attention_routes_by_head_dim():
    """bf16 at head dims 64, 80 and 128 takes the forward's wgmma kernel,
    at 80 and 128 K1's wgmma kernels (its dQ and dK / dV kernels' route),
    the other bf16 head dims the mma.sync ones, f32 the split-TF32 ones."""
    for hd in cuda_fa.HEAD_DIMS:
        assert cuda_fa.kernel_of(torch.bfloat16, hd) == (
            "flash_attention_bf16_wgmma" if hd in (64, 80, 128)
            else "flash_attention_bf16_mma")
        assert cuda_fa.kernel_of(torch.float32, hd) == \
            "flash_attention_3xtf32"
        assert cuda_fa.bwd_kernel_of(torch.bfloat16, hd) == (
            "flash_bwd_wgmma" if hd in (80, 128) else "flash_bwd_mma")
        assert cuda_fa.bwd_kernel_of(torch.float32, hd) == "flash_bwd_3xtf32"


def _constexpr(body: str, name: str, hd: int) -> int:
    """The value at head dim ``hd`` of ``static constexpr int <name> =
    <expr>;`` in a C++ struct body, where expr is a number or ``HD <= n ?
    a : b`` (nested)."""
    import re
    expr = re.search(rf"static constexpr int {name} = ([^;]+);",
                     body).group(1).strip()
    while True:
        num = re.fullmatch(r"\d+", expr)
        if num:
            return int(expr)
        cond = re.fullmatch(r"HD (<=|<|==) (\d+) \? (\d+) : (.+)", expr)
        assert cond, f"{name} = {expr}: not a form this reader takes"
        op, n, a, rest = cond.groups()
        if {"<=": hd <= int(n), "<": hd < int(n), "==": hd == int(n)}[op]:
            return int(a)
        expr = rest.strip()


def test_bwd_tiles_mirror_the_kernels():
    """BWD_TILES[bfloat16] (the split plan's tiles) at head dims 80 and 128
    are the wgmma dK / dV kernel's (BK, BQ) in csrc's wg::DkvGeo, and at
    32, 64, 96 and 256 the mma.sync one's in tc::DkvPlan (BK = 16
    STRIPS)."""
    import re
    from pathlib import Path
    src = (Path(cuda_fa.__file__).parent / "csrc"
           / "flash_attention_bwd.cu").read_text()

    def body(struct: str, namespace: str) -> str:
        part = src.split(f"namespace {namespace} {{", 1)[1]
        return re.search(rf"struct {struct} {{(.*?)\n}};", part,
                         re.S).group(1)

    wg, tc = body("DkvGeo", "wg"), body("DkvPlan", "tc")
    for hd in cuda_fa.HEAD_DIMS:
        if hd in cuda_fa.BWD_WGMMA_HEAD_DIMS:
            want = (_constexpr(wg, "BK", hd), _constexpr(wg, "BQ", hd))
        else:
            want = (16 * _constexpr(tc, "STRIPS", hd),
                    _constexpr(tc, "BQ", hd))
        assert cuda_fa.BWD_TILES[torch.bfloat16][hd] == want, hd


# (b, s, h, kvh, hd, causal, window): the reference test's multi-head case,
# then grouped heads, head_dim 80, sliding windows and ragged lengths --
# held against blockwise_attention only (the Pallas kernel has no window)
@pytest.mark.parametrize("b,s,h,kvh,hd,causal,window", [
    (2, 256, 4, 4, 64, True, None), (2, 96, 8, 2, 80, True, None),
    (1, 100, 32, 8, 80, True, 16), (2, 64, 9, 1, 32, False, None),
    (1, 77, 4, 2, 32, True, 77), (1, 50, 4, 1, 32, False, 8)])
def test_flash_attention_matches_blockwise(b, s, h, kvh, hd, causal, window,
                                           rng):
    q = _normal(rng, b, s, h, hd)
    k, v = _normal(rng, b, s, kvh, hd), _normal(rng, b, s, kvh, hd)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window)
    want = blockwise_attention(q, k, v, causal=causal, window=window,
                               q_chunk=32, kv_chunk=16)
    assert_close(got.numpy(), want, **TOL)
    if kvh == h and window is None:
        assert_close(got.numpy(), jax_ops.flash_attention(
            q, k, v, causal=causal, bq=64, bk=64), **TOL)


def test_flash_attention_query_chunks_agree(rng):
    q, k, v = (torch.from_numpy(_normal(rng, 1, 70, 4, 32)) for _ in range(3))
    whole = ref.flash_attention(q, k, v, window=20)
    for q_chunk in (1, 16, 33):
        torch.testing.assert_close(
            ref.flash_attention(q, k, v, window=20, q_chunk=q_chunk), whole)


def test_flash_attention_keeps_bf16(rng):
    q, k, v = (torch.from_numpy(_normal(rng, 1, 40, 4, 32)).bfloat16()
               for _ in range(3))
    out = ops.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.flash_attention(
        q.float(), k.float(), v.float()), rtol=1e-2, atol=1e-2)


def _bf16_attention_pair(rng, b, s, h, kvh, causal, window):
    """The reference's blockwise attention and the plain version on the
    same bf16 inputs at danube's head_dim 80, as f32 arrays, and
    sum_k p_k |v_k| / l from the f32 softmax."""
    q = _normal(rng, b, s, h, 80)
    k, v = _normal(rng, b, s, kvh, 80), _normal(rng, b, s, kvh, 80)
    want = blockwise_attention(*(jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)),
                               causal=causal, window=window, q_chunk=64,
                               kv_chunk=64)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = ref.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    pv_abs = ref.flash_attention(tq.float(), tk.float(), tv.float().abs(),
                                 causal=causal, window=window)
    return (got.float().numpy(), np.asarray(want, np.float32),
            pv_abs.numpy())


# (b, s, h, kvh, causal, window): danube's GQA 4 with a window, without,
# its 32 / 8 heads, and full attention
@pytest.mark.parametrize("b,s,h,kvh,causal,window", [
    (1, 256, 8, 2, True, 100), (1, 512, 8, 2, True, None),
    (2, 128, 32, 8, True, 64), (1, 256, 8, 2, False, None)])
def test_flash_attention_bf16_p_rounding_bound(b, s, h, kvh, causal, window,
                                               rng):
    """The reference's blockwise attention in bf16 rounds p to bf16 before
    P V (attention.py:155); the plain version keeps p in f32.  They differ
    by what one rounding of p allows, 2^-8 sum_k p_k |v_k| / l, plus each
    output's own rounding, 2^-8 |x|."""
    got, want, pv_abs = _bf16_attention_pair(rng, b, s, h, kvh, causal,
                                             window)
    bound = 1.01 * 2.0 ** -8 * (pv_abs + np.abs(got) + np.abs(want)) + 1e-5
    assert (np.abs(got - want) <= bound).all()


def test_card_bf16_tolerance_does_not_admit_a_bf16_p(rng):
    """Where a few keys carry a row, one bf16 rounding of p moves outputs
    past the bf16 tolerance the card tests hold the CUDA kernel to (rtol
    1e-2, atol 1e-3) -- which is why the kernel carries p as two bf16
    terms, and why the plain version keeps p in f32."""
    got, want, _ = _bf16_attention_pair(rng, 1, 256, 8, 2, True, 100)
    assert not np.allclose(got, want, rtol=1e-2, atol=1e-3)


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: 0x1000 added
    to the f32 bits, then the low 13 cleared (to nearest, ties away)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
            ).view(np.float32)


def _tf32_read(x):
    """x as the tensor cores read an f32 pattern given as a TF32 operand:
    its top 19 bits, the low 13 cleared (truncation)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, products):
    """a @ b with TF32 operands, as the f32 prefill kernel forms it on the
    tensor cores: one product of the rounded operands, or three of the
    split ones, x = big + small with big = tf32(x) and small = x - big
    (exact in f32) passed unrounded, so the mma reads it truncated:
    small.big + big.small + big.big (small.small dropped).  Each product
    of two TF32 values is exact in f32, as in the accumulator."""
    if products == 1:
        return _tf32(a) @ _tf32(b)
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32_read(a - a_big), _tf32_read(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _tf32_attention(q, k, v, causal, window, prefix, products):
    """Plain softmax attention of numpy q (B,S,H,hd) over k, v (B,S,KV,hd)
    whose Q K^T and P V are ``_tf32_matmul`` products: p = exp(s - max)
    goes into P V unnormalized, as the kernel's does, and l sums the f32
    p."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    kt = np.repeat(k, g, axis=2).transpose(0, 2, 3, 1)
    vt = np.repeat(v, g, axis=2).transpose(0, 2, 1, 3)
    scores = _tf32_matmul(q.transpose(0, 2, 1, 3), kt, products) \
        * np.float32(hd ** -0.5)
    pos = torch.arange(s)
    keep = ref.attention_keep(pos, pos, causal=causal, window=window,
                              prefix_len=prefix).numpy()
    scores = np.where(keep, scores, np.float32(-np.inf))
    p = np.exp(scores - scores.max(-1, keepdims=True)).astype(np.float32)
    l = p.sum(-1, keepdims=True)
    out = _tf32_matmul(p, vt, products) / np.maximum(l, np.float32(1e-30))
    return out.transpose(0, 2, 1, 3)


# (b, s, h, kvh, hd, causal, window, prefix): causal, prefix-LM with GQA,
# a window with GQA, full attention, at head dims 64, 80 and 256
_SPLIT_CASES = [
    (1, 96, 4, 4, 64, True, None, 0), (1, 80, 4, 2, 80, True, None, 32),
    (2, 64, 4, 1, 64, True, 16, 0), (1, 72, 2, 2, 80, False, None, 0),
    (1, 48, 2, 1, 256, True, None, 16), (1, 40, 2, 2, 256, False, 8, 0)]


@pytest.mark.parametrize("b,s,h,kvh,hd,causal,window,prefix", _SPLIT_CASES)
def test_flash_attention_split_tf32_matches_jax(b, s, h, kvh, hd, causal,
                                                window, prefix, rng):
    """The f32 prefill kernel's arithmetic, three split TF32 products for
    Q K^T and for P V, holds the reference's blockwise attention within
    the card's f32 tolerance (rtol = atol = 2e-4)."""
    q = _normal(rng, b, s, h, hd)
    k, v = _normal(rng, b, s, kvh, hd), _normal(rng, b, s, kvh, hd)
    want = blockwise_attention(q, k, v, causal=causal, window=window,
                               prefix_len=prefix, q_chunk=32, kv_chunk=16)
    assert_close(_tf32_attention(q, k, v, causal, window, prefix, 3), want,
                 rtol=2e-4, atol=2e-4)


def test_card_f32_tolerance_does_not_admit_one_tf32_product(rng):
    """One TF32 product (each operand rounded once to 10 mantissa bits)
    moves outputs past the f32 tolerance the card tests hold the kernel to
    -- which is why the kernel takes three products of split operands."""
    q = _normal(rng, 1, 256, 4, 128)
    k, v = _normal(rng, 1, 256, 4, 128), _normal(rng, 1, 256, 4, 128)
    want = np.asarray(blockwise_attention(q, k, v, q_chunk=64, kv_chunk=64))
    one = _tf32_attention(q, k, v, True, None, 0, 1)
    assert not np.allclose(one, want, rtol=2e-4, atol=2e-4)
    # the same inputs, three products: inside it
    assert_close(_tf32_attention(q, k, v, True, None, 0, 3), want,
                 rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,groups,L,sms", [
    (8, 8, 4096, 132), (8, 8, 1, 132), (8, 8, 2049, 132), (1, 1, 100, 132),
    (1, 4, 4096, 132), (64, 8, 65, 132), (2, 2, 5000, 16)])
def test_decode_split_plan_covers_the_valid_slots(b, groups, L, sms):
    """The plan depends on the cache's length only, not on n_valid: its
    splits cover all L slots (the kernel shares the valid slots' tiles
    among the same splits on the device)."""
    for per_sm in (1, 2):
        chunk, nsplit = split_plan(b, groups, L, sms, per_sm)
        assert chunk % TILE == 0
        # every split holds a slot of the cache, together all of them
        assert (nsplit - 1) * chunk < L <= nsplit * chunk
        # and no more blocks than fill the SMs per_sm times (one wave)
        assert nsplit <= min(MAX_SPLITS,
                             max(1, per_sm * sms // (b * groups)))


# -- the backward (K1) and the forward's row log-sum-exp ----------------------

# (b, s, h, kvh, hd, causal, window, prefix): causal, windowed, the prefix
# (alone and under a window), full attention with and without a window;
# groups 1, 2 and 4; head dims 32 and 64
_BWD = [(2, 40, 4, 4, 32, True, None, 0), (1, 50, 4, 2, 64, True, 16, 0),
        (2, 45, 8, 2, 32, True, None, 12), (1, 60, 4, 1, 64, True, 20, 30),
        (1, 33, 4, 1, 32, False, None, 0), (2, 37, 4, 2, 64, False, 9, 0)]
BWD_TOL = dict(rtol=2e-4, atol=2e-4)


def _bwd_inputs(rng, b, s, h, kvh, hd):
    return (_normal(rng, b, s, h, hd), _normal(rng, b, s, kvh, hd),
            _normal(rng, b, s, kvh, hd), _normal(rng, b, s, h, hd))


@pytest.mark.parametrize("b,s,h,kvh,hd,causal,window,prefix", _BWD)
def test_flash_attention_bwd_and_lse_match_autograd_and_jax(
        b, s, h, kvh, hd, causal, window, prefix, rng):
    """ref.flash_attention_bwd (the formula K1 computes) against
    torch.autograd through ref.flash_attention and jax.grad of the
    reference's blockwise_attention; ref.flash_attention_lse's out against
    ref.flash_attention and its lse against jax.nn.logsumexp of the
    masked scaled scores."""
    q, k, v, dout = _bwd_inputs(rng, b, s, h, kvh, hd)
    opts = dict(causal=causal, window=window, prefix_len=prefix)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = ref.flash_attention_lse(tq, tk, tv, **opts)
    torch.testing.assert_close(out, ref.flash_attention(tq, tk, tv, **opts))
    got = ref.flash_attention_bwd(tq, tk, tv, out, tdo, lse, **opts)

    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    (ref.flash_attention(*leaves, **opts) * tdo).sum().backward()

    def loss(q, k, v):
        return (blockwise_attention(q, k, v, q_chunk=16, kv_chunk=16,
                                    **opts) * dout).sum()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    for g, a, w in zip(got, leaves, want):
        assert g.shape == a.shape and g.dtype == torch.float32
        assert_close(g.numpy(), a.grad.numpy(), **BWD_TOL)
        assert_close(g.numpy(), w, **BWD_TOL)

    pos = jnp.arange(s)
    keep = _mask_block(pos, pos, causal=causal, window=window,
                       prefix_len=prefix)
    scores = jnp.einsum("bqkgd,bskd->bkgqs",
                        jnp.asarray(q).reshape(b, s, kvh, h // kvh, hd),
                        jnp.asarray(k)) * hd ** -0.5
    jlse = jax.nn.logsumexp(jnp.where(keep, scores, -jnp.inf), axis=-1)
    assert_close(lse.numpy(), np.asarray(jlse).reshape(b, h, s), **BWD_TOL)


@pytest.mark.parametrize("causal,window,prefix", [
    (True, None, 0), (True, 3, 0), (True, 2, 4), (False, 2, 0)])
def test_flash_attention_function_gradchecks_over_the_plain_versions(
        causal, window, prefix, rng):
    """The FlashAttention autograd Function the card runs, here over the
    plain versions in float64: torch.autograd.gradcheck against finite
    differences, grouped heads (a group of 2)."""
    q, k, v, _ = (torch.from_numpy(x).double().requires_grad_(True)
                  for x in _bwd_inputs(rng, 1, 6, 2, 1, 4))

    def fn(q, k, v):
        return cuda_fa.FlashAttention.apply(
            q, k, v, causal, window, prefix, ref.flash_attention_lse,
            ref.flash_attention_bwd)

    assert fn(q, k, v).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_flash_attention_function_refuses_a_second_derivative(rng):
    """The Function's backward is differentiable once: a gradient taken
    with create_graph=True gives the first derivative, and differentiating
    that raises instead of silently cutting the graph."""
    q, k, v, _ = (torch.from_numpy(x).double().requires_grad_(True)
                  for x in _bwd_inputs(rng, 1, 6, 2, 1, 4))
    out = cuda_fa.FlashAttention.apply(q, k, v, True, None, 0,
                                       ref.flash_attention_lse,
                                       ref.flash_attention_bwd)
    (dq,) = torch.autograd.grad(out.square().sum(), q, create_graph=True)
    (want,) = torch.autograd.grad(
        ref.flash_attention(q, k, v).square().sum(), q)
    assert_close(dq.detach().numpy(), want.numpy())
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def test_flash_attention_bf16_gradient_bound(rng):
    """The bound the card holds K1's bf16 gradients to
    (flash_attention_bwd_bf16_bound), derived from the rounding of the
    inputs and outputs: K1's formula on bf16 operands, with delta from
    the bf16 out, stays inside it against autograd's gradient, which takes
    delta from the f32 out before its rounding; without its delta term
    the bound is too tight for dq (so the term is not slack)."""
    b, s, h, kvh, hd = 1, 256, 8, 2, 64
    q, k, v, dout = (torch.from_numpy(x).bfloat16()
                     for x in _bwd_inputs(rng, b, s, h, kvh, hd))
    opts = dict(causal=True, window=100, prefix_len=0)
    out, lse = ref.flash_attention_lse(q, k, v, **opts)
    assert out.dtype == torch.bfloat16
    got = ref.flash_attention_bwd(q, k, v, out, dout, lse, **opts)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (ref.flash_attention(*leaves, **opts).float() * dout.float()).sum(
        ).backward()
    want = [x.grad for x in leaves]
    bounds = flash_attention_bwd_bf16_bound(q, k, v, out, dout, lse,
                                            got, want, **opts)
    for g, w, bound in zip(got, want, bounds):
        assert g.dtype == w.dtype == torch.bfloat16
        assert ((g.float() - w.float()).abs() <= bound).all()
    slack = 2.0 ** -8 * (got[0].float().abs() + want[0].float().abs())
    assert ((got[0].float() - want[0].float()).abs()
            > slack + 2e-4 + 2e-4 * want[0].float().abs()).any()


# -- K1's bf16 tensor-core arithmetic ----------------------------------------

def _bf16_terms(x: torch.Tensor, n: int) -> list:
    """f32 x as n bf16 terms, each the remainder so far rounded to bf16
    (hi = bf16(x), lo = bf16(x - hi), ...), as f32 tensors."""
    terms, rest = [], x
    for _ in range(n):
        terms.append(rest.bfloat16().float())
        rest = rest - terms[-1]
    return terms


def _k1_bf16(q, k, v, out, dout, lse, causal, window, prefix,
             p_terms=2, ds_terms=2):
    """K1's bf16 kernel's arithmetic in plain PyTorch: S = Q K^T and dP =
    dO V^T from the bf16 operands (products exact, f32 sums), P = exp(S
    scale - lse) on kept pairs (0 elsewhere), delta from the bf16 out, dS
    / scale = P (dP - delta); then P and dS / scale as ``p_terms`` /
    ``ds_terms`` bf16 terms into dV = P^T dO, dK = scale (dS / scale)^T Q
    (summed over the group) and dQ = scale (dS / scale) K, each term's
    product summed in f32, each gradient rounded to bf16 once."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh

    def grouped(x):   # (B, KV, g, S, hd)
        return x.float().reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)

    qf, of, dof = grouped(q), grouped(out), grouped(dout)
    kf, vf = (x.float().permute(0, 2, 1, 3)[:, :, None] for x in (k, v))
    scale = hd ** -0.5
    pos = torch.arange(s)
    keep = ref.attention_keep(pos, pos, causal=causal, window=window,
                              prefix_len=prefix)
    lse = lse.reshape(b, kvh, g, s, 1)
    p = torch.where(keep, torch.exp(qf @ kf.transpose(-1, -2) * scale - lse),
                    0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dv = sum(torch.einsum("bkgqs,bkgqd->bksd", t, dof)
             for t in _bf16_terms(p, p_terms))
    ds_split = _bf16_terms(ds, ds_terms)
    dk = scale * sum(torch.einsum("bkgqs,bkgqd->bksd", t, qf)
                     for t in ds_split)
    dq = scale * sum(t @ kf for t in ds_split)
    return (dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).bfloat16(),
            dk.permute(0, 2, 1, 3).bfloat16(),
            dv.permute(0, 2, 1, 3).bfloat16())


def _k1_bf16_inputs(rng, b, s, h, kvh, hd, cancel=False):
    """bf16 q, k, v, dout.  ``cancel``: v alternates in sign around one
    vector a KV head (plus 1 % noise) and dout is 100x larger, so that the
    attention output nearly cancels -- the bound's delta term, which grows
    with |out|, then leaves little room -- while dP - delta does not."""
    q, k, v, dout = _bwd_inputs(rng, b, s, h, kvh, hd)
    if cancel:
        sign = np.where(np.arange(s) % 2 == 0, 1.0, -1.0).astype(np.float32)
        v = sign[None, :, None, None] * _normal(rng, b, 1, kvh, hd) \
            + 0.01 * v
        dout = 100.0 * dout
    return tuple(torch.from_numpy(x).bfloat16() for x in (q, k, v, dout))


def _k1_bf16_against_jax(tensors, causal, window, prefix, p_terms=2,
                         ds_terms=2):
    """The emulation's gradients on the bf16 tensors, jax.grad of the
    reference's blockwise_attention in f32 on the same values (rounded to
    bf16 once), and flash_attention_bwd_bf16_bound's bounds."""
    q, k, v, dout = tensors
    opts = dict(causal=causal, window=window, prefix_len=prefix)
    out, lse = ref.flash_attention_lse(q, k, v, **opts)
    got = _k1_bf16(q, k, v, out, dout, lse, causal, window, prefix,
                   p_terms, ds_terms)
    weights = jnp.asarray(dout.float().numpy())

    def loss(q, k, v):
        return (blockwise_attention(q, k, v, q_chunk=16, kv_chunk=16,
                                    **opts) * weights).sum()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)))
    want = [torch.from_numpy(np.array(w)).bfloat16() for w in want]
    return got, want, flash_attention_bwd_bf16_bound(
        q, k, v, out, dout, lse, got, want, **opts)


# (b, s, h, kvh, hd, causal, window, prefix, cancel): causal, a window,
# the prefix, full attention with and without a window; groups 1, 4 and 8;
# and the inputs whose output cancels (where one bf16 dS fails)
_K1_BF16 = [(1, 64, 4, 4, 32, True, None, 0, False),
            (1, 80, 8, 2, 32, True, 24, 0, False),
            (2, 48, 8, 1, 64, True, None, 16, False),
            (1, 56, 4, 1, 32, False, None, 0, False),
            (1, 60, 8, 1, 32, False, 12, 0, False),
            (1, 128, 4, 1, 64, False, None, 0, True),
            (1, 128, 8, 2, 32, True, None, 0, True)]


@pytest.mark.parametrize("b,s,h,kvh,hd,causal,window,prefix,cancel",
                         _K1_BF16)
def test_k1_bf16_split_arithmetic_holds_the_bound_against_jax(
        b, s, h, kvh, hd, causal, window, prefix, cancel, rng):
    """K1's bf16 tensor-core arithmetic, P and dS as two bf16 terms each,
    against jax.grad through the reference's blockwise attention on the
    same bf16 values: inside flash_attention_bwd_bf16_bound, the bound
    the card holds the kernel to."""
    tensors = _k1_bf16_inputs(rng, b, s, h, kvh, hd, cancel)
    got, want, bounds = _k1_bf16_against_jax(tensors, causal, window,
                                             prefix)
    for g, w, bound in zip(got, want, bounds):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert ((g.float() - w.float()).abs() <= bound).all()


@pytest.mark.parametrize("term", ["p", "ds"])
def test_k1_bound_does_not_admit_a_single_bf16_p_or_ds(term, rng):
    """One bf16 rounding of P moves dV past the bound (random inputs), and
    one of dS moves dQ past it (inputs whose output cancels): why the
    kernel carries both as two terms.  The same inputs with two terms stay
    inside it."""
    cancel = term == "ds"
    tensors = _k1_bf16_inputs(rng, 1, 128, 8, 2, 32, cancel)
    single = dict(p_terms=1) if term == "p" else dict(ds_terms=1)
    got, want, bounds = _k1_bf16_against_jax(tensors, True, None, 0,
                                             **single)
    index = 2 if term == "p" else 0   # dV, or dQ
    assert ((got[index].float() - want[index].float()).abs()
            > bounds[index]).any()
    got, want, bounds = _k1_bf16_against_jax(tensors, True, None, 0)
    assert ((got[index].float() - want[index].float()).abs()
            <= bounds[index]).all()


def test_k1_bound_holds_the_split_p_at_a_group_of_12(rng):
    """command-r-plus-104b's group of 12 (the shape where dv once passed
    the bound before it had K1's split-P term) with cancelling v: P and
    dS as two bf16 terms stay inside the bound, one bf16 P moves dV past
    it."""
    tensors = _k1_bf16_inputs(rng, 1, 128, 24, 2, 32, cancel=True)
    got, want, bounds = _k1_bf16_against_jax(tensors, True, None, 0)
    for g, w, bound in zip(got, want, bounds):
        assert ((g.float() - w.float()).abs() <= bound).all()
    got, want, bounds = _k1_bf16_against_jax(tensors, True, None, 0,
                                             p_terms=1)
    assert ((got[2].float() - want[2].float()).abs() > bounds[2]).any()


# -- K1's f32 split-TF32 arithmetic -------------------------------------------

def _k1_tf32(q, k, v, dout, causal, window, prefix, products):
    """K1's f32 kernels' arithmetic in numpy on q, dout (B,S,H,hd), k, v
    (B,S,KV,hd): S = Q K^T and dP = dO V^T, P = exp(S scale - lse) on kept
    pairs (lse and out from the plain forward), delta = rowsum(dO out),
    dS = P (dP - delta), then dV = P^T dO, dK = scale dS^T Q (both summed
    over the group) and dQ = scale dS K -- each of the five products a
    ``_tf32_matmul`` (``products`` 3: split operands, P and dS split as
    well; 1: one product of the rounded operands)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    opts = dict(causal=causal, window=window, prefix_len=prefix)
    out, lse = ref.flash_attention_lse(*map(torch.from_numpy, (q, k, v)),
                                       **opts)
    heads = [x.transpose(0, 2, 1, 3) for x in (q, dout, out.numpy())]
    qh, doh, oh = heads                                    # (B, H, S, hd)
    kh, vh = (np.repeat(x, g, axis=2).transpose(0, 2, 1, 3) for x in (k, v))
    scale = np.float32(hd ** -0.5)
    pos = torch.arange(s)
    keep = ref.attention_keep(pos, pos, **opts).numpy()
    sc = _tf32_matmul(qh, kh.transpose(0, 1, 3, 2), products) * scale
    p = np.where(keep, np.exp(sc - lse.numpy()[..., None]), 0.0
                 ).astype(np.float32)
    dp = _tf32_matmul(doh, vh.transpose(0, 1, 3, 2), products)
    delta = (doh * oh).sum(-1, keepdims=True, dtype=np.float32)
    ds = (p * (dp - delta)).astype(np.float32)
    dq = scale * _tf32_matmul(ds, kh, products)
    dk = scale * _tf32_matmul(ds.transpose(0, 1, 3, 2), qh, products)
    dv = _tf32_matmul(p.transpose(0, 1, 3, 2), doh, products)

    def by_kv(x):   # (B, H, S, hd) summed over each group -> (B, S, KV, hd)
        return x.reshape(b, kvh, g, s, hd).sum(2).transpose(0, 2, 1, 3)

    return dq.transpose(0, 2, 1, 3), by_kv(dk), by_kv(dv)


def _jax_grads(q, k, v, dout, causal, window, prefix):
    """jax.grad of the reference's blockwise attention, weighted by dout."""
    opts = dict(causal=causal, window=window, prefix_len=prefix)

    def loss(q, k, v):
        return (blockwise_attention(q, k, v, q_chunk=16, kv_chunk=16,
                                    **opts) * dout).sum()

    return [np.asarray(w) for w in jax.jit(jax.grad(
        loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))]


@pytest.mark.parametrize("b,s,h,kvh,hd,causal,window,prefix",
                         _BWD + [(1, 72, 8, 2, 80, True, 24, 0),
                                 (1, 48, 4, 1, 256, True, None, 16)])
def test_k1_split_tf32_arithmetic_matches_jax(b, s, h, kvh, hd, causal,
                                              window, prefix, rng):
    """K1's f32 tensor-core arithmetic, three split TF32 products for each
    of S, dP, dQ, dK and dV (P and dS split too), holds jax.grad of the
    reference's blockwise attention within the card's f32 tolerance (rtol
    = atol = 2e-4): _BWD's cases, danube's head dim 80 under a window and
    head dim 256 under the prefix."""
    q, k, v, dout = _bwd_inputs(rng, b, s, h, kvh, hd)
    got = _k1_tf32(q, k, v, dout, causal, window, prefix, 3)
    for g, w in zip(got, _jax_grads(q, k, v, dout, causal, window, prefix)):
        assert g.shape == w.shape
        assert_close(g, w, **BWD_TOL)


def test_card_f32_tolerance_does_not_admit_a_one_tf32_k1(rng):
    """One TF32 product of the rounded operands for K1's five products
    moves dq, dk or dv past the f32 tolerance the card holds the kernels
    to -- which is why they take three products of split operands; the
    same inputs with three stay inside it."""
    args = _bwd_inputs(rng, 1, 256, 4, 2, 128) + (True, None, 0)
    want = _jax_grads(*args)
    one = _k1_tf32(*args, 1)
    assert not all(np.allclose(g, w, **BWD_TOL) for g, w in zip(one, want))
    for g, w in zip(_k1_tf32(*args, 3), want):
        assert_close(g, w, **BWD_TOL)


# (bkv, s, group, hd, causal, window, prefix, sms): paligemma's prefill
# (B = 4, MQA, prefix 256, hd 256), qwen3-moe's (group 16), a ragged S, a
# window, full attention with a window on a small card, danube's
# training shape, whose grid is large enough unsplit, and an S that is no
# multiple of the bf16 wgmma kernel's 128-key tiles under a window
@pytest.mark.parametrize("bkv,s,group,hd,causal,window,prefix,sms", [
    (4, 1024, 8, 256, True, None, 256, 132),
    (16, 512, 16, 128, True, None, 0, 132),
    (16, 1000, 4, 80, True, None, 0, 132),
    (2, 700, 4, 64, True, 100, 0, 132),
    (1, 300, 2, 32, False, 50, 0, 16),
    (32, 4096, 4, 80, True, 4096, 0, 132),
    (4, 2100, 4, 128, True, 700, 0, 132)])
def test_bwd_split_plan_covers_each_walk_once(bkv, s, group, hd, causal,
                                              window, prefix, sms):
    """K1's dK / dV split plan, for the bf16 kernels' tiles and the f32
    kernels': each key tile's walk (head of the group, query tile) covers
    every query tile holding a kept pair of the tile and is cut into
    contiguous splits that cover each item exactly once, each split within
    one item of an equal share of the tile's kept pairs; entries run
    heaviest first, a tile's slots are consecutive, and the grid comes to
    about BWD_BLOCKS_PER_SM blocks an SM.  A grid with that many blocks
    unsplit is not split."""
    for dtype in (torch.bfloat16, torch.float32):
        _check_split_plan(bkv, s, group, *cuda_fa.BWD_TILES[dtype][hd],
                          causal, window, prefix, sms)


def _check_split_plan(bkv, s, group, bk, bq, causal, window, prefix, sms):
    tiles = -(-s // bk)
    made = cuda_fa.bwd_split_plan(bkv, s, group, bk, bq, causal, window,
                                  prefix, sms)
    if bkv * tiles >= cuda_fa.BWD_BLOCKS_PER_SM * sms:
        assert made is None
        return
    plan, entries, slots = made
    rows = plan[:4 * entries].reshape(entries, 4)
    firsts = plan[4 * entries:].reshape(tiles, 2)
    pos = torch.arange(s)
    keep = ref.attention_keep(pos, pos, causal=causal, window=window,
                              prefix_len=prefix).numpy()
    seen_slots, splits = [], []
    for kt in range(tiles):
        qt0, pairs = cuda_fa.bwd_walk_pairs(kt, s, bk, bq, causal, window,
                                            prefix)
        # the walk's pairs are the mask's, and it misses no kept pair
        block = keep[:, kt * bk:(kt + 1) * bk].sum(1)
        by_tile = np.add.reduceat(block, np.arange(0, s, bq))
        assert (by_tile[qt0:qt0 + len(pairs)] == pairs).all()
        assert by_tile.sum() == pairs.sum()
        mine = rows[rows[:, 0] == kt]
        mine = mine[np.argsort(mine[:, 1])]
        first, n = firsts[kt]
        assert n == len(mine) >= 1
        assert list(mine[:, 3]) == list(range(first, first + n))
        seen_slots += list(mine[:, 3])
        # contiguous splits covering items 0 .. group * nq - 1 once
        items = np.tile(pairs, group)
        assert mine[0, 1] == 0 and mine[-1, 2] == len(items)
        assert (mine[1:, 1] == mine[:-1, 2]).all()
        assert (mine[:, 2] > mine[:, 1]).all()
        share = items.sum() / n
        for _, a, e, _ in mine:
            assert items[a:e].sum() <= share + items.max()
            splits.append((items[a:e].sum(), items.sum() / len(items),
                           items.max()))
    assert sorted(seen_slots) == list(range(slots))
    work = np.array([sum(np.tile(cuda_fa.bwd_walk_pairs(
        kt, s, bk, bq, causal, window, prefix)[1], group)[a:e])
        for kt, a, e, _ in rows])
    assert (np.diff(work) <= 0).all()   # heaviest first
    # about BWD_BLOCKS_PER_SM blocks an SM: no split holds more than a
    # card-wide share of the pairs (or its tile's mean item) and one item
    want = max(tiles, cuda_fa.BWD_BLOCKS_PER_SM * sms // bkv)
    assert entries <= want + tiles
    quota = group * sum(cuda_fa.bwd_walk_pairs(
        kt, s, bk, bq, causal, window, prefix)[1].sum()
        for kt in range(tiles)) / want
    assert all(w <= max(quota, mean) + top for w, mean, top in splits)
