"""The port's kernel ops on CPU tensors (the plain PyTorch versions)
against the JAX package's ops (Pallas, interpret mode) and its oracles,
the CUDA entries' refusal of anything but CUDA tensors and of operands
that require grad, and the gradients the CPU ops still give."""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.sherman_morrison as sm
from repro.kernels import ops as jax_ops
from repro.kernels.dual_matmul import dual_matmul_pallas
from repro.kernels.flash_decode import flash_decode_pallas
from repro.kernels import ref as jax_ref
from repro.kernels.rank_update_rows import (rank_update_rows_pallas,
                                            rank_update_rows_ref)
from repro.models.attention import blockwise_attention
from repro_torch.kernels import dual_matmul as cuda_dual
from repro_torch.kernels import flash_attention as cuda_fa
from repro_torch.kernels import flash_decode as cuda_fd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rank_update as cuda_ru
from repro_torch.kernels import rank_update_rows as cuda_rows
from repro_torch.kernels import select_commit as cuda_sel
from repro_torch.kernels.rank_update_rows import RowSet

# repro.core exports a function of the same name as this module
jax_sm = importlib.import_module("repro.core.sherman_morrison")

from conftest import assert_close

# (n, p, k): aligned, ragged (the JAX wrapper takes its oracle there), p = 1;
# then views of 2 and 3 columns (the CUDA skinny tile) at k on both sides of
# 40 (K = T*k also past it at T = 3)
SHAPES = [(64, 64, 1), (128, 64, 4), (96, 160, 3), (37, 101, 5), (50, 1, 2),
          (600, 2, 3), (600, 2, 40), (600, 2, 41), (600, 3, 13),
          (600, 3, 40), (700, 3, 41)]


def _data(rng, n, p, k, t=None):
    lead = () if t is None else (t,)
    m = rng.normal(size=(n, p)).astype(np.float32)
    u = rng.normal(size=lead + (n, k)).astype(np.float32)
    v = rng.normal(size=lead + (p, k)).astype(np.float32)
    return m, u, v


@pytest.mark.parametrize("n,p,k", SHAPES)
def test_rank_update_matches_jax(n, p, k, rng):
    m, u, v = _data(rng, n, p, k)
    tm = torch.from_numpy(m.copy())
    out = ops.rank_update(tm, torch.from_numpy(u), torch.from_numpy(v))
    assert out is tm  # in place on the view's storage
    want = jax_ops.rank_update(jnp.asarray(m), jnp.asarray(u), jnp.asarray(v))
    assert_close(out.numpy(), want)
    assert_close(out.numpy(), jax_ref.rank_update(m, u, v))


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("n,p,k", SHAPES)
def test_rank_update_batched_matches_jax(n, p, k, t, rng):
    m, u, v = _data(rng, n, p, k, t)
    tm = torch.from_numpy(m.copy())
    out = ops.rank_update_batched(tm, torch.from_numpy(u),
                                  torch.from_numpy(v))
    assert out is tm
    want = jax_ops.rank_update_batched(jnp.asarray(m), jnp.asarray(u),
                                       jnp.asarray(v))
    assert_close(out.numpy(), want)
    assert_close(out.numpy(), jax_ref.rank_update_batched(m, u, v))


def test_two_dimensional_factors_are_the_single_stack(rng):
    m, u, v = _data(rng, 40, 24, 6)
    a = ops.rank_update_batched(torch.from_numpy(m.copy()),
                                torch.from_numpy(u), torch.from_numpy(v))
    b = ref.rank_update(torch.from_numpy(m), torch.from_numpy(u),
                        torch.from_numpy(v))
    assert_close(a.numpy(), b.numpy())


@pytest.mark.parametrize("t,k", [(16, 1), (3, 7), (2, 40)])
def test_stack_is_one_flat_contraction(t, k, rng):
    """A (T, n, k) stack is the (n, T*k) factor whose flat column kk is
    column kk % k of U_(kk / k): the index map the CUDA kernel walks."""
    n, p = 37, 29
    m, u, v = _data(rng, n, p, k, t)
    stacked = ops.rank_update_batched(torch.from_numpy(m.copy()),
                                      torch.from_numpy(u), torch.from_numpy(v))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    flat = ops.rank_update(torch.from_numpy(m.copy()),
                           tu.permute(1, 0, 2).reshape(n, t * k),
                           tv.permute(1, 0, 2).reshape(p, t * k))
    assert_close(stacked.numpy(), flat.numpy())
    want = jax_ops.rank_update_batched(jnp.asarray(m), jnp.asarray(u),
                                       jnp.asarray(v))
    assert_close(stacked.numpy(), want)
    assert_close(flat.numpy(), want)


def _launches():
    return {**cuda_ru.LAUNCHES, **cuda_rows.LAUNCHES, **cuda_dual.LAUNCHES,
            **cuda_fa.LAUNCHES, **cuda_fd.LAUNCHES, **cuda_sel.LAUNCHES}


def _entry_call(entry, rng, grad=False):
    """(call, m): a call of CUDA entry ``entry`` on CPU tensors made from
    ``rng``, its first float operand requiring grad when ``grad``, and the
    tensor it would write."""
    m, u, v = _data(rng, 16, 8, 2)
    tm, tu, tv = (torch.from_numpy(x.copy()) for x in (m, u, v))
    tu.requires_grad_(grad)
    q = torch.from_numpy(rng.normal(size=(1, 8, 2, 64)).astype(np.float32))
    q.requires_grad_(grad)
    calls = {
        "rank_update": lambda: cuda_ru.rank_update(tm, tu, tv),
        "rank_update_batched": lambda: cuda_ru.rank_update_batched(
            tm, tu[None], tv[None]),
        "rank_update_batched_out": lambda: cuda_ru.rank_update_batched_out(
            tm, tu[None], tv[None]),
        "rank_update_rows": lambda: cuda_rows.rank_update_rows(
            tm, RowSet([1, 4], 16), tu[:2], tv),
        "dual_matmul": lambda: cuda_dual.dual_matmul(tm, tv, tu),
        "flash_attention": lambda: cuda_fa.flash_attention(q, q, q),
        "flash_attention_fwd_lse": lambda: cuda_fa.flash_attention_fwd_lse(
            q, q, q),
        "flash_attention_bwd": lambda: cuda_fa.flash_attention_bwd(
            q, q, q, q, q, torch.zeros(1, 2, 8)),
        "flash_decode": lambda: cuda_fd.flash_decode(q[:, 0], q, q, 8),
        "flash_decode_lse": lambda: cuda_fd.flash_decode_lse(q[:, 0], q, q,
                                                             8),
        "select_commit": lambda: cuda_sel.select_commit(
            torch.ones(1, dtype=torch.int32), tu, tm[:, :2].contiguous()),
    }
    return calls[entry], tm, m


_ENTRIES = ["rank_update", "rank_update_batched", "rank_update_batched_out",
            "rank_update_rows", "dual_matmul", "flash_attention",
            "flash_attention_fwd_lse", "flash_attention_bwd",
            "flash_decode", "flash_decode_lse", "select_commit"]
# differentiable only through flash_attention's autograd Function
_RAW_FLASH = ("flash_attention_fwd_lse", "flash_attention_bwd")


@pytest.mark.parametrize("entry", _ENTRIES)
def test_cuda_entry_refuses_cpu_tensors(entry, rng):
    """Called directly on CPU tensors, the CUDA entry raises: it never
    substitutes the plain version, launches nothing and leaves m as is."""
    call, tm, m = _entry_call(entry, rng)
    before = _launches()
    with pytest.raises(ValueError, match="CUDA"):
        call()
    np.testing.assert_array_equal(tm.numpy(), m)
    assert _launches() == before


@pytest.mark.parametrize("entry", _ENTRIES)
def test_cuda_entry_refuses_operands_that_require_grad(entry, rng):
    """Under grad mode an operand that requires grad makes the CUDA entry
    raise first, before its device checks (it has no backward, so its
    output would carry no gradient): nothing launches and m is as it was.
    flash_attention has a backward (K1): under grad mode it runs its
    autograd Function, whose forward gets to the device check.  The
    forward with LSE and K1 itself, which that Function launches, are not
    differentiable and refuse.  Under no_grad the same call gets to the
    device check."""
    call, tm, m = _entry_call(entry, rng, grad=True)
    before = _launches()
    with (pytest.raises(ValueError, match="CUDA")
          if entry == "flash_attention" else
          pytest.raises(RuntimeError, match=f"{entry}: .*not differentiable")
          if entry in _RAW_FLASH else
          pytest.raises(RuntimeError, match=f"{entry}: .*no backward yet")):
        call()
    np.testing.assert_array_equal(tm.numpy(), m)
    assert _launches() == before
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call()


def test_cpu_ops_still_differentiate_through_the_plain_versions(rng):
    """On CPU tensors ops.rank_update and ops.flash_attention run ref.py,
    which autograd differentiates: d sum(m + u vᵀ) / du = 1 vᵀ summed, and
    attention's gradients equal jax.grad of the reference's
    blockwise_attention."""
    m, u, v = _data(rng, 16, 8, 2)
    tu = torch.from_numpy(u).requires_grad_(True)
    tv = torch.from_numpy(v).requires_grad_(True)
    out = ops.rank_update(torch.from_numpy(m.copy()), tu, tv)
    assert out.grad_fn is not None
    out.sum().backward()
    assert_close(tu.grad.numpy(), np.ones((16, 8)) @ v)
    assert_close(tv.grad.numpy(), np.ones((8, 16)) @ u)

    q, k, w = (rng.normal(size=(1, 40, h, 32)).astype(np.float32)
               for h in (4, 2, 2))
    dout = rng.normal(size=(1, 40, 4, 32)).astype(np.float32)
    tq, tk, tw = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, w))
    att = ops.flash_attention(tq, tk, tw, causal=True, window=16)
    (att * torch.from_numpy(dout)).sum().backward()

    def loss(q, k, w):
        return (blockwise_attention(q, k, w, causal=True, window=16,
                                    q_chunk=16, kv_chunk=16) * dout).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, w)))
    for got, exp in zip((tq.grad, tk.grad, tw.grad), want):
        assert_close(got.numpy(), exp)


def test_tile_limits_mirror_the_cuda_sources():
    """The binding's crossovers and tile rows (which decide the rows of M
    a launch may cover) are the constants of csrc/."""
    csrc = Path(cuda_ru.__file__).parent / "csrc"
    dense = (csrc / "rank_update.cu").read_text()
    tiles = (csrc / "rank_update_tiles.cuh").read_text()

    def const(text, name):
        return int(re.search(rf"\b{name} = (\d+)[,;]", text).group(1))

    assert cuda_ru.PSKINNY == const(dense, "PSKINNY")
    assert cuda_ru.KSTREAM == const(dense, "KSTREAM")
    assert cuda_ru.STREAM_ROWS == 8 * const(dense, "SROWS")
    assert cuda_ru.COMPUTE_ROWS == const(tiles, "CBM")
    assert cuda_ru.SKINNY_ROWS == const(tiles, "SK_MARGIN")
    assert const(tiles, "THREADS") == 256
    p = cuda_ru.PSKINNY
    assert cuda_ru.max_rows(p - 1, 2048) > 65535 * 128
    assert cuda_ru.max_rows(p, cuda_ru.KSTREAM) == 65535 * 64
    assert cuda_ru.max_rows(p, cuda_ru.KSTREAM + 1) == 65535 * 128


def test_cpu_ops_launch_no_kernel(rng):
    m, u, v = _data(rng, 16, 8, 2)
    tm, tu, tv = (torch.from_numpy(x) for x in (m, u, v))
    before = _launches()
    ops.rank_update(tm.clone(), tu, tv)
    ops.rank_update_batched(tm.clone(), tu, tv)
    ops.rank_update_rows(tm.clone(), [3, 7], tu[:2], tv)
    ops.rank_update_rows(tm.clone(), np.arange(10), tu[:10], tv)
    ops.dual_matmul(tm, tv, tu)
    ops.sherman_morrison_delta(tm[:8], tv[:, 0], tv[:, 1])
    assert _launches() == before


# ---------------------------------------------------------------------------
# row-local update (kernel 3)
# ---------------------------------------------------------------------------

# (n, p, r, k): one slab, several slabs, ragged p, the dense fallback past
# max_fraction (r > n / 4), a single row; then the JAX wrapper's slab
# kernel at the CUDA row entry's wide ranks (k = 41: its compute tile,
# k = 128: phase 6's stacked batch) and narrow views (p = 1, 2, 3 at k on
# both sides of 40: the card's skinny tile)
ROW_SHAPES = [(256, 128, 5, 2), (1024, 64, 40, 3), (512, 37, 9, 1),
              (64, 16, 20, 2), (300, 20, 1, 4),
              (4096, 1, 3, 41), (4096, 3, 3, 128), (4096, 3, 2, 41),
              (4096, 1, 2, 128),
              (4096, 2, 9, 40), (4096, 2, 9, 41), (4096, 3, 17, 40),
              (2048, 1, 5, 1)]


def _row_data(rng, n, p, r, k):
    m = rng.normal(size=(n, p)).astype(np.float32)
    rows = np.sort(rng.choice(n, r, replace=False)).astype(np.int32)
    block = rng.normal(size=(r, k)).astype(np.float32)
    v = rng.normal(size=(p, k)).astype(np.float32)
    return m, rows, block, v


@pytest.mark.parametrize("n,p,r,k", ROW_SHAPES)
def test_rank_update_rows_matches_jax(n, p, r, k, rng):
    """ops.rank_update_rows (the plain version, or the dense fallback past
    max_fraction) against the JAX wrapper, which takes its slab-plan Pallas
    kernel in interpret mode, its dense kernel or its scatter oracle."""
    m, rows, block, v = _row_data(rng, n, p, r, k)
    tm = torch.from_numpy(m.copy())
    out = ops.rank_update_rows(tm, rows, torch.from_numpy(block),
                               torch.from_numpy(v))
    assert out is tm
    want = jax_ops.rank_update_rows(jnp.asarray(m), rows, jnp.asarray(block),
                                    jnp.asarray(v))
    assert_close(out.numpy(), want)
    plain = ref.rank_update_rows(torch.from_numpy(m),
                                 torch.from_numpy(rows.astype(np.int64)),
                                 torch.from_numpy(block), torch.from_numpy(v))
    assert_close(plain.numpy(), rank_update_rows_ref(
        jnp.asarray(m), jnp.asarray(rows), jnp.asarray(block),
        jnp.asarray(v)))


@pytest.mark.parametrize("n,p,r,k", [(4096, 128, 3, 2), (8192, 64, 6, 3),
                                     (4096, 40, 2, 1), (4096, 3, 3, 128),
                                     (4096, 1, 2, 41)])
def test_plain_rows_match_the_slab_kernel(n, p, r, k, rng):
    """The plain version against rank_update_rows_pallas itself, run in
    interpret mode on the slab plan the JAX wrapper makes."""
    m, rows, block, v = _row_data(rng, n, p, r, k)
    plan = jax_ops.slab_plan(n, rows)
    assert plan is not None
    slab, slab_ids = plan
    assert len(set(np.asarray(slab_ids).tolist())) == len(slab_ids)
    u = np.zeros((n, k), np.float32)
    u[rows] = block
    bn = jax_ops._pick_block(p, 512)
    want = rank_update_rows_pallas(jnp.asarray(m), slab_ids, jnp.asarray(u),
                                   jnp.asarray(v), slab=slab, bn=bn,
                                   interpret=True)
    got = ref.rank_update_rows(torch.from_numpy(m),
                               torch.from_numpy(rows.astype(np.int64)),
                               torch.from_numpy(block), torch.from_numpy(v))
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("rows,err", [([4, 2], ValueError),
                                      ([2, 2], ValueError),
                                      ([-1, 3], ValueError),
                                      ([3, 16], ValueError),
                                      ([0.5, 2.0], TypeError)])
def test_row_set_refuses_bad_rows(rows, err):
    with pytest.raises(err):
        RowSet(rows, 16)
    with pytest.raises(err):
        ops.rank_update_rows(torch.zeros(16, 4), rows, torch.ones(2, 1),
                             torch.ones(4, 1))


def test_row_set_uploads_once_and_checks_its_view():
    rs = RowSet(np.array([1, 5, 6], np.int32), 8)
    assert rs.index("cpu") is rs.index("cpu")
    assert rs.ids("cpu").dtype == torch.int32
    assert RowSet.of(rs, 8) is rs
    with pytest.raises(ValueError):
        RowSet.of(rs, 9)


# ---------------------------------------------------------------------------
# dual matmul and Sherman–Morrison (kernel 4)
# ---------------------------------------------------------------------------


# (n, m, k): the first four as before; then the CUDA kernel's tile edges
# that its card tests use (a block's strip is 1024 columns, a warp's part
# 128, k in chunks of 8), with m % 4 != 0 and n or m of 1
@pytest.mark.parametrize("n,m,k", [(64, 128, 1), (96, 512, 3), (37, 101, 1),
                                   (40, 24, 9), (33, 1025, 1), (9, 130, 9),
                                   (20, 1030, 17), (50, 777, 5), (5, 1, 8),
                                   (1, 300, 5)])
def test_dual_matmul_matches_jax(n, m, k, rng):
    a = rng.normal(size=(n, m)).astype(np.float32)
    u = rng.normal(size=(m, k)).astype(np.float32)
    v = rng.normal(size=(n, k)).astype(np.float32)
    got = ops.dual_matmul(*(torch.from_numpy(x) for x in (a, u, v)))
    want = jax_ops.dual_matmul(jnp.asarray(a), jnp.asarray(u), jnp.asarray(v))
    oracle = jax_ref.dual_matmul(jnp.asarray(a), jnp.asarray(u),
                                 jnp.asarray(v))
    # the Pallas kernel itself, in interpret mode, on panels that divide m
    # (where none of 256, 128 does, one panel of all m columns)
    bn = next((b for b in (256, 128) if m % b == 0), m)
    pallas = dual_matmul_pallas(jnp.asarray(a), jnp.asarray(u),
                                jnp.asarray(v), bn=bn, interpret=True)
    for g, w, o, pk in zip(got, want, oracle, pallas):
        assert_close(g.numpy(), w)
        assert_close(g.numpy(), o)
        assert_close(g.numpy(), np.asarray(pk))


@pytest.mark.parametrize("n", [64, 100])
def test_sherman_morrison_delta_matches_jax(n, rng):
    w = (np.eye(n) + 0.1 * rng.normal(size=(n, n))).astype(np.float32)
    u = rng.normal(size=(n,)).astype(np.float32)
    v = rng.normal(size=(n, 1)).astype(np.float32)
    tw, tu, tv = (torch.from_numpy(x) for x in (w, u, v))
    want = jax_ops.sherman_morrison_delta(jnp.asarray(w), jnp.asarray(u),
                                          jnp.asarray(v))
    for got in (ops.sherman_morrison_delta(tw, tu, tv),
                ref.sherman_morrison_delta(tw, tu, tv),
                sm.sherman_morrison_delta(tw, tu, tv)):
        for g, x in zip(got, want):
            assert_close(g.numpy(), x)


def test_sherman_morrison_and_woodbury_match_jax(rng):
    n, k = 24, 3
    e = (np.eye(n) * 4 + rng.normal(size=(n, n))).astype(np.float32)
    w = np.linalg.inv(e).astype(np.float32)
    u, v = (rng.normal(size=(n, 1)).astype(np.float32) for _ in range(2))
    p, q = (rng.normal(size=(n, k)).astype(np.float32) for _ in range(2))
    t = {k_: torch.from_numpy(x) for k_, x in
         dict(w=w, u=u, v=v, p=p, q=q).items()}
    assert_close(sm.sherman_morrison(t["w"], t["u"], t["v"]).numpy(),
                 jax_sm.sherman_morrison(w, u, v))
    assert_close(sm.woodbury(t["w"], t["p"], t["q"]).numpy(),
                 jax_sm.woodbury(w, p, q))
    for g, x in zip(sm.woodbury_delta(t["w"], t["p"], t["q"]),
                    jax_sm.woodbury_delta(w, p, q)):
        assert_close(g.numpy(), x)
    # the delta is the change of the inverse
    assert_close(sm.woodbury(t["w"], t["p"], t["q"]).numpy(),
                 np.linalg.inv(e + p @ q.T), atol=1e-3)


# ---------------------------------------------------------------------------
# the flash-decode kernel's row statistics (kernel 6 with WRITE_LSE)
# ---------------------------------------------------------------------------

def _pallas_lse(q, k, v, n_valid, chunk):
    """flash_decode_pallas in interpret mode on one KV head's group:
    (acc / l, m + log l), the output and row log-sum-exp that its wrapper
    (src/repro/kernels/ops.py:214) drops to acc / l."""
    acc, m, l = flash_decode_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.int32(n_valid),
                                    chunk=chunk)
    return (np.asarray(acc / l), np.asarray(m + jnp.log(l))[:, 0])


@pytest.mark.parametrize("g,d,s,chunk,n_valid", [
    (4, 32, 64, 16, 1), (4, 32, 64, 16, 17), (4, 32, 64, 16, 64),
    (1, 64, 96, 32, 50), (16, 128, 128, 64, 100)])
def test_flash_decode_lse_matches_pallas(g, d, s, chunk, n_valid, rng):
    """ref.flash_decode_lse (the plain version of the CUDA entry
    flash_decode_fwd_lse) against flash_decode_pallas's (acc / l, m + log
    l) over ragged valid counts, one KV head's group of g query heads;
    2e-4 (tests/conftest.py)."""
    q = rng.normal(size=(g, d)).astype(np.float32)
    k, v = (rng.normal(size=(s, d)).astype(np.float32) for _ in range(2))
    out, lse = ops.flash_decode_lse(
        torch.from_numpy(q)[None], torch.from_numpy(k)[None, :, None],
        torch.from_numpy(v)[None, :, None],
        torch.tensor(n_valid, dtype=torch.int32))
    want_out, want_lse = _pallas_lse(q, k, v, n_valid, chunk)
    assert out.dtype == lse.dtype == torch.float32
    assert_close(out[0].numpy(), want_out)
    assert_close(lse[0].numpy(), want_lse)


def test_flash_decode_lse_with_no_valid_slot(rng):
    """n_valid = 0, as on a rank that holds none of the valid slots: out
    0 and lse -inf on every row, where the Pallas kernel (whose mask is
    -1e30, not -inf) has no such row; with one valid slot the same call
    is that slot's value and score."""
    q = torch.from_numpy(rng.normal(size=(2, 8, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 16, 2, 32)).astype(
        np.float32)) for _ in range(2))
    out, lse = ops.flash_decode_lse(q, k, v, torch.tensor(0,
                                                          dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.isneginf(lse).all()
    out, lse = ops.flash_decode_lse(q, k, v, 1)
    group = q.reshape(2, 2, 4, 32)
    score = (group * k[:, 0, :, None]).sum(-1).reshape(2, 8) * 32 ** -0.5
    assert_close(lse.numpy(), score.numpy())
    assert_close(out.numpy(), v[:, 0].repeat_interleave(4, dim=1).numpy())


@pytest.mark.parametrize("n_valid", [3, 40, 64])
def test_flash_decode_lse_partials_merge_to_the_whole(n_valid, rng):
    """A cache of 64 slots split in two blocks of 32, as the cache_seq rule
    splits it over two ranks: each block's (out, lse) over its valid
    slots, clamp(n_valid - lo, 0, 32) (0 on the second block at 3),
    merged by their LSE (dist.sharding.merge_partials), against
    flash_decode_pallas over the whole cache; 2e-4."""
    from repro_torch.dist.sharding import merge_partials
    g, d, s = 4, 32, 64
    q = rng.normal(size=(g, d)).astype(np.float32)
    k, v = (rng.normal(size=(s, d)).astype(np.float32) for _ in range(2))
    tq = torch.from_numpy(q)[None]
    outs, lses = [], []
    for lo in (0, 32):
        local = torch.tensor(min(max(n_valid - lo, 0), 32),
                             dtype=torch.int32)
        o, l = ops.flash_decode_lse(
            tq, torch.from_numpy(k[lo:lo + 32])[None, :, None],
            torch.from_numpy(v[lo:lo + 32])[None, :, None], local)
        outs.append(o)
        lses.append(l)
    got = merge_partials(torch.stack(outs), torch.stack(lses))
    want, _ = _pallas_lse(q, k, v, n_valid, 16)
    assert_close(got[0].numpy(), want)
