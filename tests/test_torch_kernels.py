"""The port's kernel ops on CPU tensors (the plain PyTorch versions)
against the JAX package's ops (Pallas, interpret mode) and its oracles,
and the CUDA entries' refusal of anything but CUDA tensors."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.sherman_morrison as sm
from repro.kernels import ops as jax_ops
from repro.kernels.dual_matmul import dual_matmul_pallas
from repro.kernels import ref as jax_ref
from repro.kernels.rank_update_rows import (rank_update_rows_pallas,
                                            rank_update_rows_ref)
from repro_torch.kernels import dual_matmul as cuda_dual
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rank_update as cuda_ru
from repro_torch.kernels import rank_update_rows as cuda_rows
from repro_torch.kernels.rank_update_rows import RowSet

# repro.core exports a function of the same name as this module
jax_sm = importlib.import_module("repro.core.sherman_morrison")

from conftest import assert_close

# (n, p, k): aligned, ragged (the JAX wrapper takes its oracle there), p = 1
SHAPES = [(64, 64, 1), (128, 64, 4), (96, 160, 3), (37, 101, 5), (50, 1, 2)]


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
    return {**cuda_ru.LAUNCHES, **cuda_rows.LAUNCHES, **cuda_dual.LAUNCHES}


@pytest.mark.parametrize("entry", ["rank_update", "rank_update_batched",
                                   "rank_update_rows", "dual_matmul"])
def test_cuda_entry_refuses_cpu_tensors(entry, rng):
    """Called directly on CPU tensors, the CUDA entry raises: it never
    substitutes the plain version, launches nothing and leaves m as is."""
    m, u, v = _data(rng, 16, 8, 2, None if entry != "rank_update_batched"
                    else 1)
    tm, tu, tv = (torch.from_numpy(x.copy()) for x in (m, u, v))
    before = _launches()
    with pytest.raises(ValueError, match="CUDA"):
        if entry == "rank_update_rows":
            cuda_rows.rank_update_rows(tm, RowSet([1, 4], 16), tu[:2], tv)
        elif entry == "dual_matmul":
            cuda_dual.dual_matmul(tm, tv, tu)
        else:
            getattr(cuda_ru, entry)(tm, tu, tv)
    np.testing.assert_array_equal(tm.numpy(), m)
    assert _launches() == before


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
# k = 128: phase 6's stacked batch) and narrow views (p = 1, 3: M moved as
# masked scalars on the card)
ROW_SHAPES = [(256, 128, 5, 2), (1024, 64, 40, 3), (512, 37, 9, 1),
              (64, 16, 20, 2), (300, 20, 1, 4),
              (4096, 1, 3, 41), (4096, 3, 3, 128), (4096, 3, 2, 41),
              (4096, 1, 2, 128)]


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
