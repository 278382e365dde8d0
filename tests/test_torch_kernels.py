"""The port's rank-update ops on CPU tensors (the plain PyTorch versions)
against the JAX package's ops (Pallas, interpret mode) and its oracles,
and the CUDA entries' refusal of anything but CUDA tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rank_update as cuda_ru

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


@pytest.mark.parametrize("entry", ["rank_update", "rank_update_batched"])
def test_cuda_entry_refuses_cpu_tensors(entry, rng):
    """Called directly on CPU tensors, the CUDA entry raises: it never
    substitutes the plain version, launches nothing and leaves m as is."""
    m, u, v = _data(rng, 16, 8, 2, None if entry == "rank_update" else 1)
    tm = torch.from_numpy(m.copy())
    before = dict(cuda_ru.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(cuda_ru, entry)(tm, torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(tm.numpy(), m)
    assert cuda_ru.LAUNCHES == before


def test_cpu_ops_launch_no_kernel(rng):
    m, u, v = _data(rng, 16, 8, 2)
    before = dict(cuda_ru.LAUNCHES)
    ops.rank_update(torch.from_numpy(m), torch.from_numpy(u),
                    torch.from_numpy(v))
    ops.rank_update_batched(torch.from_numpy(m), torch.from_numpy(u),
                            torch.from_numpy(v))
    assert cuda_ru.LAUNCHES == before
