"""The CUDA rank-update kernel and the engines on the card.

Marked ``cuda``: each test skips without a CUDA device.  On the GPU:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import pytest
import torch

from repro_torch.apps import OLS, MatrixPowers
from repro_torch.data import UpdateStream
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rank_update as cuda_ru

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n,p,t,k", [(64, 64, 1, 1), (100, 37, 1, 5),
                                     (130, 257, 3, 7), (1000, 999, 2, 40),
                                     (5, 1, 1, 17)])
def test_kernel_matches_plain(cuda, n, p, t, k):
    g = torch.Generator(device=cuda).manual_seed(n + p + k)
    m = torch.randn(n, p, device=cuda, generator=g)
    u = torch.randn(t, n, k, device=cuda, generator=g)
    v = torch.randn(t, p, k, device=cuda, generator=g)
    before = cuda_ru.LAUNCHES["rank_update_batched"]
    got = ops.rank_update_batched(m.clone(), u, v)
    assert cuda_ru.LAUNCHES["rank_update_batched"] == before + 1
    _close(got, ref.rank_update_batched(m, u, v))
    if t == 1:
        _close(ops.rank_update(m.clone(), u[0], v[0]),
               ref.rank_update(m, u[0], v[0]))


def test_kernel_refuses_what_it_does_not_take(cuda):
    m = torch.zeros(8, 8, device=cuda)
    u = torch.zeros(8, 2, device=cuda)
    with pytest.raises(TypeError):
        cuda_ru.rank_update(m.double(), u.double(), u.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ru.rank_update(m.T, u, u)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ru.rank_update(m, u.cpu(), u)
    with pytest.raises(ValueError, match="shares storage"):
        cuda_ru.rank_update(m, m.view(-1)[:16].view(8, 2), u)


@pytest.mark.parametrize("app", ["ols", "matrix_powers"])
def test_engine_on_card_matches_cpu(cuda, app):
    if app == "ols":
        inputs, _ = OLS.synthesize(96, 24, 2, seed=0)
        gpu, cpu = OLS(96, 24, 2), OLS(96, 24, 2, device="cpu")
        shape = (96, 24)
    else:
        inputs = MatrixPowers.synthesize(64, seed=0)
        gpu, cpu = MatrixPowers(n=64, k=8), MatrixPowers(n=64, k=8,
                                                         device="cpu")
        shape = (64, 64)
    assert gpu.device.type == "cuda"
    stream = UpdateStream(n=shape[0], m=shape[1], seed=1)
    ups = [stream.next_update() for _ in range(6)]
    for app_ in (gpu, cpu):
        app_.initialize(inputs)
        app_.engine.apply_update(app_.update_input, *ups[0])
        app_.engine.apply_updates(app_.update_input, ups[1:])
    for k, v in cpu.engine.views.items():
        g = gpu.engine.views[k].cpu()
        scale = float(v.abs().max()) or 1.0
        assert float((g - v).abs().max()) / scale <= 1e-5, k
