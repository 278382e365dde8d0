"""The CUDA kernels and the engines on the card.

Marked ``cuda``: each test skips without a CUDA device.  On the GPU:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.apps import OLS, GeneralIterative, MatrixPowers
from repro_torch.core import (IncrementalEngine, NoOpCarrier, Program, dim,
                              matmul)
from repro_torch.data import UpdateStream, row_local_stream
from repro_torch.kernels import dual_matmul as cuda_dual
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rank_update as cuda_ru
from repro_torch.kernels import rank_update_rows as cuda_rows

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


@pytest.mark.parametrize("n,p,r,k", [(64, 64, 1, 1), (1000, 37, 70, 5),
                                     (5000, 130, 64, 16), (300, 1, 65, 40)])
def test_row_kernel_matches_plain(cuda, n, p, r, k):
    g = torch.Generator(device=cuda).manual_seed(n + r)
    m = torch.randn(n, p, device=cuda, generator=g)
    block = torch.randn(r, k, device=cuda, generator=g)
    v = torch.randn(p, k, device=cuda, generator=g)
    rows = np.sort(np.random.default_rng(r).choice(n, r, replace=False))
    rs = cuda_rows.RowSet(rows, n)
    before = cuda_rows.LAUNCHES["rank_update_rows"]
    got = cuda_rows.rank_update_rows(m.clone(), rs, block, v)
    assert cuda_rows.LAUNCHES["rank_update_rows"] == before + 1
    _close(got, ref.rank_update_rows(m, rs.index(cuda), block, v))
    # past max_fraction the op takes the dense kernel
    dense = cuda_ru.LAUNCHES["rank_update"]
    _close(ops.rank_update_rows(m.clone(), rows, block, v, max_fraction=0.0),
           ref.rank_update_rows(m, rs.index(cuda), block, v))
    assert cuda_ru.LAUNCHES["rank_update"] == dense + 1


@pytest.mark.parametrize("n,m,k", [(64, 64, 1), (1000, 777, 1), (33, 4097, 3),
                                   (300, 64, 9), (1, 1, 1)])
def test_dual_kernel_matches_plain(cuda, n, m, k):
    g = torch.Generator(device=cuda).manual_seed(n + m + k)
    a = torch.randn(n, m, device=cuda, generator=g)
    u = torch.randn(m, k, device=cuda, generator=g)
    v = torch.randn(n, k, device=cuda, generator=g)
    before = cuda_dual.LAUNCHES["dual_matmul"]
    got = ops.dual_matmul(a, u, v)
    assert cuda_dual.LAUNCHES["dual_matmul"] == before + 1
    for x, y in zip(got, ref.dual_matmul(a, u, v)):
        _close(x, y)
    again = ops.dual_matmul(a, u, v)
    for x, y in zip(got, again):   # fixed summation order: bit for bit
        assert torch.equal(x, y)
    w = torch.eye(n, device=cuda) + 0.01 * a[:, :n] if m >= n else None
    if w is not None:
        for x, y in zip(ops.sherman_morrison_delta(w, v[:, 0], v[:, 0]),
                        ref.sherman_morrison_delta(w, v[:, 0], v[:, 0])):
            _close(x, y)


def _chain(n, m, k):
    p = Program(name="chain")
    X = p.input("X", (dim("N"), dim("M")))
    W1 = p.input("W1", (dim("M"), dim("K")))
    W2 = p.input("W2", (dim("K"), dim("K")))
    Y1 = p.let("Y1", matmul(X, W1))
    p.let("Y2", matmul(Y1, W2))
    p.outputs = ["Y1", "Y2"]
    return p.bind_dims(N=n, M=m, K=k)


@pytest.mark.parametrize("regime", ["compact", "mixed"])
def test_carrier_engine_on_card_matches_cpu(cuda, regime):
    rng = np.random.default_rng(3)
    if regime == "compact":
        n, m = 512, 48
        prog, inp = _chain(n, m, 32), "X"
        inputs = {"X": rng.standard_normal((n, m)).astype(np.float32),
                  "W1": rng.standard_normal((m, 32)).astype(np.float32),
                  "W2": rng.standard_normal((32, 32)).astype(np.float32)}
        gpu = IncrementalEngine(prog, {inp: 2})
        cpu = IncrementalEngine(prog, {inp: 2}, device="cpu")
    else:
        n, m = 96, 96
        inputs = GeneralIterative.synthesize(n, 8, seed=0)
        gpu = GeneralIterative(n, 8, k=4).engine
        cpu = GeneralIterative(n, 8, k=4, device="cpu").engine
        inp = "A"
    stream = row_local_stream(n, 5, m=m, rank=2 if regime == "compact"
                              else 1, seed=1)
    ups = [stream.next_carrier() for _ in range(7)]
    rows0 = cuda_rows.LAUNCHES["rank_update_rows"]
    for eng in (gpu, cpu):
        eng.initialize(inputs)
        for c in ups[:3]:
            eng.apply_update(inp, c)
        eng.apply_updates(inp, ups[3:] + [NoOpCarrier(n, m)])
    assert gpu.stats.rowlocal_firings == 4 and gpu.stats.noop_skips == 1
    assert cuda_rows.LAUNCHES["rank_update_rows"] - rows0 == \
        gpu.stats.row_applies == cpu.stats.row_applies > 0
    for k, v in cpu.views.items():
        got = gpu.views[k].cpu()
        scale = float(v.abs().max()) or 1.0
        assert float((got - v).abs().max()) / scale <= 1e-5, k
