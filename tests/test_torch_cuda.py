"""The CUDA kernels and the engines on the card.

Marked ``cuda``: each test skips without a CUDA device.  On the GPU:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.apps import OLS, GeneralIterative, MatrixPowers
from repro_torch.core import (IncrementalEngine, NoOpCarrier, Program, dim,
                              matmul)
from repro_torch.data import UpdateStream, row_local_stream
from repro_torch.kernels import dual_matmul as cuda_dual
from repro_torch.kernels import flash_attention as cuda_fa
from repro_torch.kernels import flash_decode as cuda_fd
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


# The largest K = T*k that csrc/rank_update.cu gives its streaming tile;
# past it the compute tile runs.
KSTREAM = int(re.search(r"constexpr int KSTREAM = (\d+);",
                        (Path(cuda_ru.__file__).parent / "csrc" /
                         "rank_update.cu").read_text()).group(1))

# (n, p, T, k, misaligned): misaligned puts M at a 4-byte storage offset
_DENSE = [(64, 64, 1, 1), (100, 37, 1, 5), (130, 257, 3, 7),
          (1000, 999, 2, 40), (5, 1, 1, 17),
          (300, 260, 1, KSTREAM),           # both sides of the crossover
          (300, 260, 1, KSTREAM + 1),
          (260, 390, 1, 300),               # a ragged compute tile
          (333, 200, 5, 13),                # chunks that cross t
          (1000, 1000, 16, 1),              # T = 16 rank-1 pairs
          (333, 517, 1, 96)]                # p % 4 != 0, compute tile
_MISALIGNED = [(300, 256, 1, 16), (300, 256, 1, 96)]


@pytest.mark.parametrize(
    "n,p,t,k,misaligned",
    [pytest.param(*c, False, id="-".join(map(str, c))) for c in _DENSE]
    + [pytest.param(*c, True, id="-".join(map(str, c)) + "-misaligned")
       for c in _MISALIGNED])
def test_kernel_matches_plain(cuda, n, p, t, k, misaligned):
    g = torch.Generator(device=cuda).manual_seed(n + p + k)
    m = torch.randn(n, p, device=cuda, generator=g)
    u = torch.randn(t, n, k, device=cuda, generator=g)
    v = torch.randn(t, p, k, device=cuda, generator=g)

    def target():
        if not misaligned:
            return m.clone()
        out = torch.empty(n * p + 1, device=cuda)[1:].view(n, p)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out.copy_(m)

    before = cuda_ru.LAUNCHES["rank_update_batched"]
    got = ops.rank_update_batched(target(), u, v)
    assert cuda_ru.LAUNCHES["rank_update_batched"] == before + 1
    _close(got, ref.rank_update_batched(m, u, v))
    if t == 1:
        _close(ops.rank_update(target(), u[0], v[0]),
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


# The row entry's crossovers in csrc/rank_update_rows.cu: the largest k whose
# M loads precede the staging, and the largest k on the streaming tile.
_ROWS_CU = (Path(cuda_rows.__file__).parent / "csrc" /
            "rank_update_rows.cu").read_text()
ROWS_KM_FIRST, ROWS_KSTREAM = (
    int(re.search(rf"constexpr int {name} = (\d+);", _ROWS_CU).group(1))
    for name in ("KM_FIRST", "KSTREAM"))

# (n, p, r, k, layout): k on both sides of each crossover, p = 1, 3, 130
# (M as masked scalars) and 384 (M as float4); "offset" puts M at a 4-byte
# storage offset, "wide" lists more rows than 65535 tiles of 64 (the limit
# of a grid that put the listed rows on gridDim.y)
_ROW_KS = sorted({1, 8, 16, 17, 40, 41, 128, 256, ROWS_KM_FIRST,
                  ROWS_KM_FIRST + 1, ROWS_KSTREAM, ROWS_KSTREAM + 1})
_ROWS = [(64, 64, 1, 1), (1000, 37, 70, 5), (5000, 130, 64, 16),
         (300, 1, 65, 40)] + [(3000, p, 300, k) for p in (1, 3, 130, 384)
                              for k in _ROW_KS]
_ROWS_LAYOUT = [(1000, 384, 300, 8, "offset"), (1000, 384, 300, 128, "offset"),
                (65535 * 64 + 5000, 4, 65535 * 64 + 100, 8, "wide")]


@pytest.mark.parametrize(
    "n,p,r,k,layout",
    [pytest.param(*c, "contiguous", id="-".join(map(str, c))) for c in _ROWS]
    + [pytest.param(*c, id="-".join(map(str, c))) for c in _ROWS_LAYOUT])
def test_row_kernel_matches_plain(cuda, n, p, r, k, layout):
    g = torch.Generator(device=cuda).manual_seed(n + r)
    m = torch.randn(n, p, device=cuda, generator=g)
    block = torch.randn(r, k, device=cuda, generator=g)
    v = torch.randn(p, k, device=cuda, generator=g)
    rows = np.sort(np.random.default_rng(r).choice(n, r, replace=False))
    rs = cuda_rows.RowSet(rows, n)
    want = ref.rank_update_rows(m, rs.index(cuda), block, v)

    # M alone, or at element 1 of a flat buffer between two sentinels
    buf = torch.full((n * p + 2,), 7.0, device=cuda)
    target = m.clone()
    if layout == "offset":
        target = buf[1:-1].view(n, p).copy_(m)
        assert target.is_contiguous() and target.data_ptr() % 16 != 0
    before = cuda_rows.LAUNCHES["rank_update_rows"]
    got = cuda_rows.rank_update_rows(target, rs, block, v)
    assert cuda_rows.LAUNCHES["rank_update_rows"] == before + 1
    _close(got, want)
    # rows outside the set keep their bytes, and so does the buffer around M
    keep = torch.ones(n, dtype=torch.bool, device=cuda)
    keep[rs.index(cuda)] = False
    assert torch.equal(got[keep], m[keep])
    assert float(buf[0]) == float(buf[-1]) == 7.0
    if layout == "wide":
        return
    # past max_fraction the op takes the dense kernel
    dense = cuda_ru.LAUNCHES["rank_update"]
    _close(ops.rank_update_rows(m.clone(), rows, block, v, max_fraction=0.0),
           want)
    assert cuda_ru.LAUNCHES["rank_update"] == dense + 1


# (n, m, k, misaligned): the main path's 8192^2 at k = 1 and 8, phase 3's
# ragged shapes, the kernel's tile edges (a block's strip is 1024 columns, a
# warp's part 128, a ring stage 4 rows, a band at least 8 rows), k past one
# chunk of 8 (9, 17), m % 4 != 0 and A at a 4-byte storage offset (both
# take the 4-byte copies), n or m of 1
_DUAL = [(64, 64, 1), (1000, 777, 1), (33, 4097, 3), (300, 64, 9), (1, 1, 1),
         (8192, 8192, 1), (8192, 8192, 8), (1000, 777, 5), (37, 101, 1),
         (33, 1025, 1), (9, 130, 9), (70, 1030, 17), (5, 1, 8), (1, 300, 5),
         (3000, 1, 1)]
_DUAL_MISALIGNED = [(8192, 8192, 1), (1000, 776, 5), (64, 2048, 9)]


@pytest.mark.parametrize(
    "n,m,k,misaligned",
    [pytest.param(*c, False, id="-".join(map(str, c))) for c in _DUAL]
    + [pytest.param(*c, True, id="-".join(map(str, c)) + "-offset")
       for c in _DUAL_MISALIGNED])
def test_dual_kernel_matches_plain(cuda, n, m, k, misaligned):
    g = torch.Generator(device=cuda).manual_seed(n + m + k)
    base = torch.randn(n * m + 1, device=cuda, generator=g)
    a = (base[1:] if misaligned else base[:-1]).view(n, m)
    assert (a.data_ptr() % 16 != 0) == misaligned
    u = torch.randn(m, k, device=cuda, generator=g)
    v = torch.randn(n, k, device=cuda, generator=g)
    before = cuda_dual.LAUNCHES["dual_matmul"]
    got = ops.dual_matmul(a, u, v)
    assert cuda_dual.LAUNCHES["dual_matmul"] == before + 1
    # the plain version in float64: at 8192^2 two fp32 summation orders of
    # a sum that cancels to near 0 can differ by more than the tolerance
    for x, y in zip(got, ref.dual_matmul(a.double(), u.double(),
                                         v.double())):
        _close(x.double(), y)
    again = ops.dual_matmul(a, u, v)
    assert cuda_dual.LAUNCHES["dual_matmul"] == before + 2
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


# f32 outputs of the kernel and the plain version differ only in summation
# order.  In bf16 the plain version keeps p in f32, the decode kernel too,
# and the prefill kernel carries p as two bf16 terms (hi + lo, about 2^-17
# |p|); each output is rounded once to bf16, so they differ by about one
# rounding step, <= 2**-7 |x|.  A single bf16 rounding of p, as the
# reference's blockwise_attention makes, would not fit: see
# tests/test_torch_flash.py.
ATTN_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
            torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}

# (b, s, h, kvh, hd, causal, window), in f32 and bf16
_FLASH_BOTH = [
    (2, 200, 4, 4, 80, True, None),     # group 1, ragged S
    (1, 256, 8, 2, 128, True, None),    # group 4
    (2, 130, 36, 4, 128, True, None),   # group 9 (starcoder2's heads)
    (1, 300, 8, 2, 80, True, 70),       # window shorter than S
    (2, 64, 4, 1, 64, False, None),     # full attention
    (1, 97, 4, 4, 32, False, 16)]       # windowed, not causal
# bf16 only: the tensor-core kernel's tiles (128 query rows, 64 keys) at
# every head dim, lengths inside, at and across a tile, windows of 1 and
# shorter than a key tile, full attention, groups 1, 4 and 9
_FLASH_BF16 = [
    (1, 200, 4, 1, 32, True, None),     # hd 32, group 4
    (1, 200, 8, 2, 64, True, None),     # hd 64
    (1, 300, 8, 2, 96, True, None),     # hd 96
    (2, 1, 8, 2, 80, True, None),       # S = 1
    (1, 15, 4, 4, 64, True, None),      # S = 15, less than a tile
    (1, 64, 8, 2, 80, True, None),      # S = one key tile
    (1, 65, 8, 2, 128, True, None),     # one key past it
    (2, 1000, 32, 8, 80, True, None),   # danube's heads, ragged S
    (1, 2048, 8, 2, 80, False, None),   # 16 query tiles, full attention
    (1, 1000, 8, 2, 96, False, None),   # full attention, ragged
    (1, 300, 8, 2, 80, True, 1),        # window 1: each row keeps itself
    (1, 100, 4, 4, 32, False, 1),       # window 1, not causal
    (2, 500, 8, 2, 80, True, 40),       # window shorter than a key tile
    (1, 1000, 36, 4, 80, True, 100),    # group 9, windowed
    (1, 4128, 32, 8, 80, True, 4096)]   # danube's S = 4128 and window


@pytest.mark.parametrize(
    "dtype,b,s,h,kvh,hd,causal,window",
    [(dt, *c) for dt in (torch.float32, torch.bfloat16) for c in _FLASH_BOTH]
    + [(torch.bfloat16, *c) for c in _FLASH_BF16])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, s, h, kvh, hd,
                                              causal, window):
    g = torch.Generator(device=cuda).manual_seed(s + h + hd)
    q, k, v = (torch.randn(b, s, n, hd, device=cuda, generator=g
                           ).to(dtype) for n in (h, kvh, kvh))
    before = cuda_fa.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert cuda_fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(
        got, ref.flash_attention(q, k, v, causal=causal, window=window),
        **ATTN_TOL[dtype])


def _decode_inputs(device, dtype, b, L, h, kvh, hd, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(*shape, device=device, generator=g).to(dtype)
                 for shape in ((b, h, hd), (b, L, kvh, hd), (b, L, kvh, hd)))


@pytest.mark.parametrize("n_form", ["int", "tensor"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,L,h,kvh,hd,n_valid", [
    (2, 256, 4, 4, 80, 1),         # group 1, one valid slot
    (8, 1024, 32, 8, 80, 513),     # danube's heads, a ragged prefix
    (2, 512, 36, 4, 128, 512),     # group 9, a full (wrapped) ring
    (1, 1000, 8, 2, 128, 999),
    (2, 300, 16, 1, 64, 300),      # group 16
    (3, 200, 8, 2, 32, 77),        # head_dim 32
    (1, 700, 8, 1, 64, 650),       # head_dim 64, group 8
    (2, 333, 12, 4, 96, 200)])     # head_dim 96, group 3
def test_flash_decode_kernel_matches_plain(cuda, n_form, dtype, b, L, h, kvh,
                                           hd, n_valid):
    q, k, v = _decode_inputs(cuda, dtype, b, L, h, kvh, hd, L + h + n_valid)
    n = n_valid if n_form == "int" else torch.tensor(
        n_valid, dtype=torch.int32, device=cuda)
    before = cuda_fd.LAUNCHES["flash_decode"]
    got = ops.flash_decode(q, k, v, n)
    assert cuda_fd.LAUNCHES["flash_decode"] == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got, ref.flash_decode(q, k, v, n_valid),
                               **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_is_deterministic(cuda, dtype):
    """The splits merge in a fixed order: two calls agree bit for bit, and
    the int and tensor forms of n_valid too."""
    q, k, v = _decode_inputs(cuda, dtype, 8, 4096, 32, 8, 80, 7)
    first = ops.flash_decode(q, k, v, 3001)
    n = torch.tensor([3001], dtype=torch.int32, device=cuda)
    for _ in range(2):
        assert torch.equal(ops.flash_decode(q, k, v, n), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_replays_in_a_cuda_graph(cuda, dtype):
    """One call captured in a CUDA graph, replayed after writing other
    n_valid into its tensor: the launch depends on the cache's shape only,
    and the kernel reads n_valid on the card."""
    L = 4096
    q, k, v = _decode_inputs(cuda, dtype, 2, L, 32, 8, 80, 11)
    n = torch.tensor(L, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_decode(q, k, v, n)            # warm-up: build and load
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = cuda_fd.LAUNCHES["flash_decode"]
    with torch.cuda.graph(graph):
        out = ops.flash_decode(q, k, v, n)
    assert cuda_fd.LAUNCHES["flash_decode"] == before + 1
    for n_valid in (1, 2049, L):
        n.fill_(n_valid)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref.flash_decode(q, k, v, n_valid),
                                   **ATTN_TOL[dtype])


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 4, 80, device=cuda)
    with pytest.raises(TypeError):
        cuda_fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="head_dim"):
        cuda_fa.flash_attention(q[..., :72].contiguous(),
                                q[..., :72].contiguous(),
                                q[..., :72].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fa.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="n_valid"):
        cuda_fd.flash_decode(q[:, 0], q, q, 9)
    with pytest.raises(ValueError, match="n_valid"):
        cuda_fd.flash_decode(q[:, 0], q, q, torch.tensor(3, device=cuda))
    with pytest.raises(ValueError, match="n_valid"):
        cuda_fd.flash_decode(q[:, 0], q, q, torch.tensor(3,
                                                         dtype=torch.int32))
