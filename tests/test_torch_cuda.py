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
from repro_torch.kernels import select_commit as cuda_sel

from flash_bounds import flash_attention_bwd_bf16_bound

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
# the skinny tile (p < PSKINNY: 1, 2, 3) at K on both sides of KSTREAM and
# of its tiny geometry's 4, one chunk and many (K = 300: 10 chunks of 32),
# 4-byte copies (k = 1, 3, 41) and 16-byte ones (k = 4, 40, 300, 1024),
# T > 1 stacks whose chunks cross t, ragged tails of its tiles, and 2^20
# rows over a full persistent grid
_DENSE += [(n, p, t, k) for p in (1, 2, 3) for n, t, k in (
    (1000, 1, 1), (1000, 1, 3), (1000, 1, 40), (1000, 1, 41),
    (1000, 1, 300), (777, 3, 1), (777, 16, 1), (333, 5, 13), (600, 2, 4),
    (5000, 2, 1024), (2 ** 20 + 3, 1, 3))]
_MISALIGNED = [(300, 256, 1, 16), (300, 256, 1, 96), (300, 1, 1, 16),
               (1001, 1, 3, 1), (1001, 1, 1, 300), (999, 3, 1, 3),
               (2 ** 20, 1, 1, 2)]


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


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("t,k", [(1, 1), (1, 3), (3, 1), (1, 8), (1, 40),
                                 (1, 41), (16, 1), (2, 96), (1, 300)])
def test_skinny_tile_gives_the_wide_tiles_bits(cuda, p, t, k):
    """Column j of a p < PSKINNY view is the same fmaf chain as column j of
    the view widened to PSKINNY columns (the streaming or compute tile):
    bit for bit, in place and out of place, on both of its geometries
    (K <= 4 over enough rows to fill the SMs with its tiny tiles)."""
    g = torch.Generator(device=cuda).manual_seed(p + t + k)
    n = 2 ** 19 + 3 if t * k <= 4 else 3000
    wide_p = cuda_ru.PSKINNY
    assert cuda_ru.takes_skinny(p) and not cuda_ru.takes_skinny(wide_p)
    m = torch.randn(n, wide_p, device=cuda, generator=g)
    u = torch.randn(t, n, k, device=cuda, generator=g)
    v = torch.randn(t, wide_p, k, device=cuda, generator=g)
    wide = ops.rank_update_batched(m.clone(), u, v)
    before = cuda_ru.SKINNY_RANKS["rank_update_batched"][t * k]
    narrow = ops.rank_update_batched(m[:, :p].contiguous(), u,
                                     v[:, :p].contiguous())
    assert cuda_ru.SKINNY_RANKS["rank_update_batched"][t * k] == before + 1
    out = ops.rank_update_batched_out(m[:, :p].contiguous(), u,
                                      v[:, :p].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(narrow, wide[:, :p])
    assert torch.equal(out, narrow)


def test_skinny_tile_takes_misaligned_factors_and_sources(cuda):
    """k % 4 == 0 with U at a 4-byte offset (4-byte copies), and an
    out-of-place source and destination at different offsets mod 16."""
    g = torch.Generator(device=cuda).manual_seed(3)
    n, p, t, k = 5000, 3, 2, 8
    m = torch.randn(n, p, device=cuda, generator=g)
    u = torch.empty(t * n * k + 1, device=cuda)[1:].view(t, n, k)
    u.copy_(torch.randn(t, n, k, device=cuda, generator=g))
    v = torch.randn(t, p, k, device=cuda, generator=g)
    assert u.data_ptr() % 16 != 0
    want = ref.rank_update_batched(m, u, v)
    _close(ops.rank_update_batched(m.clone(), u, v), want)
    src = torch.empty(n * p + 2, device=cuda)[2:].view(n, p).copy_(m)
    assert src.data_ptr() % 16 == 8
    out = ops.rank_update_batched_out(src, u, v)
    torch.cuda.synchronize()
    assert torch.equal(out, ops.rank_update_batched(m.clone(), u, v))
    assert torch.equal(src, m)


def test_dense_row_limit_follows_the_tile(cuda):
    """Past 65535 tiles of 64 rows a p < PSKINNY view still runs (the
    skinny tile's grid walks its tiles); a view of PSKINNY columns runs
    only on the compute tile, whose row tiles are 128 rows, and is refused
    on the streaming tile."""
    n = 65535 * 64 + 5000
    g = torch.Generator(device=cuda).manual_seed(4)
    wide = cuda_ru.PSKINNY
    for p, k, runs in ((1, 3, True), (wide - 1, 41, True), (wide, 8, False),
                       (wide, 41, True)):
        m = torch.randn(n, p, device=cuda, generator=g)
        u = torch.randn(n, k, device=cuda, generator=g)
        v = torch.randn(p, k, device=cuda, generator=g)
        assert (n <= cuda_ru.max_rows(p, k)) == runs
        if runs:
            _close(ops.rank_update(m.clone(), u, v),
                   ref.rank_update(m, u, v))
        else:
            with pytest.raises(ValueError, match="grid"):
                ops.rank_update(m, u, v)
        del m, u, v


def _entry_calls(device):
    """One call of every CUDA entry on tensors of ``device``, each as a
    function of the operands' requires_grad."""
    def f(*shape):
        return torch.randn(*shape, device=device)

    def req(x, grad):
        return x.requires_grad_(grad)

    return {
        "rank_update": lambda g: cuda_ru.rank_update(
            f(16, 8), req(f(16, 2), g), f(8, 2)),
        "rank_update_batched": lambda g: cuda_ru.rank_update_batched(
            f(16, 8), f(1, 16, 2), req(f(1, 8, 2), g)),
        "rank_update_batched_out": lambda g: cuda_ru.rank_update_batched_out(
            req(f(16, 8), g), f(1, 16, 2), f(1, 8, 2)),
        "rank_update_rows": lambda g: cuda_rows.rank_update_rows(
            f(16, 8), cuda_rows.RowSet([1, 4], 16), req(f(2, 2), g),
            f(8, 2)),
        "dual_matmul": lambda g: cuda_dual.dual_matmul(
            req(f(16, 8), g), f(8, 2), f(16, 2)),
        "flash_attention": lambda g: cuda_fa.flash_attention(
            req(f(1, 8, 2, 64), g), f(1, 8, 2, 64), f(1, 8, 2, 64)),
        "flash_decode": lambda g: cuda_fd.flash_decode(
            f(1, 2, 64), req(f(1, 8, 2, 64), g), f(1, 8, 2, 64), 8),
        "select_commit": lambda g: cuda_sel.select_commit(
            torch.zeros(1, dtype=torch.int32, device=device),
            req(f(4, 4), g), f(4, 4)),
    }


def _all_launches():
    return {**cuda_ru.LAUNCHES, **cuda_rows.LAUNCHES, **cuda_dual.LAUNCHES,
            **cuda_fa.LAUNCHES, **cuda_fd.LAUNCHES, **cuda_sel.LAUNCHES}


@pytest.mark.parametrize("entry", list(_entry_calls("cpu")))
def test_cuda_entry_refuses_grad_on_the_card(cuda, entry):
    """With an operand that requires grad under grad mode the entry raises
    before it launches (it has no backward); under no_grad, or with no
    operand requiring grad, it launches once.  flash_attention has a
    backward (K1): under grad mode it launches the forward with the row
    log-sum-exp once, and its gradient the backward once."""
    call = _entry_calls(cuda)[entry]
    before = _all_launches()
    if entry == "flash_attention":
        out = call(True)
        assert out.grad_fn is not None
        out.sum().backward()
        torch.cuda.synchronize()
        after = _all_launches()
        assert after["flash_attention_fwd_lse"] == \
            before["flash_attention_fwd_lse"] + 1
        assert after["flash_attention_bwd"] == \
            before["flash_attention_bwd"] + 1
        assert after[entry] == before[entry]
        before = after
    else:
        with pytest.raises(RuntimeError, match="no backward yet"):
            call(True)
        assert _all_launches() == before
    with torch.no_grad():
        call(True)
    with torch.inference_mode():
        call(False)
    call(False)
    torch.cuda.synchronize()
    assert _all_launches()[entry] == before[entry] + 3


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


def _hybrid_plan(engine, threshold):
    """Every view hybrid at ``threshold``: batches of 2 sweep, re-evaluate,
    sweep, ... (the construction of tests/test_planner.py)."""
    from dataclasses import replace
    from repro_torch.plan import (MaintenancePlan, WorkloadDescriptor,
                                  plan_for_engine)
    base = plan_for_engine(engine, WorkloadDescriptor())
    return MaintenancePlan(base.fingerprint, base.workload, {
        n: replace(vp, strategy="hybrid", threshold_rank=threshold)
        for n, vp in base.views.items()})


@pytest.mark.parametrize("app", ["ols", "matrix_powers"])
def test_planned_engine_on_card_matches_cpu(cuda, app):
    """A hybrid plan on the card against the same plan on the CPU port;
    the dense kernel launches once per incremental view apply, never for
    a view re-evaluated inside the firing."""
    from repro_torch.plan import TriggerCache
    if app == "ols":
        inputs, _ = OLS.synthesize(96, 24, 2, seed=0)
        make = lambda device: OLS(96, 24, 2, device=device)
        shape = (96, 24)
    else:
        inputs = MatrixPowers.synthesize(64, seed=0)
        make = lambda device: MatrixPowers(n=64, k=8, device=device)
        shape = (64, 64)
    stream = UpdateStream(n=shape[0], m=shape[1], seed=2)
    batches = [[stream.next_update() for _ in range(2)] for _ in range(4)]
    engines = {}
    for device in ("cuda", "cpu"):
        base = make(device)
        eng = IncrementalEngine(base.program, {base.update_input: 1},
                                plan=_hybrid_plan(base.engine, 4),
                                trigger_cache=TriggerCache(), device=device)
        eng.initialize(inputs)
        engines[device] = (eng, base.update_input)
    gpu, name = engines["cuda"]
    cpu, _ = engines["cpu"]
    before = cuda_ru.LAUNCHES["rank_update_batched"]
    for batch in batches:
        gpu.apply_updates(name, batch)
        cpu.apply_updates(name, batch)
    torch.cuda.synchronize()
    launched = cuda_ru.LAUNCHES["rank_update_batched"] - before
    assert gpu.stats.plan_reevals == cpu.stats.plan_reevals == \
        2 * len(gpu.plan.views)
    assert launched == gpu.stats.lowrank_applies == \
        cpu.stats.lowrank_applies
    fns = [fn for fn in gpu._planned_fns.values() if fn.reeval_views]
    assert fns and all(fn.lowrank_applies == 1 for fn in fns)  # the input
    for k, v in cpu.views.items():
        g = gpu.views[k].cpu()
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
                (65535 * 64 + 5000, 4, 65535 * 64 + 100, 8, "wide"),
                # the skinny tile: M at an odd offset, 4-byte rows
                # scattered over 2^20, more than one persistent wave
                (1000, 1, 300, 8, "offset"), (1000, 3, 300, 41, "offset"),
                (2 ** 20, 1, 10485, 1, "contiguous"),
                (2 ** 20, 3, 157275, 128, "contiguous"),
                (65535 * 64 + 5000, 1, 65535 * 64 + 100, 3, "wide")]


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


# f32 outputs of the kernel and the plain version differ in summation
# order and, the prefill kernel's products being three split TF32
# products, by what the split leaves out (about 2^-21 of each operand;
# tests/test_torch_flash.py shows why one TF32 product would not fit).  In
# bf16 the plain version keeps p in f32, the decode kernel too, and the
# prefill kernel carries p as two bf16 terms (hi + lo, about 2^-17
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
    (1, 97, 4, 4, 32, False, 16),       # windowed, not causal
    (2, 288, 32, 32, 64, True, None),   # zamba2's f32 cut: hd 64, group 1
    (1, 1000, 96, 8, 128, True, None),  # command-r-plus-104b: group 12
    (1, 1000, 40, 40, 128, True, None)]  # qwen1.5-32b: H = KV = 40
# bf16 only: the tensor-core kernels' tiles (128 query rows; 64 keys on
# mma.sync, 128 on wgmma, 64 at its head dim 64 up to S = 256) at every
# head dim, lengths inside, at and across a tile, windows of 1 and shorter
# than a key tile, full attention, groups 1, 4 and 9
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
    (1, 4128, 32, 8, 80, True, 4096),   # danube's S = 4128 and window
    (8, 2048, 32, 32, 64, True, None)]  # zamba2's forward: hd 64, group 1


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


# bf16 at head dims 64, 80 and 128: the wgmma kernel, both instances, under
# each mask (causal, a window, the prefix, full), groups of 1, 8 and 16 and
# ragged lengths: (b, s, h, kvh, hd, causal, window, prefix)
_FLASH_WGMMA = [
    (1, 384, 8, 8, 64, True, None, 0),      # causal, group 1
    (2, 1000, 16, 2, 80, True, None, 0),    # ragged S, group 8
    (1, 700, 16, 1, 128, True, 200, 0),     # a window, group 16
    (2, 600, 8, 1, 80, True, None, 256),    # the prefix, group 8
    (1, 500, 16, 1, 64, False, None, 0),    # full, group 16
    (1, 520, 16, 2, 128, False, 100, 0),    # full under a window
    (1, 333, 16, 16, 80, True, 64, 100),    # window and prefix, group 1
    (4, 200, 16, 1, 64, True, 50, 70)]      # 64-key tiles (S <= 256)


@pytest.mark.parametrize("b,s,h,kvh,hd,causal,window,prefix", _FLASH_WGMMA)
def test_flash_attention_wgmma_kernel_matches_plain(cuda, b, s, h, kvh, hd,
                                                    causal, window, prefix):
    g = torch.Generator(device=cuda).manual_seed(s + h + hd + prefix)
    q, k, v = (torch.randn(b, s, n, hd, device=cuda, generator=g
                           ).to(torch.bfloat16) for n in (h, kvh, kvh))
    opts = dict(causal=causal, window=window, prefix_len=prefix)
    wgmma = "flash_attention_bf16_wgmma"
    fwd = ("flash_attention", "flash_attention_fwd_lse")
    before = {entry: cuda_fa.BY_KERNEL[entry][wgmma] for entry in fwd}
    got = cuda_fa.flash_attention(q, k, v, **opts)
    out, lse = cuda_fa.flash_attention_fwd_lse(q, k, v, **opts)
    assert {entry: cuda_fa.BY_KERNEL[entry][wgmma] for entry in fwd} == \
        {e: n + 1 for e, n in before.items()}
    want, want_lse = ref.flash_attention_lse(q, k, v, **opts)
    torch.testing.assert_close(got, want, **ATTN_TOL[torch.bfloat16])
    assert torch.equal(out, got)
    torch.testing.assert_close(lse, want_lse, rtol=2e-4, atol=2e-4)


# f32 only: the split-TF32 kernel's two geometries (blocks of 128 query
# rows where ceil(S / 128) * H * B reaches 1.5 times the SMs -- 198 on an
# H100 SXM's 132 -- else of 64 rows whose warps split each key tile; head
# dim 256 always the latter), a ragged S
# (not a multiple of the 64-key tile, or of 32 at head dim 256) at every
# head dim, and windows that leave rows of a warp with no kept key in a
# tile the warp reads (rows 70-79 of window 5 in key tile 0)
_FLASH_F32 = [
    (1, 256, 16, 16, 128, True, None),   # 32 tiles of 128 rows: 64
    (2, 1024, 16, 16, 128, True, None),  # 256: 128
    (1, 640, 33, 11, 80, True, None),    # 165: 64
    (1, 768, 33, 11, 80, True, None),    # 198: 128
    (1, 100, 4, 4, 32, True, None),      # ragged at each head dim
    (1, 161, 8, 2, 64, True, None),
    (2, 333, 8, 2, 80, False, None),
    (1, 77, 4, 1, 96, True, None),
    (3, 650, 8, 4, 128, True, None),
    (1, 545, 8, 1, 256, True, None),
    (1, 300, 8, 2, 80, True, 5),         # window 5
    (1, 200, 4, 4, 256, True, 20),       # window 20 over 32-key tiles
    (1, 150, 4, 1, 64, False, 3)]        # window 3, not causal


@pytest.mark.parametrize("b,s,h,kvh,hd,causal,window", _FLASH_F32)
def test_flash_attention_f32_kernel_matches_plain_and_repeats(
        cuda, b, s, h, kvh, hd, causal, window):
    g = torch.Generator(device=cuda).manual_seed(s + h + hd)
    q, k, v = (torch.randn(b, s, n, hd, device=cuda, generator=g)
               for n in (h, kvh, kvh))
    before = cuda_fa.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert cuda_fa.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(
        got, ref.flash_attention(q, k, v, causal=causal, window=window),
        **ATTN_TOL[torch.float32])
    # a second call gives the same bits
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal,
                                           window=window), got)


# (b, s, h, kvh, hd, causal, window, prefix): K1 at every head dim, the
# causal mask, windows (shorter than a key tile, and danube's 4096 at S =
# 4128), the prefix (inside and past a tile, under a window, at hd 256),
# full attention, groups 1, 2, 4, 12 and 16, ragged S; then at each of
# head dims 64, 80 and 128 (bf16 at 80 and 128 on the wgmma kernels' 64-key
# dQ and 128-key dK / dV tiles, at 64 on mma.sync): the causal mask with
# groups of 1 at an S no multiple of 64, a window shorter than a tile with
# groups of 8, danube's window at S = 4128, a prefix inside a tile (group
# 12) and one past it under a window (group 16), full attention
_FLASH_BWD = [
    (2, 200, 4, 4, 32, True, None, 0),
    (1, 300, 8, 2, 64, True, 40, 0),
    (2, 333, 8, 2, 80, True, None, 0),
    (1, 257, 8, 2, 96, True, None, 100),
    (1, 190, 12, 1, 128, True, 33, 70),
    (1, 545, 8, 1, 256, True, None, 256),
    (1, 150, 8, 4, 80, False, None, 0),
    (1, 97, 4, 4, 64, False, 9, 0),
    (1, 512, 64, 4, 128, True, None, 0),
    (1, 4128, 8, 2, 80, True, 4096, 0)]
_FLASH_BWD += [case for case in (
    (b, s, h, kvh, hd, causal, window, prefix) for hd in (64, 80, 128)
    for b, s, h, kvh, causal, window, prefix in [
        (2, 333, 4, 4, True, None, 0),
        (1, 300, 16, 2, True, 40, 0),
        (1, 4128, 8, 2, True, 4096, 0),
        (1, 190, 12, 1, True, None, 70),
        (1, 257, 16, 1, True, 33, 200),
        (1, 150, 16, 2, False, None, 0)]) if case not in _FLASH_BWD]


@pytest.mark.parametrize(
    "dtype,b,s,h,kvh,hd,causal,window,prefix",
    [(dt, *c) for dt in (torch.float32, torch.bfloat16) for c in _FLASH_BWD])
def test_flash_attention_bwd_matches_plain(cuda, dtype, b, s, h, kvh, hd,
                                           causal, window, prefix):
    """K1 through the autograd Function against torch.autograd through
    ref.flash_attention on the same card tensors: f32 at 2e-4; bf16
    within flash_attention_bwd_bf16_bound, derived from the rounding
    of the inputs and outputs.  The forward with the row log-sum-exp gives
    flash_attention_fwd's out bit for bit, and its lse is ref's.  The
    launch is counted under the route bwd_kernel_of names."""
    g = torch.Generator(device=cuda).manual_seed(s + h + hd + prefix)
    q, k, v, dout = (torch.randn(b, s, n, hd, device=cuda, generator=g
                                 ).to(dtype) for n in (h, kvh, kvh, h))
    opts = dict(causal=causal, window=window, prefix_len=prefix)
    out, lse = cuda_fa.flash_attention_fwd_lse(q, k, v, **opts)
    assert torch.equal(out, cuda_fa.flash_attention(q, k, v, **opts))
    torch.testing.assert_close(lse, ref.flash_attention_lse(q, k, v,
                                                            **opts)[1],
                               rtol=2e-4, atol=2e-4)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(cuda_fa.LAUNCHES)
    route = cuda_fa.bwd_kernel_of(dtype, hd)
    routed = cuda_fa.BY_KERNEL["flash_attention_bwd"][route]
    ops.flash_attention(*leaves, **opts).backward(dout)
    assert cuda_fa.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    assert cuda_fa.BY_KERNEL["flash_attention_bwd"][route] == routed + 1
    got = [x.grad for x in leaves]
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref.flash_attention(*plain, **opts).backward(dout)
    want = [x.grad for x in plain]
    if dtype == torch.float32:
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)
    else:
        bounds = flash_attention_bwd_bf16_bound(q, k, v, out, dout, lse,
                                                got, want, **opts)
        for a, w, bound in zip(got, want, bounds):
            assert a.dtype == torch.bfloat16
            assert ((a.float() - w.float()).abs() <= bound).all()
    # deterministic: a second backward gives the same bits
    again = cuda_fa.flash_attention_bwd(q, k, v, out, dout, lse, **opts)
    for a, b_ in zip(again, cuda_fa.flash_attention_bwd(q, k, v, out, dout,
                                                        lse, **opts)):
        assert torch.equal(a, b_)



@pytest.mark.parametrize("hd", [80, 128])
def test_flash_attention_wgmma_launches_from_a_thread_without_a_context(
        cuda, hd):
    """The wgmma routes (the forward with LSE and K1) launch from a thread
    that has made no CUDA call, as autograd's backward thread is when the
    caching allocator serves all its tensors: the tensor-map encoder is a
    driver call and needs a current context, which each launch binds
    (hopper::bind_device).  The thread's results are the main thread's
    bit for bit."""
    import threading
    g = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v, dout = (torch.randn(1, 256, n, hd, device=cuda, generator=g
                                 ).bfloat16() for n in (4, 2, 2, 4))
    opts = dict(causal=True, window=None, prefix_len=0)
    out, lse = cuda_fa.flash_attention_fwd_lse(q, k, v, **opts)
    want = cuda_fa.flash_attention_bwd(q, k, v, out, dout, lse, **opts)
    # the same tensors once more, freed: the thread's come from the cache
    spare = (cuda_fa.flash_attention_fwd_lse(q, k, v, **opts),
             cuda_fa.flash_attention_bwd(q, k, v, out, dout, lse, **opts))
    torch.cuda.synchronize()
    del spare
    got = {}

    def run():
        try:
            got["fwd"] = cuda_fa.flash_attention_fwd_lse(q, k, v, **opts)
            got["bwd"] = cuda_fa.flash_attention_bwd(q, k, v, out, dout,
                                                     lse, **opts)
        except Exception as e:   # raised again on the test's thread
            got["error"] = e

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    if "error" in got:
        raise got["error"]
    torch.cuda.synchronize()
    assert torch.equal(got["fwd"][0], out) and torch.equal(got["fwd"][1], lse)
    for a, b_ in zip(got["bwd"], want):
        assert torch.equal(a, b_)

@pytest.mark.parametrize("b,s,h,kvh,hd,prefix,split", [
    (1, 545, 8, 1, 256, 256, True), (20, 1024, 4, 1, 64, 0, False),
    (4, 1024, 8, 1, 256, 256, True), (2, 1000, 32, 8, 80, 0, True),
    (1, 700, 16, 2, 64, 0, True), (2, 2048, 32, 4, 128, 0, True),
    (1, 545, 16, 1, 128, 200, True), (5, 1024, 16, 8, 80, 0, False)])
def test_flash_attention_bwd_bf16_split_is_taken_on_small_grids(
        cuda, b, s, h, kvh, hd, prefix, split):
    """K1's bf16 dK / dV walk is split where KV x B x key tiles is under
    two blocks an SM (MQA at hd 256, paligemma's prefill, a ragged S; on
    the wgmma kernels' 128-key tiles phase 22's shard shape at hd 128 and
    a prefix past a tile at a ragged S; hd 64 on a small batch) and not
    where the grid is
    large enough: the split and the unsplit kernels both hold the bf16
    bound, and a split call repeats bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(s + hd)
    q, k, v, dout = (torch.randn(b, s, n, hd, device=cuda, generator=g
                                 ).bfloat16() for n in (h, kvh, kvh, h))
    opts = dict(causal=True, window=None, prefix_len=prefix)
    assert (cuda_fa.bwd_splits(q, k, **opts) > 0) == split
    out, lse = cuda_fa.flash_attention_fwd_lse(q, k, v, **opts)
    got = cuda_fa.flash_attention_bwd(q, k, v, out, dout, lse, **opts)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref.flash_attention(*leaves, **opts).backward(dout)
    want = [x.grad for x in leaves]
    bounds = flash_attention_bwd_bf16_bound(q, k, v, out, dout, lse, got,
                                            want, **opts)
    for a, w, bound in zip(got, want, bounds):
        assert ((a.float() - w.float()).abs() <= bound).all()
    for a, b_ in zip(got, cuda_fa.flash_attention_bwd(q, k, v, out, dout,
                                                      lse, **opts)):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("b,s,h,kvh,hd,prefix,split", [
    (2, 512, 8, 1, 256, 256, True), (2, 1024, 32, 8, 80, 0, True),
    (2, 1024, 16, 16, 80, 0, False), (1, 300, 8, 2, 64, 0, True)])
def test_flash_attention_bwd_f32_split_is_taken_on_small_grids(
        cuda, b, s, h, kvh, hd, prefix, split):
    """K1's f32 dK / dV walk is split where KV x B x key tiles (the f32
    kernels' tiles) is under two blocks an SM -- paligemma's f32 cut (MQA
    at hd 256, prefix 256), danube's, a ragged S -- and not at hubert's:
    the split and unsplit kernels hold the plain version within 2e-4, and
    a split call repeats bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(s + hd + 1)
    q, k, v, dout = (torch.randn(b, s, n, hd, device=cuda, generator=g)
                     for n in (h, kvh, kvh, h))
    opts = dict(causal=True, window=None, prefix_len=prefix)
    assert (cuda_fa.bwd_splits(q, k, **opts) > 0) == split
    out, lse = cuda_fa.flash_attention_fwd_lse(q, k, v, **opts)
    got = cuda_fa.flash_attention_bwd(q, k, v, out, dout, lse, **opts)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref.flash_attention(*leaves, **opts).backward(dout)
    for a, w in zip(got, [x.grad for x in leaves]):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)
    for a, b_ in zip(got, cuda_fa.flash_attention_bwd(q, k, v, out, dout,
                                                      lse, **opts)):
        assert torch.equal(a, b_)


def test_train_step_on_card_matches_cpu(cuda):
    """A dense LM (remat "block") takes one train step on the card and on
    the CPU from the same weights: the loss to 1e-4 relative, the gradient
    norm and every updated leaf's moment to 1e-3 of its largest entry (the
    engine's MAIN_TOL), and the forward with LSE twice a layer, the
    backward once."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import synth_batch
    from repro_torch.models import LM
    from repro_torch.train import (TrainState, adamw_init, make_train_step,
                                   require_grad)
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(),
                              remat="block")
    gpu, cpu = LM(cfg, device="cuda"), LM(cfg, device="cpu")
    gp = gpu.init(torch.Generator(device=cuda).manual_seed(0))
    cp = require_grad(_to_cpu(gp))
    require_grad(gp)
    batch = synth_batch(cfg, ShapeConfig("t", 96, 2, "train"), seed=1)
    before = dict(cuda_fa.LAUNCHES)
    states = []
    for model, params in ((gpu, gp), (cpu, cp)):
        step = make_train_step(model, lr=1e-3, warmup=1, total_steps=10)
        states.append(step(TrainState(params, adamw_init(params),
                                      torch.Generator()), batch))
    assert cuda_fa.LAUNCHES["flash_attention_fwd_lse"] == \
        before["flash_attention_fwd_lse"] + 2 * cfg.n_layers
    assert cuda_fa.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + cfg.n_layers
    (gs, gm), (cs, cm) = states
    assert abs(float(gm["loss"]) - float(cm["loss"])) <= \
        1e-4 * abs(float(cm["loss"]))
    assert abs(float(gm["grad_norm"]) - float(cm["grad_norm"])) <= \
        1e-3 * float(cm["grad_norm"])
    stack = [(gs.opt.m, cs.opt.m)]
    while stack:
        a, b = stack.pop()
        for key in b:
            if isinstance(b[key], dict):
                stack.append((a[key], b[key]))
            else:
                scale = float(b[key].abs().max()) or 1.0
                assert float((a[key].cpu() - b[key]).abs().max()) \
                    <= 1e-3 * scale, key


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
    (2, 333, 12, 4, 96, 200),      # head_dim 96, group 3
    (8, 512, 32, 32, 64, 288),     # zamba2's decode: hd 64, group 1
    (2, 288, 32, 32, 64, 288),     # zamba2's f32 cut, a full cache
    (4, 2048, 96, 8, 128, 1900),   # command-r-plus-104b: group 12
    (4, 2048, 40, 40, 128, 2048)])  # qwen1.5-32b: H = KV = 40
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


# (b, L, h, kvh, hd, n_valid): danube's heads at 22g's per-rank shape (a
# quarter of a 4096-slot ring, 8 rows), a rank past every valid slot
# (n_valid 0), qwen1.5-32b's and command-r-plus-104b's heads, head dim 256
# and 64, a ragged L and a group of 16
_DECODE_LSE = [(8, 1024, 32, 8, 80, 1024), (8, 1024, 32, 8, 80, 0),
               (2, 2048, 40, 40, 128, 1500), (2, 512, 96, 8, 128, 1),
               (2, 264, 8, 1, 256, 200), (4, 300, 32, 32, 64, 299),
               (2, 77, 16, 1, 32, 33)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,L,h,kvh,hd,n_valid", _DECODE_LSE)
def test_flash_decode_lse_kernel_matches_plain(cuda, dtype, b, L, h, kvh, hd,
                                               n_valid):
    """The LSE entry (flash_decode_fwd_lse) against ref.flash_decode_lse,
    n_valid read on the card: out in f32 and lse within 2e-4 (the
    output is the merge's quotient unrounded: the scores' products are
    exact in f32, p carries about 24 bits), one launch; n_valid 0 gives
    out 0 and lse -inf; the output rounded to the cache's type is
    flash_decode's bit for bit (the same split pass and merge)."""
    q, k, v = _decode_inputs(cuda, dtype, b, L, h, kvh, hd, L + h + n_valid)
    n = torch.tensor(n_valid, dtype=torch.int32, device=cuda)
    before = cuda_fd.LAUNCHES["flash_decode_lse"]
    out, lse = ops.flash_decode_lse(q, k, v, n)
    assert cuda_fd.LAUNCHES["flash_decode_lse"] == before + 1
    assert out.dtype == lse.dtype == torch.float32
    assert lse.shape == (b, h)
    want, want_lse = ref.flash_decode_lse(q, k, v, n_valid)
    if n_valid == 0:
        assert torch.equal(out, torch.zeros_like(out))
        assert torch.isneginf(lse).all()
        return
    _close(out, want)
    _close(lse, want_lse)
    assert torch.equal(out.to(dtype), ops.flash_decode(q, k, v, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_valid", [1, 1500, 4096])
def test_cache_seq_decode_on_one_rank_matches_whole(cuda, dtype, n_valid):
    """The cache_seq decode's arithmetic on one card: danube's 4096-slot
    ring split in four blocks of slots, as model = 4 splits it, each
    block's LSE entry over clamp(n_valid - lo, 0, 1024) valid slots (0
    past them: at n_valid 1 three blocks hold none), merged by
    dist.sharding.merge_partials in rank order, against flash_decode over
    the whole cache, 2e-4 in f32 and its bf16 rounding in bf16."""
    from repro_torch.dist.sharding import merge_partials
    b, L, h, kvh, hd, ranks = 8, 4096, 32, 8, 80, 4
    q, k, v = _decode_inputs(cuda, dtype, b, L, h, kvh, hd, 7)
    n = torch.tensor(n_valid, dtype=torch.int32, device=cuda)
    span = L // ranks
    outs, lses = [], []
    for r in range(ranks):
        lo = r * span
        o, l = ops.flash_decode_lse(
            q, k[:, lo:lo + span].contiguous(),
            v[:, lo:lo + span].contiguous(), (n - lo).clamp(0, span))
        outs.append(o)
        lses.append(l)
    got = merge_partials(torch.stack(outs), torch.stack(lses))
    want = ops.flash_decode(q, k, v, n)
    torch.testing.assert_close(got.to(dtype), want, **ATTN_TOL[dtype])
    _close(got, ref.flash_decode_lse(q, k, v, n_valid)[0])


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



# (b, s, h, kvh, hd, window, prefix), causal: the prefix-LM term inside,
# at and across the query and key tiles, with and without a window, and
# head dim 256 (paligemma's heads: MQA, a group of 8)
_FLASH_PREFIX = [
    (1, 300, 8, 2, 80, None, 100),      # prefix inside a query tile
    (1, 300, 8, 2, 64, None, 128),      # prefix at a bf16 query tile
    (2, 200, 4, 4, 32, None, 64),       # prefix at a key tile
    (1, 200, 8, 2, 80, 40, 150),        # window shorter than the prefix
    (1, 97, 4, 1, 128, None, 97),       # prefix the whole sequence
    (1, 70, 4, 1, 64, None, 1),         # prefix of one
    (2, 1024, 8, 1, 256, None, 256),    # paligemma's prefill
    (1, 333, 8, 1, 256, None, 0),       # hd 256, causal, ragged
    (1, 150, 8, 1, 256, 50, 70),        # hd 256, windowed prefix
    (1, 512, 64, 4, 128, None, 0),      # qwen3-moe's heads: a group of 16
    (2, 288, 16, 16, 128, None, 0)]     # qwen2-moe's f32 cut, ragged


@pytest.mark.parametrize(
    "dtype,b,s,h,kvh,hd,window,prefix",
    [(dt, *c) for dt in (torch.float32, torch.bfloat16)
     for c in _FLASH_PREFIX])
def test_flash_attention_prefix_and_head_dim_256_match_plain(
        cuda, dtype, b, s, h, kvh, hd, window, prefix):
    g = torch.Generator(device=cuda).manual_seed(s + h + hd + prefix)
    q, k, v = (torch.randn(b, s, n, hd, device=cuda, generator=g
                           ).to(dtype) for n in (h, kvh, kvh))
    before = cuda_fa.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              prefix_len=prefix)
    assert cuda_fa.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(
        got, ref.flash_attention(q, k, v, causal=True, window=window,
                                 prefix_len=prefix), **ATTN_TOL[dtype])
    # full attention takes no prefix
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=False, prefix_len=prefix),
        ref.flash_attention(q, k, v, causal=False), **ATTN_TOL[dtype])


@pytest.mark.parametrize("n_form", ["int", "tensor"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,L,h,kvh,hd,n_valid", [
    (4, 1056, 8, 1, 256, 1056),    # paligemma's decode: MQA, a group of 8
    (4, 1056, 8, 1, 256, 257),
    (2, 300, 16, 4, 256, 1),       # hd 256, four KV heads a block
    (1, 200, 32, 2, 256, 199),     # hd 256, group 16
    (8, 1024, 16, 16, 128, 1000),  # qwen2-moe's decode
    (8, 520, 64, 4, 128, 520)])    # qwen3-moe's decode: a group of 16
def test_flash_decode_head_dim_256_matches_plain(cuda, n_form, dtype, b, L,
                                                 h, kvh, hd, n_valid):
    q, k, v = _decode_inputs(cuda, dtype, b, L, h, kvh, hd, L + h + n_valid)
    n = n_valid if n_form == "int" else torch.tensor(
        n_valid, dtype=torch.int32, device=cuda)
    before = cuda_fd.LAUNCHES["flash_decode"]
    got = ops.flash_decode(q, k, v, n)
    assert cuda_fd.LAUNCHES["flash_decode"] == before + 1
    torch.testing.assert_close(got, ref.flash_decode(q, k, v, n_valid),
                               **ATTN_TOL[dtype])
    assert torch.equal(ops.flash_decode(q, k, v, n), got)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "paligemma-3b",
                                  "hubert-xlarge"])
def test_lm_families_on_card_match_cpu(cuda, arch):
    """moe, vlm and audio LMs on the card against the same LM on the CPU
    (the plain versions), f32, reduced widths: forward logits and router
    loss, and for the decoders prefill and 8 decode steps, to 1e-4."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import synth_batch
    from repro_torch.models import LM
    cfg = get_config(arch).reduced()
    gpu, cpu = LM(cfg, device="cuda"), LM(cfg, device="cpu")
    gp = gpu.init(torch.Generator(device=cuda).manual_seed(0))
    cp = {}
    stack = [(gp, cp)]
    while stack:      # the same weights on the CPU
        src, dst = stack.pop()
        for key, leaf in src.items():
            if isinstance(leaf, dict):
                dst[key] = {}
                stack.append((leaf, dst[key]))
            else:
                dst[key] = leaf.cpu()
    batch = synth_batch(cfg, ShapeConfig("t", 80, 2, "train"), seed=1)
    tol = dict(rtol=1e-4, atol=1e-4)
    launches = cuda_fa.LAUNCHES["flash_attention"]
    (gl, ga), (cl, ca) = gpu.forward(gp, batch), cpu.forward(cp, batch)
    assert cuda_fa.LAUNCHES["flash_attention"] == launches + cfg.n_layers
    torch.testing.assert_close(gl.cpu(), cl, **tol)
    torch.testing.assert_close(ga.cpu(), ca, rtol=1e-5, atol=1e-7)
    if cfg.encoder_only:
        return
    s0 = 80           # the batch's positions, a vlm's image prefix included
    (gl, gc), (cl, cc) = (m.prefill(p, batch, s0 + 8)
                          for m, p in ((gpu, gp), (cpu, cp)))
    torch.testing.assert_close(gl.cpu(), cl, **tol)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 8))
    for i in range(8):
        gl, gc = gpu.decode_step(gp, gc, toks[:, i:i + 1], s0 + i)
        cl, cc = cpu.decode_step(cp, cc, toks[:, i:i + 1], s0 + i)
        torch.testing.assert_close(gl.cpu(), cl, **tol)

@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_recurrent_families_on_card_match_cpu(cuda, arch):
    """hybrid and ssm LMs on the card against the same LM on the CPU, f32,
    reduced widths: forward logits, then the ServeEngine's token-by-token
    prefill and 8 decode steps, to 1e-4; the hybrid's shared block
    launches each flash kernel once a group."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine
    cfg = get_config(arch).reduced()
    gpu, cpu = LM(cfg, device="cuda"), LM(cfg, device="cpu")
    gp = gpu.init(torch.Generator(device=cuda).manual_seed(0))
    cp = _to_cpu(gp)
    groups = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 45))
    tol = dict(rtol=1e-4, atol=1e-4)
    launches = cuda_fa.LAUNCHES["flash_attention"]
    gl, _ = gpu.forward(gp, {"tokens": toks})
    assert cuda_fa.LAUNCHES["flash_attention"] == launches + groups
    torch.testing.assert_close(gl.cpu(), cpu.forward(cp, {"tokens": toks})[0],
                               **tol)
    geng, ceng = (ServeEngine(m, p, batch_size=2, max_seq=64)
                  for m, p in ((gpu, gp), (cpu, cp)))
    launches = cuda_fd.LAUNCHES["flash_decode"]
    torch.testing.assert_close(geng.prefill(toks[:, :37]).cpu(),
                               ceng.prefill(toks[:, :37]), **tol)
    for i in range(37, 45):
        torch.testing.assert_close(geng.decode(toks[:, i]).cpu(),
                                   ceng.decode(toks[:, i]), **tol)
    assert cuda_fd.LAUNCHES["flash_decode"] == launches + 45 * groups


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}

# -- the guard on the card: the out-of-place entry and the select-commit -----

@pytest.mark.parametrize("n,p,k", [(10000, 10000, K) for K in (1, 16, 64, 256)]
                         + [(37, 101, K) for K in (1, 16, 64, 256)]
                         + [(2 ** 20, p, K) for p in (1, 3)
                            for K in (1, 2, 3, 16, 256)]
                         + [(1001, p, K) for p in (1, 3)
                            for K in (1, 41, 2048)])
def test_out_of_place_entry_equals_in_place_bitwise(cuda, n, p, k):
    from repro_torch.kernels import select_commit as cuda_sel  # noqa: F401
    g = torch.Generator(device=cuda).manual_seed(n + k)
    m = torch.randn(n, p, device=cuda, generator=g)
    u = torch.randn(1, n, k, device=cuda, generator=g)
    v = torch.randn(1, p, k, device=cuda, generator=g)
    src = m.clone()
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = cuda_ru.LAUNCHES["rank_update_batched_out"]
    out = ops.rank_update_batched_out(m, u, v, flag)
    assert cuda_ru.LAUNCHES["rank_update_batched_out"] == before + 1
    want = ops.rank_update_batched(src.clone(), u, v)
    torch.cuda.synchronize()
    assert torch.equal(out, want)       # bitwise: the same tiles and order
    assert torch.equal(m, src)          # src untouched
    assert int(flag) == 0


@pytest.mark.parametrize("where", ["u", "v", "m", "overflow", "none"])
def test_out_of_place_flag_iff_nonfinite_stored(cuda, where):
    g = torch.Generator(device=cuda).manual_seed(5)
    for n, p, k in ((300, 260, 8), (300, 260, 96), (37, 101, 3),
                    (3000, 1, 3), (3000, 1, 96), (3000, 3, 8),
                    (2 ** 20, 3, 2)):
        m = torch.randn(n, p, device=cuda, generator=g)
        u = torch.randn(n, k, device=cuda, generator=g)
        v = torch.randn(p, k, device=cuda, generator=g)
        if where == "u":
            u[n // 2, 0] = float("nan")
        elif where == "v":
            v[p - 1, k - 1] = float("inf")
        elif where == "m":
            m[n - 1, p - 1] = float("-inf")
        elif where == "overflow":
            u[:] = 1e38
            v[:] = 10.0
        flag = torch.zeros(1, dtype=torch.int32, device=cuda)
        out = ops.rank_update_batched_out(m, u, v, flag)
        torch.cuda.synchronize()
        assert int(flag) == int(not bool(torch.isfinite(out).all())), \
            (where, n, p, k)
        assert int(flag) == (where != "none")


def test_select_commit_restores_bitwise_and_exits_early_when_clean(cuda):
    from repro_torch.kernels import select_commit as cuda_sel
    g = torch.Generator(device=cuda).manual_seed(6)
    for shape in ((10000, 10000), (37, 101), (5,)):
        old = torch.randn(*shape, device=cuda, generator=g)
        new = torch.randn(*shape, device=cuda, generator=g)
        keep = new.clone()
        clean = torch.zeros(2, dtype=torch.int32, device=cuda)
        before = cuda_sel.LAUNCHES["select_commit"]
        ops.select_commit(clean, old, new)
        torch.cuda.synchronize()
        assert cuda_sel.LAUNCHES["select_commit"] == before + 1
        assert torch.equal(new, keep)            # clean: nothing moved
        failed = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
        ops.select_commit(failed, old, new)
        torch.cuda.synchronize()
        assert torch.equal(new, old)             # failed: old, bitwise
    with pytest.raises(ValueError):
        ops.select_commit(clean, new, new)       # shared storage


@pytest.mark.parametrize("path", ["fused", "snapshot"])
@pytest.mark.parametrize("app", ["ols", "matrix_powers"])
def test_guarded_engine_on_card_matches_cpu(cuda, app, path):
    from repro_torch.guard import ChaosConfig, GuardConfig
    from repro_torch.kernels import select_commit as cuda_sel
    from repro_torch.plan import static_plan
    if app == "ols":
        inputs, _ = OLS.synthesize(96, 24, 2, seed=0)
        mk = lambda **kw: OLS(96, 24, 2, **kw)  # noqa: E731
        shape = (96, 24)
    else:
        inputs = MatrixPowers.synthesize(64, seed=0)
        mk = lambda **kw: MatrixPowers(n=64, k=8, **kw)  # noqa: E731
        shape = (64, 64)
    stream = UpdateStream(n=shape[0], m=shape[1], seed=1)
    ups = [stream.next_update() for _ in range(40)]
    engines = []
    for device in ("cuda", "cpu"):
        eng = mk(device=device, guard=GuardConfig(), chaos=ChaosConfig(
            seed=3, poison_p=0.1, trigger_raise_p=0.1)).engine
        if path == "snapshot":
            eng.set_plan(static_plan(eng, "incremental"))
        eng.initialize(inputs)
        engines.append(eng)
    gpu, cpu = engines
    out0 = cuda_ru.LAUNCHES["rank_update_batched_out"]
    sel0 = cuda_sel.LAUNCHES["select_commit"]
    name = "X" if app == "ols" else "A"
    for eng in engines:
        for u, v in ups[:24]:
            eng.apply_update(name, u, v)
        eng.apply_updates(name, ups[24:32])
        for u, v in ups[32:]:
            eng.enqueue_update(name, u, v)
        eng.flush()
        eng.guard.sync()
    assert cuda_ru.LAUNCHES["rank_update_batched_out"] - out0 == \
        gpu.stats.lowrank_applies > 0
    assert (cuda_sel.LAUNCHES["select_commit"] > sel0) == (path == "fused")
    assert gpu.chaos.poisoned == cpu.chaos.poisoned > 0
    assert gpu.chaos.raises == cpu.chaos.raises > 0
    assert gpu.guard.stats == cpu.guard.stats, \
        [q.reason for q in gpu.guard.quarantine]
    for k, v in cpu.views.items():
        g = gpu.views[k].cpu()
        assert bool(torch.isfinite(g).all()), k
        scale = float(v.abs().max()) or 1.0
        assert float((g - v).abs().max()) / scale <= 1e-5, k


def test_fleet_threads_on_card_match_cpu(cuda):
    """A small mixed fleet on the card (the tenants' default device) under
    four live worker threads: every admitted update committed once, the
    out-of-place entry launched once per apply of every firing, and each
    tenant's committed views equal a CPU engine replaying its commit log
    within f32 parity."""
    from repro_torch.apps.matrix_powers import build_powers_program
    from repro_torch.apps.ols import build_ols_program
    from repro_torch.fleet import FleetConfig, FleetScheduler, TenantSpec
    from repro_torch.guard import GuardConfig
    from repro_torch.serve import build_logit_view_program
    rng = np.random.default_rng(5)
    a = rng.standard_normal((48, 48)).astype(np.float32)
    a *= 0.5 / max(abs(np.linalg.eigvals(a)))
    tenants = {
        "logit0": (build_logit_view_program(64, 32, 96), "W", {
            "H": rng.standard_normal((64, 32)).astype(np.float32),
            "W": rng.standard_normal((96, 32)).astype(np.float32)}),
        "logit1": (build_logit_view_program(64, 32, 96), "W", {
            "H": rng.standard_normal((64, 32)).astype(np.float32),
            "W": rng.standard_normal((96, 32)).astype(np.float32)}),
        "ols": (build_ols_program(96, 24, 2), "X", {
            "X": rng.standard_normal((96, 24)).astype(np.float32),
            "Y": rng.standard_normal((96, 2)).astype(np.float32)}),
        "powers": (build_powers_program(k=4, n=48, model="exp"), "A",
                   {"A": a}),
    }
    fleet = FleetScheduler(FleetConfig(lease_ttl=120.0, workers=4))
    for tid, (prog, name, inputs) in tenants.items():
        fleet.add_tenant(TenantSpec(tid, prog, {name: 1},
                                    max_claim_rank=4), inputs)
    assert all(t.engine.device.type == "cuda" for t in fleet.registry)
    out0 = cuda_ru.LAUNCHES["rank_update_batched_out"]
    logged = {tid: {} for tid in tenants}
    fleet.start()
    try:
        for i in range(48):
            tid = sorted(tenants)[i % 4]
            prog, name, inputs = tenants[tid]
            n, m = inputs[name].shape
            u = (rng.standard_normal((n, 1)) * 0.05).astype(np.float32)
            v = (rng.standard_normal((m, 1)) * 0.05).astype(np.float32)
            assert fleet.submit(tid, name, u, v) == "admitted"
            logged[tid][len(logged[tid]) + 1] = (u, v)
        fleet.drain(timeout_s=300.0)
    finally:
        fleet.stop()
    applies = 0
    for tid, (prog, name, inputs) in tenants.items():
        t = fleet.registry.get(tid)
        assert t.stats.committed_updates == 12 and not t.dirty()
        applies += t.engine.stats.lowrank_applies
        cpu = IncrementalEngine(prog, {name: 1}, guard=GuardConfig(),
                                device="cpu")
        cpu.initialize(inputs)
        for _, lsns in t.commit_log:
            cpu.apply_updates(name, [logged[tid][l] for l in lsns])
        for k, want in cpu.views.items():
            got = t.committed_views[k].cpu()
            scale = float(want.abs().max()) or 1.0
            assert float((got - want).abs().max()) / scale <= 1e-5, (tid, k)
    assert cuda_ru.LAUNCHES["rank_update_batched_out"] - out0 == applies > 0


@pytest.mark.parametrize("order", [2, 3, "mixed"])
def test_deferred_engine_on_card_matches_cpu(cuda, order):
    """A small higher-order engine on the card: banking launches nothing,
    each fold launches the out-of-place entry once per banked input and
    once per low-rank apply of its sweep, and the views equal the CPU
    port's under the same stream within f32 parity, with equal fold
    counters."""
    inputs = MatrixPowers.synthesize(64, seed=0)
    prog = MatrixPowers(n=64, k=8, device="cpu").program
    out = prog.output_names()[0]
    opts = {"order": {out: 2}} if order == "mixed" else {"order": order}
    stream = UpdateStream(n=64, m=64, seed=1)
    batches = [[stream.next_update() for _ in range(4)] for _ in range(12)]
    engines = []
    for device in ("cuda", "cpu"):
        eng = IncrementalEngine(prog, {"A": 1}, fold_window=4, device=device,
                                **opts)
        eng.initialize(inputs)
        engines.append(eng)
    gpu, cpu = engines
    out0 = cuda_ru.LAUNCHES["rank_update_batched_out"]
    in0 = cuda_ru.LAUNCHES["rank_update_batched"]
    for i, ups in enumerate(batches):
        for eng in engines:
            eng.apply_updates("A", ups)
            if i % 5 == 4:
                eng.output()
    for eng in engines:
        eng.flush()
    torch.cuda.synchronize()
    assert cuda_ru.LAUNCHES["rank_update_batched"] == in0   # out of place
    assert cuda_ru.LAUNCHES["rank_update_batched_out"] - out0 == \
        gpu.stats.lowrank_applies > 0
    for k in ("folds", "fold_sweeps", "fold_reevals", "lowrank_applies"):
        assert getattr(gpu.stats, k) == getattr(cpu.stats, k), k
    assert gpu.stats.folds > 0
    for k, v in cpu.views.items():
        g = gpu.views[k].cpu()
        scale = float(v.abs().max()) or 1.0
        assert float((g - v).abs().max()) / scale <= 1e-5, k


def test_deferred_ring_on_card_matches_cpu(cuda):
    """An order-2 fivm ring on the card (its widened carriers made there)
    against the CPU port's, and its ridge model against batch retrain."""
    from repro_torch.data import labeled_stream
    from repro_torch.fivm import RidgeSolver, Ring, RingSpec, batch_ridge
    from repro_torch.plan import TriggerCache
    spec = RingSpec(features=16, targets=1, capacity=4096, model_slots=1,
                    proj_dim=8)
    events = labeled_stream(16, capacity=4096, churn=0.3,
                            seed=2).events(200)
    rings = [Ring(spec, order=2, fold_window=4, device=d,
                  trigger_cache=TriggerCache()) for d in ("cuda", "cpu")]
    for ring in rings:
        ring.apply_events(events)
    gpu, cpu = rings
    assert gpu.stats.folds == cpu.stats.folds > 0
    assert gpu.stats.rowlocal_firings == 0
    for name in ("G", "XY", "s", "c", "XP"):
        want = cpu.view(name)
        got = gpu.view(name)
        scale = max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(got - want).max()) / scale <= 1e-5, name
    B = RidgeSolver(gpu, lam=0.1).coefficients()
    Xl, Yl = gpu.live_data()
    assert np.abs(B - batch_ridge(Xl, Yl, 0.1)).max() < 1e-4


def test_carrier_widening_on_card_equals_host_widening(cuda):
    """A row-local carrier widened on the card (the engine's path when
    it cannot fire the row kernel) equals the host widening bit for bit,
    at a scale where the scattered rows are far apart."""
    from repro_torch.core.factored import RowLocalCarrier
    rng = np.random.default_rng(0)
    n = 2 ** 20
    rows = np.sort(rng.choice(n, 64, replace=False)).astype(np.int32)
    c = RowLocalCarrier(rows, rng.standard_normal((64, 3)).astype(np.float32),
                        rng.standard_normal((256, 3)).astype(np.float32), n)
    for h, d in zip(c.factors(), c.factors(cuda)):
        assert d.device.type == "cuda" and d.dtype == torch.float32
        assert torch.equal(d.cpu(), torch.from_numpy(h))


def _card_state(cuda, seed=0):
    """A reduced danube in bf16 (f32 master, m, v) and its train step on
    the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.train import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(),
                              dtype="bfloat16", remat="block")
    model = LM(cfg, device="cuda")
    state = init_train_state(
        model, torch.Generator(device=cuda).manual_seed(seed))
    return cfg, state, make_train_step(model, lr=1e-3, warmup=1,
                                       total_steps=10)


def _assert_tree_bits(got, want):
    from repro_torch.dist.checkpoint import _leaf_paths
    pg, pw = _leaf_paths(got), _leaf_paths(want)
    assert [p for p, _ in pg] == [p for p, _ in pw]
    for (p, a), (_, b) in zip(pg, pw):
        if isinstance(b, torch.Generator):
            assert a.device == b.device, p
            assert torch.equal(a.get_state(), b.get_state()), p
        else:
            assert a.device == b.device and a.dtype == b.dtype, p
            assert torch.equal(a, b), p


def test_checkpoint_async_save_on_card_survives_the_in_place_step(
        cuda, tmp_path, monkeypatch):
    """A card-side async save, then an in-place train step before the
    writer gathers: the checkpoint restores the pre-step state bit for
    bit (bf16 params, f32 master, m and v, the step, the CUDA
    generator), onto the card, params requiring grad."""
    import threading
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import synth_batch
    from repro_torch.dist import CheckpointManager
    from repro_torch.dist import checkpoint as ckpt
    cfg, state, step = _card_state(cuda)
    batch = synth_batch(cfg, ShapeConfig("t", 64, 2, "train"), seed=1)
    state, _ = step(state, batch)
    before = ckpt._map_tree(lambda _, x: x if isinstance(
        x, torch.Generator) else x.detach().clone(), state)
    before_rng = state.rng.get_state()
    gate, to_host = threading.Event(), ckpt._to_host

    def gated(leaf):
        assert gate.wait(60)
        return to_host(leaf)

    monkeypatch.setattr(ckpt, "_to_host", gated)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, state)
    state, _ = step(state, batch)
    torch.rand(4, generator=state.rng, device=cuda)   # the rng moves too
    assert not torch.equal(state.opt.master["embed"]["table"],
                           before.opt.master["embed"]["table"])
    gate.set()
    template = _card_state(cuda, seed=7)[1]
    restored = mgr.restore(template)
    mgr.close()
    assert torch.equal(restored.rng.get_state(), before_rng)
    _assert_tree_bits(restored._replace(rng=None), before._replace(rng=None))
    assert all(p.requires_grad and p.is_leaf
               for _, p in ckpt._leaf_paths(restored.params))
    step(restored, batch)     # restored params take the next step


def test_checkpoint_round_trips_card_leaves_bit_for_bit(cuda, tmp_path):
    """bf16, f32 and int32 tensors on the card and a CUDA generator,
    saved blocking and restored into a zeroed template: the same bits on
    the card, and the generator draws what the saved one draws next."""
    from repro_torch.dist import CheckpointManager
    g = torch.Generator(device=cuda).manual_seed(3)
    torch.randn(5, generator=g, device=cuda)
    tree = {"b": torch.randn(33, 17, device=cuda).to(torch.bfloat16),
            "f": torch.randn(40, 24, device=cuda),
            "i": torch.tensor(5, dtype=torch.int32, device=cuda),
            "rng": g}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, tree)
    template = {k: torch.zeros_like(v) for k, v in tree.items()
                if k != "rng"}
    template["rng"] = torch.Generator(device=cuda)
    got = mgr.restore(template)
    _assert_tree_bits(got, tree)
    assert torch.equal(torch.rand(9, generator=got["rng"], device=cuda),
                       torch.rand(9, generator=g, device=cuda))


@pytest.mark.parametrize("planned", [False, True], ids=["engine", "planned"])
def test_mesh_engine_on_card_matches_single_device(cuda, tmp_path, planned):
    """IncrementalEngine on a one-rank NCCL mesh: every firing launches the
    rank-k kernel once a low-rank apply on the rank's rows, and the views
    equal the single-device engine's on the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core.iterative import matrix_powers
    from repro_torch.plan import TriggerCache, WorkloadDescriptor
    n = 512
    A = MatrixPowers.synthesize(n, seed=0)
    stream = UpdateStream(n=n, m=n, seed=3)
    ups = [stream.next_update() for _ in range(6)]
    kw = ({"plan": WorkloadDescriptor(batch_size=100000),
           "trigger_cache": TriggerCache()} if planned else {})
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("rows",))
        engines = [IncrementalEngine(matrix_powers(k=8, n=n, model="exp"),
                                     mesh=mesh, **kw),
                   IncrementalEngine(matrix_powers(k=8, n=n, model="exp"),
                                     device=cuda, **kw)]
        for eng in engines:
            eng.initialize(A)
            cuda_ru.reset_launches()
            for u, v in ups[:3]:
                eng.apply_update("A", u, v)
            eng.apply_updates("A", ups[3:])
            torch.cuda.synchronize()
            assert cuda_ru.LAUNCHES["rank_update_batched"] == \
                eng.stats.lowrank_applies > 0
        got = {k: engines[0].output(k) for k in engines[1].views}
        for k, want in engines[1].views.items():
            torch.testing.assert_close(got[k], want, rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()
