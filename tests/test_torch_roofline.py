"""The port's roofline (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``): the analytic model estimates, the ring
formulas and the report's math, on the reference's numbers; the walk of
eager steps (FLOPs, bytes, kernel entries counted by their own
formulas), on the CPU and on meta; and ``make_batch_specs``."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.data.pipeline import make_batch_specs as jax_batch_specs
from repro.roofline import analysis as jax_analysis
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.data import make_batch_specs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rank_update_rows import RowSet
from repro_torch.models.model import LM
from repro_torch.roofline import H100_SXM, RooflineReport, analysis
from repro_torch.roofline import kernel_work
from repro_torch.roofline.op_walk import Walk
from repro_torch.serve.engine import make_serve_step
from repro_torch.train import TrainState, adamw_init, make_train_step
from repro_torch.train.train_step import require_grad

CELLS = [(arch, name) for arch in sorted(ARCHS) for name in sorted(SHAPES)
         if shape_applicable(ARCHS[arch], SHAPES[name])[0]]


# -- the analytic estimates and the report ----------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_estimates_match_the_reference(arch, shape):
    """model_flops_estimate and model_bytes_estimate, every arch at every
    shape it runs, equal the reference's."""
    for fn in ("model_flops_estimate", "model_bytes_estimate"):
        got = getattr(analysis, fn)(ARCHS[arch], SHAPES[shape])
        want = getattr(jax_analysis, fn)(JAX_ARCHS[arch], JAX_SHAPES[shape])
        assert got == want > 0, (fn, got, want)


@pytest.mark.parametrize("kind,result,operand,g", [
    ("all-gather", 0, 100, 4), ("all-reduce", 0, 100, 4),
    ("reduce-scatter", 25, 100, 4), ("all-to-all", 0, 100, 4),
    ("collective-permute", 0, 100, 4), ("all-reduce", 0, 100, 1),
    ("all-gather", 1600, 100, 16), ("all-reduce", 0, 376591360, 16)])
def test_ring_formulas(kind, result, operand, g):
    """The ring formulas, the reference's ``test_ring_formulas`` cases
    and the production mesh's group of 16: the same wire bytes."""
    got = analysis._wire_bytes(kind, result, operand, g)
    assert got == jax_analysis._wire_bytes(kind, result, operand, g)
    if g == 1:
        assert got == 0.0


def test_report_math():
    """The reference's ``test_report_math``, the reference's numbers
    passed to both packages: the same terms, bottleneck and fractions,
    and the same ``to_dict`` keys."""
    kw = dict(arch="a", shape="s", mesh="16x16", chips=256,
              hlo_flops_per_chip=197e12 * 0.1,
              hlo_bytes_per_chip=819e9 * 0.05,
              collective_bytes_per_chip=50e9 * 0.2,
              model_flops=256 * 197e12 * 0.08, model_bytes=0.0,
              peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
    got = RooflineReport(**kw)
    want = jax_analysis.RooflineReport(**kw)
    assert got.bottleneck == want.bottleneck == "collective"
    assert got.t_bound == pytest.approx(0.2)
    assert got.roofline_fraction == pytest.approx(0.4)
    assert got.useful_flops_ratio == pytest.approx(0.8)
    assert got.to_dict() == want.to_dict()


def test_report_defaults_to_the_h100():
    """Without explicit rates the report prices against H100_SXM."""
    r = RooflineReport(arch="a", shape="s", mesh="16x16", chips=1,
                       hlo_flops_per_chip=989e12, hlo_bytes_per_chip=0.0,
                       collective_bytes_per_chip=0.0, model_flops=989e12)
    assert (r.peak_flops, r.hbm_bw, r.ici_bw) == (
        H100_SXM.peak_flops_bf16, H100_SXM.hbm_bandwidth,
        H100_SXM.ici_link_bandwidth * H100_SXM.ici_links)
    assert r.t_compute == pytest.approx(1.0)
    assert r.roofline_fraction == pytest.approx(1.0)


# -- the walk ---------------------------------------------------------------

def test_walk_counts_a_loop_of_matmuls_exactly():
    """A Python loop of 12 matmuls of 256² counts 12·2·256³ FLOPs, a
    nested loop of 3 × 4 likewise: no trip count to recover."""
    a = torch.randn(256, 256)
    with Walk() as walk:
        x = a
        for _ in range(12):
            x = x @ a
    assert walk.flops == 12 * 2 * 256 ** 3
    with Walk() as nested:
        x = a
        for _ in range(3):
            for _ in range(4):
                x = x @ a
    assert nested.flops == walk.flops


def test_walk_counts_bytes_a_storage_once():
    """``a * 2.0 + b`` on 1024² f32: the mul reads a and writes its
    result, the add reads two and writes one: 5 × 4 MiB.  Views move
    nothing; an in-place op reads and writes self."""
    a, b = torch.randn(1024, 1024), torch.randn(1024, 1024)
    with Walk((a, b)) as walk:
        c = a * 2.0 + b
    walk.finish(c)
    assert walk.bytes == 5 * 4 * 2 ** 20
    assert walk.argument_bytes == 2 * 4 * 2 ** 20
    assert walk.output_bytes == 4 * 2 ** 20
    assert walk.peak_bytes == 4 * 4 * 2 ** 20    # a, b, a*2, c
    with Walk() as views:
        a.view(-1)[:10].view(2, 5).T.unsqueeze(0).expand(3, -1, -1)
        a.add_(b)
    assert views.bytes == 3 * 4 * 2 ** 20


def test_group_of_one_puts_nothing_on_the_wire():
    with Walk() as walk:
        walk.collective("all-reduce", "model", 1, 4096, 4096)
        walk.collective("all-gather", "data", 1, 4096, 4096)
    assert walk.collectives.total_wire_bytes == 0.0
    with Walk() as walk:
        walk.collective("all-reduce", "model", 16, 4096, 4096)
    assert walk.collectives.total_wire_bytes == 2 * 15 / 16 * 4096


# -- the kernel entries on meta ----------------------------------------------

def _entry_cases():
    """(entry, its args on a device and generator, its formula)."""
    n, p, k, t = 48, 40, 3, 2

    def dense(dev, g, batched=True):
        m, u, v = (torch.randn(n, p, generator=g),
                   torch.randn(t, n, k, generator=g),
                   torch.randn(t, p, k, generator=g))
        if not batched:
            u, v = u[0], v[0]
        return tuple(x.to(dev) for x in (m, u, v))

    def commit(dev, g):
        m = torch.randn(n, p, generator=g)
        return (torch.zeros(2, dtype=torch.int32).to(dev), m.to(dev),
                (m + 1.0).to(dev))

    def rows(dev, g):
        m, u, v = dense(dev, g, batched=False)
        return m, RowSet.of([3, 7, 11], n), u[:3].contiguous(), v

    def dual(dev, g):
        m, u, v = dense(dev, g, batched=False)
        return m, v, u

    def attn(dev, g, s=24, h=4, kvh=2, hd=32):
        return tuple(torch.randn(2, s, hh, hd, generator=g).to(dev)
                     for hh in (h, kvh, kvh))

    def cache(dev, g):
        return (torch.randn(2, 4, 32, generator=g).to(dev),
                torch.randn(2, 20, 2, 32, generator=g).to(dev),
                torch.randn(2, 20, 2, 32, generator=g).to(dev), 13)

    return [
        ("rank_update", lambda dev, g: dense(dev, g, batched=False),
         kernel_work.rank_update),
        ("rank_update_batched", dense, kernel_work.rank_update),
        ("rank_update_batched_out", dense, kernel_work.rank_update),
        ("select_commit", commit,
         lambda flags, old, new: kernel_work.select_commit(flags)),
        ("rank_update_rows", rows, lambda m, r, b, v:
         kernel_work.rank_update_rows(m, len(r), b, v)),
        ("dual_matmul", dual, kernel_work.dual_matmul),
        ("flash_attention", attn, lambda q, k, v:
         kernel_work.flash_attention(q, k, v, True, None, 0)),
        ("flash_decode", cache, lambda q, kc, vc, n:
         kernel_work.flash_decode(q, kc, n)),
    ]


@pytest.mark.parametrize("case", _entry_cases(), ids=lambda c: c[0])
def test_kernel_entry_on_meta_gives_shapes_and_reports_its_work(case):
    """Each ops entry on meta tensors returns the plain version's shapes
    and dtypes (the CPU's outputs) and, under a walk, reports one call of
    its formula's work, its own ops hidden; the CPU under a walk reports
    the same."""
    name, make, formula = case
    fn = getattr(ops, name)
    cpu_args = make("cpu", torch.Generator().manual_seed(0))
    counts = {}
    for dev in ("cpu", "meta"):
        args = make(dev, torch.Generator().manual_seed(0))
        with Walk(args) as walk:
            out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        counts[dev] = (walk.entry_counts(), walk.ops,
                       [(tuple(o.shape), o.dtype) for o in outs])
        assert all(o.device.type == dev for o in outs)
    assert counts["meta"] == counts["cpu"]
    flops, nbytes = formula(*cpu_args)
    assert counts["meta"][0] == {name: (1, flops, nbytes)}
    assert counts["meta"][1] == 0      # every op of the entry hidden


def test_flash_attention_with_grad_reports_the_lse_forward_and_k1():
    """Under grad, meta (and the CPU under a walk) runs the FlashAttention
    Function: the forward with LSE and K1, 10 B H hd FLOPs a kept pair,
    with the plain gradients' shapes and dtypes."""
    g = torch.Generator().manual_seed(1)
    shapes = ((2, 24, 4, 32), (2, 24, 2, 32), (2, 24, 2, 32))
    cpu = [torch.randn(s, generator=g).requires_grad_(True) for s in shapes]
    got = {}
    for dev in ("cpu", "meta"):
        leaves = [x.detach().to(dev).requires_grad_(True) for x in cpu]
        with Walk(leaves) as walk:
            out = ops.flash_attention(*leaves, window=8, prefix_len=4)
            grads = torch.autograd.grad(out.sum(), leaves)
        got[dev] = (walk.entry_counts(),
                    [(tuple(x.shape), x.dtype) for x in grads])
    assert got["cpu"] == got["meta"]
    pairs = kernel_work.attention_pairs(24, True, 8, 4)
    assert got["meta"][0]["flash_attention_bwd"][:2] == (
        1, 10.0 * 2 * 4 * 32 * pairs)
    assert got["meta"][0]["flash_attention_fwd_lse"][:2] == (
        1, 4.0 * 2 * 4 * 32 * pairs)
    q, k, v = cpu
    want = torch.autograd.grad(ref.flash_attention(
        q, k, v, window=8, prefix_len=4).sum(), cpu)
    assert got["meta"][1] == [(tuple(x.shape), x.dtype) for x in want]


@pytest.mark.parametrize("s,causal,window,prefix", [
    (24, True, None, 0), (24, True, 8, 0), (24, True, 8, 4),
    (24, False, None, 0), (24, False, 5, 0), (30, True, None, 40)])
def test_attention_pairs_count_the_mask(s, causal, window, prefix):
    """The kept pairs of the closed form against the plain mask."""
    pos = torch.arange(s)
    keep = ref.attention_keep(pos, pos, causal=causal, window=window,
                              prefix_len=prefix)
    assert kernel_work.attention_pairs(s, causal, window, prefix) == int(
        keep.sum())


# -- a reduced danube step on the CPU and on meta ---------------------------

def _danube(remat="block"):
    return dataclasses.replace(get_config("h2o-danube-1.8b").reduced(),
                               remat=remat)


def _train_walk(device):
    cfg = _danube()
    model = LM(cfg, device=device)
    params = model.init(torch.Generator().manual_seed(0)
                        if device == "cpu" else None)
    state = TrainState(require_grad(params), adamw_init(params),
                       torch.Generator())
    tokens = torch.randint(1, cfg.vocab - 2, (4, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    step = make_train_step(model, microbatches=2)
    with Walk((state, tokens)) as walk:
        out = step(state, {"tokens": tokens})
    walk.finish(out)
    return walk


def _decode_walk(device):
    cfg = _danube("none")
    model = LM(cfg, device=device)
    params = model.init(torch.Generator().manual_seed(0)
                        if device == "cpu" else None)
    cache = model.init_cache(2, 48)
    token = torch.ones((2, 1), dtype=torch.int32, device=device)
    step = make_serve_step(model)
    with torch.no_grad(), Walk((params, cache, token)) as walk:
        out = step(params, cache, token, 40)
    walk.finish(out)
    return walk


@pytest.mark.parametrize("walk", [_train_walk, _decode_walk],
                         ids=["train", "decode"])
def test_reduced_step_counts_the_same_on_cpu_and_meta(walk):
    """One reduced danube step (2 layers, d_model 128; train: remat
    "block", 2 microbatches, AdamW; decode: one token at position 40)
    walked on the CPU and on meta: the same FLOPs, bytes, argument and
    output bytes and kernel entries, each entry counted by its formula
    (the train step's forward with LSE twice a layer a microbatch, K1
    once; the decode step's flash_decode once a layer)."""
    cpu, meta = walk("cpu"), walk("meta")
    for key in ("flops", "bytes", "entries", "argument_bytes",
                "output_bytes", "collective_wire_bytes"):
        assert cpu.summary()[key] == meta.summary()[key], key
    entries = meta.entry_counts()
    if walk is _train_walk:
        assert entries["flash_attention_fwd_lse"][0] == 2 * 2 * 2
        assert entries["flash_attention_bwd"][0] == 2 * 2
    else:
        assert set(entries) == {"flash_decode"}
        assert entries["flash_decode"][0] == 2
    assert meta.flops > sum(e[1] for e in entries.values()) > 0


# -- the dry-run's batch specs -------------------------------------------------

_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32,
           jnp.bool_: torch.bool}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_make_batch_specs_match_the_reference(arch, shape):
    """Meta tensors with the reference's keys, shapes and dtypes, every
    family at every shape it runs."""
    got = make_batch_specs(ARCHS[arch], SHAPES[shape])
    want = jax_batch_specs(JAX_ARCHS[arch], JAX_SHAPES[shape])
    assert sorted(got) == sorted(want)
    for key, spec in want.items():
        assert got[key].device.type == "meta"
        assert tuple(got[key].shape) == tuple(spec.shape)
        assert got[key].dtype == _DTYPES[jnp.dtype(spec.dtype).type]
