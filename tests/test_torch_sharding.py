"""repro_torch.dist.sharding and the models' placement trees against the
JAX package's ``repro.dist.sharding``, in this process (no ranks).

``resolve_spec`` is the reference's rule for rule: on every leaf of all
ten configs' ``param_axes()`` and ``cache_axes()`` at their published
widths, on the reference's ``AbstractMesh`` and a shape-only port mesh
(``MeshShape``), for the production meshes (16, 16) and (2, 16, 16) and
the test meshes (4, 2), (2, 2) and (1, 4), the params also under the
``"fsdp"`` rule.  ``LM.param_axes()``,
``cache_axes()`` and ``opt_state_axes`` are the reference's trees.  The
port's own placement (``LM.param_specs``) departs from the reference
only where a split would cut a head; the tests name those leaves.  On a
one-rank gloo mesh the loss and its gradients are the no-mesh port's bit
for bit.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.dist import sharding as jax_sharding
from repro.models import build_model as jax_build
from repro.train import optimizer as jax_opt
from repro_torch.configs import get_config
from repro_torch.dist import sharding
from repro_torch.dist.sharding import MeshShape, ShardingCtx
from repro_torch.models import LM, params_from_numpy
from repro_torch.train import opt_state_axes, require_grad
from repro_torch.train.optimizer import leaves

MESHES = {(16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model"),
          (4, 2): ("data", "model"),
          (2, 2): ("data", "model"),
          (1, 4): ("data", "model")}
ARCHS = sorted(list_archs())
# the reference's decode shapes (decode_32k, long_500k)
CACHE = {False: (128, 32768), True: (1, 524288)}


def _flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict whose leaves are axes tuples,
    shapes or arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _ctxs(shape, rules=None):
    """The reference's and the port's contexts on ``shape``, under the
    default rules with ``rules`` over them."""
    names = MESHES[shape]
    return (jax_sharding.ShardingCtx(mesh=AbstractMesh(shape, names),
                                     rules={**jax_sharding.DEFAULT_RULES,
                                            **(rules or {})}),
            ShardingCtx(mesh=MeshShape(shape, names),
                        rules={**sharding.DEFAULT_RULES, **(rules or {})}))


# the "fsdp" rule as the reference's dry-run would pass it: over the data
# axis, and over both data axes of a pod mesh
FSDP_RULES = {"fsdp_data": {"fsdp": "data"},
              "fsdp_pod_data": {"fsdp": ("pod", "data")}}


def _with_rules(archs):
    """(arch, rules) cases: each arch under the default rules (its id the
    arch alone), then under each of FSDP_RULES."""
    cases = [(a, None) for a in archs] + [
        (a, r) for r in FSDP_RULES.values() for a in archs]
    ids = list(archs) + [f"{a}-{n}" for n in FSDP_RULES for a in archs]
    return pytest.mark.parametrize("arch,rules", cases, ids=ids)


_SHAPES = {}


def _jax_param_shapes(arch):
    if arch not in _SHAPES:
        model = jax_build(jax_config(arch))
        tree = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        _SHAPES[arch] = _flat(jax.tree.map(lambda s: tuple(s.shape), tree))
    return _SHAPES[arch]


def _specs_equal(axes_tree, jax_shapes, port_shapes, shape, rules=None):
    jctx, pctx = _ctxs(shape, rules)
    axes = _flat(axes_tree)
    assert set(axes) == set(jax_shapes) == set(port_shapes)
    for path, ax in axes.items():
        assert tuple(jax_shapes[path]) == tuple(port_shapes[path]), path
        want = jax_sharding.resolve_spec(ax, jax_shapes[path], jctx)
        got = sharding.resolve_spec(ax, port_shapes[path], pctx)
        assert isinstance(got, tuple)
        assert tuple(got) == tuple(want), (path, got, want)
    return len(axes)


@_with_rules(ARCHS)
def test_param_specs_resolve_as_the_reference(arch, rules):
    """resolve_spec of every param leaf, on the five meshes, equals the
    reference's, under the default rules and under the ``"fsdp"`` rule
    (over data, and over pod and data); the port's shapes (a meta-device
    init) equal the reference's eval_shape."""
    model = LM(get_config(arch), device="cpu")
    port_shapes = _flat(model.param_shapes())
    for shape in MESHES:
        assert _specs_equal(model.param_axes(), _jax_param_shapes(arch),
                            port_shapes, shape, rules) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_resolve_as_the_reference(arch):
    """The same for every leaf of the decode cache's axes, at the
    reference's decode_32k and long_500k shapes (audio has no cache: both
    raise)."""
    cfg = get_config(arch)
    model, jmodel = LM(cfg, device="cpu"), jax_build(jax_config(arch))
    if cfg.encoder_only:
        for m in (model, jmodel):
            with pytest.raises(ValueError):
                m.cache_axes()
        return
    for long_context, (batch, seq) in CACHE.items():
        axes = model.cache_axes(long_context)
        assert axes == jmodel.cache_axes(long_context)
        shapes = _flat(jax.tree.map(lambda s: tuple(s.shape), jax.eval_shape(
            lambda: jmodel.init_cache(batch, seq, long_context))))
        for shape in MESHES:
            _specs_equal(axes, shapes, shapes, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_trees_are_the_reference(arch):
    """param_axes() and cache_axes() are the reference's trees leaf for
    leaf, param_axes() has the keys of the port's params, and
    opt_state_axes is the reference's."""
    cfg = get_config(arch)
    model, jmodel = LM(cfg, device="cpu"), jax_build(jax_config(arch))
    axes = model.param_axes()
    assert axes == jmodel.param_axes()
    meta = LM(cfg, device="meta").init(None)
    assert set(_flat(axes)) == set(_flat(meta))
    assert opt_state_axes(axes) == jax_opt.opt_state_axes(axes)


def _deviations(arch, shape, reduced=False, rules=None):
    """{leaf: (the reference's spec, the port's)} where the port's
    placement departs from resolve_spec."""
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    model = LM(cfg, device="cpu")
    ctx = _ctxs(shape, rules)[1]
    specs = _flat(model.param_specs(ctx))
    shapes = _flat(model.param_shapes())
    axes = _flat(model.param_axes())
    out = {}
    for path, spec in specs.items():
        ref = sharding.resolve_spec(axes[path], shapes[path], ctx)
        if spec != ref:
            out[path] = (ref, spec)
    return out


KV = {"blocks.attn.wk", "blocks.attn.wv"}
ALL_ATTN = KV | {"blocks.attn.wq", "blocks.attn.wo", "blocks.attn.bq",
                 "blocks.attn.bk", "blocks.attn.bv"}
WIDE = ((16, 16), (2, 16, 16))
NARROW = ((4, 2), (2, 2), (1, 4))
MAMBA = {f"{stack}.mixer.{leaf}" for stack in ("mamba_groups", "mamba_tail")
         for leaf in ("in_proj", "conv_w", "conv_b", "norm.scale")}
MLSTM = "mlstm_groups.mixer."
# the recurrent families' own placement, where it departs from the
# reference's, and why (a leaf's name after its block)
RECURRENT_DEPARTURES = {
    "hybrid": {
        # packed: z, x and dt split by whole heads, B and C whole (the
        # reference cuts the packed dimension contiguously)
        "in_proj": "packed", "conv_w": "packed", "conv_b": "packed",
        # split with the heads: the split-width RMSNorm (the reference
        # replicates it)
        "norm.scale": "split by heads"},
    "ssm": {
        "norm.scale": "split by heads",
        # the mLSTM's gates by their rows, the channels' heads: partial
        # products summed over the ranks (the reference splits the
        # columns)
        "w_igate": "rows", "w_fgate": "rows",
        # the sLSTM cell mixes heads in its gates: replicated (the
        # reference splits its recurrent weights by heads)
        "r_gates": "replicated",
        # xlstm's 4 mLSTM heads on model = 16: the head-aligned leaves
        # replicated (the reference cuts 512-column heads into 128)
        "up_l": "replicated", "up_r": "replicated", "conv_w": "replicated",
        "conv_b": "replicated", "down": "replicated"}}
# every leaf, over all ten configs on the five meshes, where the port's
# placement departs from the reference's
DEVIATIONS = {
    # 8 KV heads of 80 / 4 of 128 / 8 of 128 on model = 16
    "h2o-danube-1.8b": {m: KV for m in WIDE},
    "qwen3-moe-235b-a22b": {m: KV for m in WIDE},
    "command-r-plus-104b": {m: KV for m in WIDE},
    # one KV head of 256 on every model axis; 8 query heads on 16
    "paligemma-3b": {**{m: KV for m in ((4, 2), (2, 2), (1, 4))},
                     **{m: KV | {"blocks.attn.wq", "blocks.attn.wo"}
                        for m in WIDE}},
    # 40 and 36 heads on model = 16: the whole attention replicated
    "qwen1.5-32b": {m: ALL_ATTN for m in WIDE},
    "starcoder2-7b": {m: ALL_ATTN for m in WIDE},
    "zamba2-1.2b": {m: MAMBA for m in MESHES},
    "xlstm-350m": {
        **{m: {MLSTM + leaf for leaf in ("w_igate", "w_fgate",
                                         "norm.scale")} | {
            "slstm.cell.r_gates"} for m in NARROW},
        **{m: {MLSTM + leaf for leaf in ("up_l", "up_r", "conv_w",
                                         "conv_b", "down")}
           for m in WIDE}},
}
# the same for the decode cache at decode_32k and long_500k: Mamba2's conv
# window packs x|B|C, its SSM state holds the rank's heads (the reference
# replicates it), the mLSTM's conv window is replicated where its heads
# do not divide the model axis
CACHE_DEVIATIONS = {
    "zamba2-1.2b": {m: {f"{c}.{leaf}" for c in ("mamba", "mamba_tail")
                        for leaf in ("conv", "ssm")} for m in MESHES},
    "xlstm-350m": {m: {"mlstm.conv"} for m in WIDE},
}


@pytest.mark.parametrize("arch,shape", [
    ("h2o-danube-1.8b", (4, 2)), ("qwen3-moe-235b-a22b", (1, 4)),
    ("qwen2-moe-a2.7b", (1, 4))],
    ids=["danube_model2", "qwen3moe_model4", "qwen2moe_model4"])
def test_head_alignment_deviations_reduced(arch, shape):
    """The reduced configs the multi-rank tests run: danube's one KV head
    (32 columns) on model = 2 and qwen3-moe's on model = 4 would be cut by
    the reference's spec; the port replicates them.  qwen2-moe's four KV
    heads split whole on model = 4."""
    dev = _deviations(arch, shape, reduced=True)
    assert set(dev) == (KV if arch != "qwen2-moe-a2.7b" else set()), dev
    for ref, spec in dev.values():
        assert ref == (None, None, "model") and spec == ()


def _without(spec, axes) -> tuple:
    """``spec`` with ``axes`` taken out of it (trailing Nones dropped)."""
    out = [None if e is not None and set(sharding.spec_axes((e,))) <= set(
        axes) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@_with_rules(ARCHS)
def test_head_alignment_deviations_listed(arch, rules):
    """The leaves (``DEVIATIONS``) where the port's placement departs from
    the reference's on the five meshes, under the default rules and
    under the ``"fsdp"`` rule (which the port places as the reference
    does, so the same leaves depart): in the transformer families each
    is an attention projection or bias whose split would cut a head,
    replicated on the model axis instead; in the recurrent families each
    is one of ``RECURRENT_DEPARTURES``."""
    cfg = get_config(arch)
    recurrent = cfg.family in ("hybrid", "ssm")
    hd = cfg.resolved_head_dim
    full = _flat(LM(cfg, device="cpu").param_shapes())
    for shape in MESHES:
        dev = _deviations(arch, shape, rules=rules)
        fsdp = _ctxs(shape, rules)[1].mesh_axes_for("fsdp")
        assert set(dev) == DEVIATIONS.get(arch, {}).get(shape, set()), (
            shape, sorted(dev))
        for path, (ref, spec) in dev.items():
            if recurrent:
                leaf = path.split(".mixer.")[-1].split(".cell.")[-1]
                want = RECURRENT_DEPARTURES[cfg.family][leaf]
                assert (_without(spec, fsdp) == ()) == (
                    want == "replicated"), (path, spec)
                continue
            cut = list(ref).index("model")
            assert (full[path][cut] // hd) % shape[-1], path
            assert spec == _without(ref, ("model",))


def _cuts_no_head(spec, shape, units, size) -> bool:
    """Whether every dimension ``spec`` splits gives each of ``size``
    ranks whole units (a packed dimension: in each part it splits)."""
    for dim, entry in enumerate(spec):
        if isinstance(entry, sharding.Packed):
            parts = [(w, u) for (w, e), u in zip(entry, units[dim]) if e]
        elif entry is not None:
            parts = [(shape[dim], units[dim])]
        else:
            continue
        if any(w % u or (w // u) % size for w, u in parts):
            return False
    return True


@pytest.mark.parametrize("arch", ARCHS)
def test_no_placement_cuts_a_head(arch):
    """On the five meshes every leaf's placement (``LM.param_specs``)
    gives each model rank whole heads of every dimension it splits (the
    units of ``LM.placement``), packed dimensions part by part."""
    model = LM(get_config(arch), device="cpu")
    axes, units = model.placement()
    shapes = _flat(model.param_shapes())
    units = _flat(units)
    for shape in MESHES:
        specs = _flat(model.param_specs(_ctxs(shape)[1]))
        for path, spec in specs.items():
            assert _cuts_no_head(spec, shapes[path], units[path],
                                 shape[-1]), (shape, path, spec)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_recurrent_cache_deviations_listed(arch):
    """The decode cache's leaves (``CACHE_DEVIATIONS``) where the port's
    placement (``LM.cache_specs``) departs from the reference's
    ``cache_axes`` resolved, at decode_32k's and long_500k's shapes."""
    model = LM(get_config(arch), device="cpu")
    for long_context, (batch, seq) in CACHE.items():
        axes = _flat(model.cache_axes(long_context))
        shapes = {k: tuple(v.shape) for k, v in _flat(LM(
            model.cfg, device="meta").init_cache(batch, seq)).items()}
        for shape in MESHES:
            ctx = _ctxs(shape)[1]
            specs = _flat(model.cache_specs(batch, seq, long_context, ctx))
            dev = {p for p, spec in specs.items()
                   if spec != sharding.resolve_spec(axes[p], shapes[p], ctx)}
            assert dev == CACHE_DEVIATIONS[arch].get(shape, set()), (
                long_context, shape, sorted(dev))


def _blocks_round_trip(whole, spec, shape, names):
    """Every model rank's local block of ``whole`` (``MeshShape`` at each
    model coordinate), reassembled: the packed parts with
    ``assemble_packed``, a plain split by concatenation."""
    blocks = [sharding.local_block(whole, spec, ShardingCtx(
        mesh=MeshShape(shape, names, coords={"model": r}),
        rules=sharding.DEFAULT_RULES)) for r in range(shape[-1])]
    out = blocks[0]
    for dim, entry in enumerate(spec):
        if isinstance(entry, sharding.Packed):
            out = sharding.assemble_packed(blocks, dim, entry)
        elif entry is not None:
            out = torch.cat(blocks, dim=dim)
    return blocks, out


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_packed_placement_round_trip(arch):
    """Every param leaf of the family's reduced config, on the five
    meshes: each model rank's block (packed dimensions part by part) has
    the local shape the spec gives, and the blocks reassemble the whole
    leaf exactly; Mamba2's in_proj block is z, x of the rank's heads, B
    and C, dt of its heads."""
    cfg = get_config(arch).reduced()
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    for shape, names in MESHES.items():
        ctx = _ctxs(shape)[1]
        specs = model.param_specs(ctx)
        for path, spec in _flat(specs).items():
            whole = dict(_flat(params))[path]
            blocks, back = _blocks_round_trip(whole, spec, shape, names)
            local = sharding.global_shape(blocks[0].shape, spec, ctx)
            assert local == tuple(whole.shape), (shape, path)
            assert torch.equal(back, whole), (shape, path)
    if arch == "zamba2-1.2b":
        d_inner, n, h = 256, 16, 8
        w = params["mamba_tail"]["mixer"]["in_proj"][0]
        spec = model.param_specs(_ctxs((1, 4))[1])["mamba_tail"]["mixer"][
            "in_proj"]
        blocks, _ = _blocks_round_trip(w[None], spec, (1, 4),
                                       ("data", "model"))
        r1 = blocks[1][0]
        q = d_inner // 4
        assert torch.equal(r1, torch.cat([
            w[:, q:2 * q], w[:, d_inner + q:d_inner + 2 * q],
            w[:, 2 * d_inner:2 * d_inner + 2 * n],
            w[:, 2 * d_inner + 2 * n + h // 4:2 * d_inner + 2 * n
              + 2 * (h // 4)]], dim=1))


def test_local_block_and_axes_helpers():
    """local_block cuts a rank's block (the whole tensor when replicated);
    the spec helpers; shard is the identity."""
    ctx = ShardingCtx(mesh=MeshShape((2, 2), ("data", "model")),
                      rules=sharding.DEFAULT_RULES)
    x = torch.arange(24.0).reshape(4, 6)
    block = sharding.local_block(x, sharding.P(None, "model"), ctx)
    assert torch.equal(block, x[:, :3])
    assert sharding.local_block(x, sharding.P(), ctx) is x
    assert sharding.spec_axes(sharding.P(("pod", "data"), "model")) == (
        "pod", "data", "model")
    assert sharding.shard(x, "batch", None) is x
    assert ctx.batch_axes == ("data",) and ctx.tp == 2
    assert ctx.size(("data", "model")) == 4 and ctx.coord("model") == 0
    mesh, spec = sharding.named_sharding(("vocab", "fsdp"), (512, 128), ctx)
    assert spec == ("model",) and mesh is ctx.mesh
    model = LM(get_config("h2o-danube-1.8b").reduced(), device="cpu")
    placed = sharding.tree_shardings(model.param_axes(),
                                     model.param_shapes(), ctx)
    assert placed["blocks"]["mlp"]["w_in"] == (ctx.mesh,
                                               (None, None, "model"))
    assert placed["final_norm"]["scale"] == (ctx.mesh, ())
    with pytest.raises(ValueError, match="use_sharding"):
        sharding.named_sharding((), None)


@contextlib.contextmanager
def _one_rank(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                         mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-moe-a2.7b"])
def test_one_rank_mesh_loss_and_grads_bit_for_bit(tmp_path, arch):
    """On a one-rank (1, 1) gloo mesh, LM.loss and its gradients equal
    the no-mesh port's bit for bit."""
    cfg = get_config(arch).reduced()
    jparams = jax.tree.map(np.asarray,
                           jax_build(jax_config(arch).reduced()).init(
                               jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16),
                                               dtype=np.int32)
    model = LM(cfg, device="cpu")

    def run():
        params = params_from_numpy(jparams, "cpu")
        if sharding.current_ctx().mesh is not None:
            params = sharding.shard_tree(params, model.param_specs())
        params = require_grad(params)
        loss, _ = model.loss(params, {"tokens": tokens})
        return loss, torch.autograd.grad(loss, leaves(params))

    want_loss, want = run()
    with _one_rank(tmp_path) as mesh, sharding.use_sharding(mesh):
        got_loss, got = run()
    assert torch.equal(got_loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
