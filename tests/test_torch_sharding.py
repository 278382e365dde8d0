"""repro_torch.dist.sharding and the models' placement trees against the
JAX package's ``repro.dist.sharding``, in this process (no ranks).

``resolve_spec`` is the reference's rule for rule: on every leaf of all
ten configs' ``param_axes()`` and ``cache_axes()`` at their published
widths, on the reference's ``AbstractMesh`` and a shape-only port mesh
(``MeshShape``), for the production meshes (16, 16) and (2, 16, 16) and
the test meshes (4, 2), (2, 2) and (1, 4).  ``LM.param_axes()``,
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


def _ctxs(shape):
    names = MESHES[shape]
    return (jax_sharding.ShardingCtx(mesh=AbstractMesh(shape, names),
                                     rules=jax_sharding.DEFAULT_RULES),
            ShardingCtx(mesh=MeshShape(shape, names),
                        rules=sharding.DEFAULT_RULES))


_SHAPES = {}


def _jax_param_shapes(arch):
    if arch not in _SHAPES:
        model = jax_build(jax_config(arch))
        tree = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        _SHAPES[arch] = _flat(jax.tree.map(lambda s: tuple(s.shape), tree))
    return _SHAPES[arch]


def _specs_equal(axes_tree, jax_shapes, port_shapes, shape):
    jctx, pctx = _ctxs(shape)
    axes = _flat(axes_tree)
    assert set(axes) == set(jax_shapes) == set(port_shapes)
    for path, ax in axes.items():
        assert tuple(jax_shapes[path]) == tuple(port_shapes[path]), path
        want = jax_sharding.resolve_spec(ax, jax_shapes[path], jctx)
        got = sharding.resolve_spec(ax, port_shapes[path], pctx)
        assert isinstance(got, tuple)
        assert tuple(got) == tuple(want), (path, got, want)
    return len(axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_resolve_as_the_reference(arch):
    """resolve_spec of every param leaf, on the five meshes, equals the
    reference's; the port's shapes (a meta-device init) equal the
    reference's eval_shape."""
    model = LM(get_config(arch), device="cpu")
    port_shapes = _flat(model.param_shapes())
    for shape in MESHES:
        assert _specs_equal(model.param_axes(), _jax_param_shapes(arch),
                            port_shapes, shape) > 0


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


def _deviations(arch, shape, reduced=False):
    """{leaf: (the reference's spec, the port's)} where the port's
    placement departs from resolve_spec."""
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    model = LM(cfg, device="cpu")
    ctx = _ctxs(shape)[1]
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
# every leaf, over all ten configs on the five meshes, where the port's
# placement departs from the reference's (the recurrent families are
# refused on model > 1: ROADMAP.md Queue 1 item 12b-iii)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_head_alignment_deviations_listed(arch):
    """The leaves (``DEVIATIONS``) where the port's placement departs from
    the reference's on the five meshes: each is an attention projection
    or bias whose split would cut a head, replicated instead; no
    placement of the port cuts a head."""
    cfg = get_config(arch)
    if cfg.family in ("hybrid", "ssm"):
        with pytest.raises(NotImplementedError, match="item 12b-iii"):
            _deviations(arch, (4, 2))
        return
    hd = cfg.resolved_head_dim
    full = _flat(LM(cfg, device="cpu").param_shapes())
    for shape in MESHES:
        dev = _deviations(arch, shape)
        assert set(dev) == DEVIATIONS.get(arch, {}).get(shape, set()), (
            shape, sorted(dev))
        for path, (ref, spec) in dev.items():
            cut = list(ref).index("model")
            assert (full[path][cut] // hd) % shape[-1], path
            assert spec == ()


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
