"""Serving entry point: batched generation with the port's ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
        --batch 8 --prompt-len 4096 --max-new 32 [--logit-view]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
        --reduced --device cpu --batch 2 --prompt-len 16 --max-new 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
        --batch 8 --prompt-len 1024 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --batch 8 --prompt-len 256 --max-new 32       # or xlstm-350m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch custom-10m \
        --device cpu --fleet 2 --fleet-workers 2
    PYTHONPATH=src python -m repro_torch.launch.serve --fivm \
        [--device cpu] [--fivm-features 256 --fivm-capacity 1048576]
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve --mesh local --model-parallel 4 \
        --arch h2o-danube-1.8b --rules '{"cache_seq": "model"}'

Runs on the card unless ``--device cpu`` is given.  Weights are random,
drawn from ``--seed``.  The recurrent families (zamba2, xlstm) prefill
token by token.  ``--logit-view`` attaches an incremental lm_head
logit view over a random corpus, hot-swaps a burst of rank-1 deltas
through it and prints its health.  ``--fleet N`` serves N logit-view
tenants over the model's lm_head widths through
:mod:`repro_torch.fleet` (live lease-claimed refresh workers, admission
control, a shared trigger cache) and prints each view's health and the
fleet's stats.  ``--fivm`` serves the learning views
(:mod:`repro_torch.fivm`) instead of generating tokens: a gram ring at
``order=2`` (ingest banks, each read folds and re-solves), then the same
ring shape as a fleet tenant with its staleness against the SLO.

``--mesh local`` serves on every rank of the world, ``--model-parallel``
of them a model group, as ``launch/train.py`` joins it (torchrun's
environment, or ``--init-method`` with ``--world-size`` and ``--rank``):
each rank holds its blocks of the params and of the decode cache, under
``--rules`` (a JSON object over the default placement rules, e.g.
``{"cache_seq": "model"}``, which splits the cache's slots over the
model axis), and rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import ModelConfig, get_config
from ..models import LM
from ..serve import IncrementalLogitView, ServeEngine
from .train import custom_10m, custom_100m

# the JAX package's example configs (its launch/train.py)
EXAMPLES = {"custom-10m": custom_10m(), "custom-100m": custom_100m()}


def resolve_config(args) -> ModelConfig:
    if args.arch in EXAMPLES:
        return EXAMPLES[args.arch]
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def serve_fleet(eng: ServeEngine, cfg: ModelConfig, args, rng) -> None:
    """N tenants, each its own corpus logit view over lm_head, refreshed
    by a shared pool of live lease-coordinated workers; same-shape
    tenants share built triggers through the fleet's cache."""
    from ..fleet import FleetConfig, FleetScheduler, TenantSpec
    from ..serve import build_logit_view_program
    d, p = cfg.d_model, cfg.vocab
    dev = eng.model.device
    fleet = FleetScheduler(FleetConfig(lease_ttl=0.5,
                                       workers=args.fleet_workers))
    tenant_of = {}
    for i in range(args.fleet):
        tid = f"tenant-{i}"
        inputs = {
            "H": rng.standard_normal((args.corpus, d)).astype(np.float32),
            "W": rng.standard_normal((p, d)).astype(np.float32) * .02,
        }
        fleet.add_tenant(TenantSpec(
            tid, build_logit_view_program(args.corpus, d, p), {"W": 1},
            slo_s=0.25, quota_rate=200.0, quota_burst=32,
            engine_opts={"device": dev}), inputs)
        tenant_of[f"lm_head.{i}"] = tid
    eng.attach_fleet(fleet, tenant_of)
    fleet.start()
    try:
        for _ in range(8):
            for path in tenant_of:
                u = rng.standard_normal((p, 1)).astype(np.float32) * .01
                v = rng.standard_normal((d, 1)).astype(np.float32) * .01
                eng.hot_swap(path, u, v)
        eng.flush_views()
        for path in tenant_of:
            logits = eng.view_logits(path)
            print(f"[serve] fleet view {path}: {tuple(logits.shape)} "
                  f"health={eng.view_health()[path]}")
        print(f"[serve] fleet stats: {fleet.fleet_stats()}")
    finally:
        fleet.stop()


def serve_fivm(args) -> None:
    """Models-as-views serving (docs/fivm.md): data arrival and model
    refresh are decoupled — ingest banks factored deltas into the ring's
    deferred windows, each read folds and re-solves — and the same ring
    shape runs as a fleet tenant so staleness is accounted against the
    tenant SLO."""
    from ..apps import get_app
    from ..data import labeled_stream
    from ..fivm.registry import RingRegistry, submit_event
    from ..fleet import FleetConfig, FleetScheduler

    app = get_app("fivm_learning")(
        features=args.fivm_features, capacity=args.fivm_capacity,
        order=2, churn=0.3, seed=args.seed, device=args.device)
    app.ingest(8)
    app.refresh()          # first build and solve outside the ledger
    out = app.serve_demo(bursts=args.fivm_bursts,
                         burst_size=args.fivm_burst_size)
    print(f"[serve] fivm decoupled ring on {app.device}: {out['events']} "
          f"events ({out['live']:.0f} live), "
          f"ingest {out['ingest_us_per_event']:.0f} us/event, "
          f"reads {[f'{t:.1f}ms' for t in out['read_ms']]}, "
          f"folds={out['folds']} strategies={out['strategies']}")

    # fleet-hosted ring tenant: same carriers, lease-claimed refresh, SLO
    # staleness accounting
    spec = app.spec
    fleet = FleetScheduler(FleetConfig(lease_ttl=0.5,
                                       workers=args.fleet_workers))
    reg = RingRegistry()
    reg.add_fleet_tenant(fleet, spec, "fivm-ring", slo_s=0.5,
                         engine_opts={"device": app.device})
    stream = labeled_stream(spec.features, targets=spec.targets,
                            capacity=spec.capacity, churn=0.3,
                            seed=args.seed + 1)
    fleet.start()
    try:
        t0 = time.perf_counter()
        n = args.fivm_bursts * args.fivm_burst_size
        for ev in stream.events(n):
            submit_event(fleet, "fivm-ring", spec.capacity, ev)
        fleet.drain(["fivm-ring"])
        dt = time.perf_counter() - t0
        G = fleet.read_views("fivm-ring")["G"]
        health = fleet.tenant_health()[0]
        print(f"[serve] fivm fleet tenant: {n} events in {dt:.2f}s "
              f"({3 * n / dt:.0f} firings/s), G={tuple(G.shape)}, "
              f"staleness={health['staleness_s']:.3f}s "
              f"(slo={health['slo_s']}s) health={health}")
    finally:
        fleet.stop()


def serve_mesh(args) -> np.ndarray:
    """``--mesh local``: the same generation on a mesh of the world's
    ranks, each holding its blocks of the params and the cache; the
    tokens, the same on every rank."""
    import torch.distributed as dist
    from ..dist.ivm_shard import mesh_device
    from ..dist.sharding import shard_tree, use_sharding
    from .train import _join_world
    mesh = _join_world(args)
    try:
        cfg = resolve_config(args)
        model = LM(cfg, device=mesh_device(mesh))
        rules = json.loads(args.rules) if args.rules else None
        max_seq = args.max_seq or args.prompt_len + args.max_new
        rng = np.random.default_rng(args.seed)
        prompts = rng.integers(1, cfg.vocab, size=(args.batch,
                                                   args.prompt_len)
                               ).astype(np.int32)
        with use_sharding(mesh, rules):
            gen = torch.Generator(device=model.device).manual_seed(
                args.seed)
            params = shard_tree(model.init(gen), model.param_specs())
            eng = ServeEngine(model, params, batch_size=args.batch,
                              max_seq=max_seq, temperature=args.temperature,
                              seed=args.seed)
            t0 = time.perf_counter()
            with torch.no_grad():
                out = eng.generate(prompts, max_new=args.max_new)
            dt = time.perf_counter() - t0
        if dist.get_rank() == 0:
            print(f"[serve] {cfg.name} on mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, rules "
                  f"{rules}: generated {out.shape} in {dt:.2f}s "
                  f"({out.size / dt:.1f} tok/s)")
            print(out[:, :12])
    finally:
        dist.destroy_process_group()
    return out


def main(argv: Optional[Sequence[str]] = None) -> Optional[np.ndarray]:
    """The CLI; returns the generated tokens (None for ``--fivm``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="custom-10m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=None,
                    help="cache length (default: prompt-len + max-new)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--logit-view", action="store_true",
                    help="attach an incremental lm_head logit view, drive "
                         "hot-swap deltas through it, and print its health")
    ap.add_argument("--corpus", type=int, default=64,
                    help="--logit-view / --fleet corpus size (cached "
                         "hidden rows)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve N fleet tenants (one logit view each) "
                         "through repro_torch.fleet: lease-claimed refresh "
                         "workers, admission control, shared trigger "
                         "cache; prints fleet health + stats")
    ap.add_argument("--fleet-workers", type=int, default=2)
    ap.add_argument("--fivm", action="store_true",
                    help="serve the repro_torch.fivm learning views "
                         "instead of token generation: a maintained gram "
                         "ring in decoupled (order=2, bank-on-ingest, "
                         "fold-on-read) mode, plus a fleet-hosted ring "
                         "tenant with SLO staleness accounting")
    ap.add_argument("--fivm-features", type=int, default=24)
    ap.add_argument("--fivm-capacity", type=int, default=256)
    ap.add_argument("--fivm-bursts", type=int, default=8)
    ap.add_argument("--fivm-burst-size", type=int, default=48)
    ap.add_argument("--mesh", choices=["none", "local"], default="none",
                    help="local: every rank of the world, data-major")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks of a model group on --mesh local")
    ap.add_argument("--rules", default=None,
                    help="placement rules over the defaults on --mesh "
                         "local, JSON, e.g. '{\"cache_seq\": \"model\"}'")
    ap.add_argument("--init-method", default=None,
                    help="the world's store (file://...); default: "
                         "torchrun's environment")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args(argv)

    if args.fivm:
        serve_fivm(args)
        return
    if args.mesh == "local":
        if args.logit_view or args.fleet:
            raise SystemExit("--logit-view and --fleet serve on one device")
        return serve_mesh(args)

    cfg = resolve_config(args)
    model = LM(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    max_seq = args.max_seq or args.prompt_len + args.max_new
    eng = ServeEngine(model, params, batch_size=args.batch, max_seq=max_seq,
                      temperature=args.temperature, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    if args.logit_view:
        d = cfg.d_model
        hidden = rng.standard_normal((args.corpus, d)).astype(np.float32)
        head = rng.standard_normal((cfg.vocab, d)).astype(np.float32) * 0.02
        eng.attach_logit_view("lm_head", IncrementalLogitView(
            hidden, head, device=model.device))
        for _ in range(8):
            u = rng.standard_normal((cfg.vocab, 1)).astype(np.float32) * .01
            v = rng.standard_normal((d, 1)).astype(np.float32) * .01
            eng.hot_swap("lm_head", u, v)
        eng.flush_views()
        logits = eng.view_logits("lm_head")
        print(f"[serve] logit view: {tuple(logits.shape)} "
              f"health={eng.view_health()['lm_head']}")
    if args.fleet > 0:
        serve_fleet(eng, cfg, args, rng)
    prompts = rng.integers(1, cfg.vocab, size=(args.batch, args.prompt_len)
                           ).astype(np.int32)
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=args.max_new)
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name} on {model.device}: generated {out.shape} in "
          f"{dt:.2f}s ({out.size / dt:.1f} tok/s)")
    print(out[:, :12])
    return out


if __name__ == "__main__":
    main()
