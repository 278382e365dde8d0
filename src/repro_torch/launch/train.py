"""Training driver: data pipeline → train_step → checkpoints → fault
tolerance, on one device or on a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch custom-10m \\
        --steps 20 --ckpt-dir /path/to/ckpt --save-every 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
        --reduced --device cpu --steps 10 --batch 2 --seq 64
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --mesh local --model-parallel 2 \\
        --arch custom-10m --steps 20
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --mesh local --model-parallel 2 \\
        --arch zamba2-1.2b --compression-rank 2 --steps 3

The port of the JAX package's ``launch/train.py``: the same ``[train]``
lines, the same result dict, the same supervised restart loop.  It runs
on the card unless ``--device cpu`` (``train(..., device="cpu")``) is
given; without a card it raises.  The step is the port's eager one,
updating params and optimizer state in place (the reference jits its
step with the state donated).  A restart restores the newest intact
checkpoint and replays from the step it holds, so a resumed run takes the
steps of an uninterrupted one.

``--mesh local`` trains on every rank of the world, ``--model-parallel``
of them a model group (``launch/mesh.py``'s ``make_local_mesh``), under
``use_sharding``: explicit tensor, expert and data parallelism
(``dist/sharding.py``), for every family (the recurrent blocks split by
whole heads), with ``--compression-rank`` compressing each gradient leaf
as the single device compresses the whole leaf.  The world comes from
``torchrun``'s environment (``python -m torch.distributed.run``) or from
``--init-method`` (a ``file://`` store) with ``--world-size`` and
``--rank``.  The backend is
gloo on the CPU; on the card NCCL when every rank has a card of its own,
gloo when ranks share one.  Only rank 0 writes checkpoints (gathered
whole, in the reference's format) and logs, and every rank takes rank
0's supervisor decisions in the same order, restoring the step rank 0
last wrote.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..configs import ModelConfig, ShapeConfig, get_config
from ..data.pipeline import synth_batch
from ..dist.checkpoint import CheckpointCorruptError, CheckpointManager
from ..dist.fault_tolerance import (FaultToleranceConfig,
                                    FaultTolerantController, RunPhase,
                                    TrainingSupervisor)
from ..dist.ivm_shard import mesh_device
from ..dist.sharding import use_sharding
from ..models import LM
from ..train import grad_compression as gc
from ..train.train_step import (init_train_state, make_train_step,
                                train_state_specs)


def custom_100m() -> ModelConfig:
    """The ~100M end-to-end example config (llama-style dense)."""
    return ModelConfig(
        name="custom-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32000, head_dim=64,
        mlp_gated=True, dtype="float32", fsdp=False, remat="none",
        source="example")


def custom_10m() -> ModelConfig:
    """CPU-friendly variant for the checked-in convergence demo."""
    return ModelConfig(
        name="custom-10m", family="dense", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=4, d_ff=768, vocab=8192, head_dim=64,
        mlp_gated=True, dtype="float32", fsdp=False, remat="none",
        source="example")


def resolve_config(args) -> ModelConfig:
    if args.arch == "custom-100m":
        return custom_100m()
    if args.arch == "custom-10m":
        return custom_10m()
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def _new_state(model: LM, seed: int):
    # looked up through the module, so tests can patch init_train_state
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return init_train_state(model, gen)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, seed: int = 0, ckpt_dir: Optional[str] = None,
          save_every: int = 100, compression_rank: int = 0,
          mesh=None, log_every: int = 10, resume: bool = True,
          controller: Optional[FaultTolerantController] = None,
          ft_config: Optional[FaultToleranceConfig] = None,
          chaos=None, device=None) -> Dict:
    """Train ``cfg`` for ``steps`` steps on ``device`` (``None``: the
    card) under the fault-tolerance control plane: every step heartbeats
    the :class:`FaultTolerantController`, and the
    :class:`TrainingSupervisor` owns the loop — on an eviction or
    rejoin it restores from the newest checkpoint and continues, on
    ``HALTED`` it stops.  A healthy single-host run takes exactly the
    same step sequence as the bare loop it replaced.

    ``controller`` injects a pre-built controller (tests drive failures
    through it); by default one is built over one host with
    ``ft_config``.  ``chaos`` (a :class:`repro_torch.guard.ChaosConfig`
    / ``ChaosMonkey``) threads fault injection through the checkpoint
    manager (payload corruption) and the controller (host kills) — the
    chaos-harness entry point for end-to-end recovery drills.

    ``mesh`` (a ``DeviceMesh`` from ``launch/mesh.py``) trains under
    ``use_sharding(mesh)`` on the mesh's device: every rank of the mesh
    calls ``train`` with the same arguments and takes the global batch's
    data rows; only rank 0 logs and writes checkpoints, and each step
    every rank takes rank 0's controller phase.
    """
    placement = contextlib.nullcontext()
    if mesh is not None:
        mdev = mesh_device(mesh)
        if device is not None and torch.device(device).type != mdev.type:
            raise ValueError(f"device {device!r} disagrees with the mesh's "
                             f"{mdev.type!r} ranks")
        device, placement = mdev, use_sharding(mesh)
    with placement:
        return _train(cfg, steps=steps, batch=batch, seq=seq, lr=lr,
                      seed=seed, ckpt_dir=ckpt_dir, save_every=save_every,
                      compression_rank=compression_rank,
                      log_every=log_every, resume=resume,
                      controller=controller, ft_config=ft_config,
                      chaos=chaos, device=device, mesh=mesh)


def _train(cfg: ModelConfig, *, steps, batch, seq, lr, seed, ckpt_dir,
           save_every, compression_rank, log_every, resume, controller,
           ft_config, chaos, device, mesh) -> Dict:
    if chaos is not None:
        from ..guard.chaos import as_monkey
        chaos = as_monkey(chaos)
    model = LM(cfg, device=device)
    shape = ShapeConfig("train", seq, batch, "train")
    state = _new_state(model, seed)
    specs = train_state_specs(model) if mesh is not None else None
    # Q₀ drawn from the seed, the same on every rank (each keeps its block)
    comp = (gc.init_compression(
        state.params, rank=compression_rank,
        generator=torch.Generator(device=model.device).manual_seed(seed),
        specs=None if specs is None else specs.params)
        if compression_rank else None)
    step_fn = make_train_step(model, lr=lr, warmup=min(50, steps // 10 + 1),
                              total_steps=steps, compression=comp)
    lead = mesh is None or dist.get_rank() == 0

    mgr = (CheckpointManager(ckpt_dir, async_save=True, chaos=chaos)
           if ckpt_dir else None)
    start = 0
    # on a mesh only rank 0 writes, and asynchronously: every rank takes
    # the step that latest_step(specs) agrees on after rank 0's writes
    latest = mgr.latest_step(specs) if mgr and resume else None
    if latest is not None:
        state = mgr.restore(state, step=latest, specs=specs)
        # a checksum fallback may have loaded an earlier intact step;
        # resume from what was actually restored, not what was asked for
        start = mgr.last_restored_step
        if lead:
            print(f"[train] resumed from step {start}")

    ctl = controller or FaultTolerantController(
        n_hosts=1, config=ft_config, chaos=chaos)
    if mesh is not None:
        _agree_phases(ctl, mesh)
    supervisor = TrainingSupervisor(ctl, save_every=save_every if mgr else 0)

    # the supervisor owns the loop; the closures own the state
    box = {"state": state, "t_last": time.perf_counter()}
    history: list = []

    def run_step(t: int) -> float:
        t0 = time.perf_counter()
        batch_np = synth_batch(cfg, shape, seed=seed, step=t)
        box["state"], metrics = step_fn(
            box["state"], {k: torch.as_tensor(v, device=model.device)
                           for k, v in batch_np.items()})
        if lead and ((t + 1) % log_every == 0 or t == steps - 1):
            loss = float(metrics["loss"])
            dt = (time.perf_counter() - box["t_last"]) / log_every
            box["t_last"] = time.perf_counter()
            tok_s = batch * seq / dt
            print(f"[train] step {t+1:5d} loss {loss:7.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"{dt*1e3:7.1f} ms/step {tok_s:9.0f} tok/s",
                  flush=True)
            history.append({"step": t + 1, "loss": loss,
                            "ms_per_step": dt * 1e3})
        return time.perf_counter() - t0

    def save(t: int) -> None:
        if mgr:
            mgr.save(t, box["state"], specs=specs)

    def restore() -> int:
        latest = mgr.latest_step(specs) if mgr else None
        if latest is None:
            # nothing to restore from: restart the run from scratch
            box["state"] = _new_state(model, seed)
            return 0
        try:
            box["state"] = mgr.restore(box["state"], step=latest,
                                       specs=specs)
        except CheckpointCorruptError as e:
            if lead:
                print(f"[train] every checkpoint corrupt ({e}); "
                      f"restarting from scratch")
            box["state"] = _new_state(model, seed)
            history[:] = []
            return 0
        # restore() falls back past corrupt checkpoints; replay from the
        # step it actually loaded, not the newest one on disk
        s = mgr.last_restored_step
        # drop log entries from steps the restart will replay, so
        # history/--out never carry duplicate step records
        history[:] = [h for h in history if h["step"] <= s]
        if lead:
            print(f"[train] restart: restored step {s} "
                  f"({len(ctl.alive_hosts())} hosts alive)")
        return s

    try:
        restarts = supervisor.run(steps, run_step, save, restore,
                                  start_step=start)
        if mgr and ctl.phase != RunPhase.HALTED:
            mgr.save(steps, box["state"], blocking=True, specs=specs)
    finally:
        if mgr:
            mgr.close()
    if lead and ctl.phase == RunPhase.HALTED:
        print(f"[train] HALTED: {ctl.events[-1] if ctl.events else ''}")
    return {"history": history,
            "final_loss": history[-1]["loss"] if history else None,
            "restarts": restarts,
            "phase": ctl.phase.value,
            "ft_events": list(ctl.events)}


def _agree_phases(ctl: FaultTolerantController, mesh) -> None:
    """Make every rank of ``mesh`` take rank 0's phase from each
    ``ctl.tick()``: the phase is broadcast along each mesh axis in turn
    from its first coordinate, so that all ranks restart, halt or go on
    together (their supervisors then issue the same collectives)."""
    phases = list(RunPhase)
    tick = ctl.tick
    dev = mesh_device(mesh)

    def agreed() -> RunPhase:
        code = torch.tensor([phases.index(tick())], dtype=torch.int32,
                            device=dev)
        for axis in mesh.mesh_dim_names:
            group = mesh.get_group(axis)
            dist.broadcast(code, src=dist.get_global_rank(group, 0),
                           group=group)
        ctl.phase = phases[int(code.item())]
        return ctl.phase

    ctl.tick = agreed


def _join_world(args):
    """The process group and local mesh of ``--mesh local``: the world
    from ``--init-method`` / ``--world-size`` / ``--rank``, else from
    torchrun's environment; the backend gloo on the CPU, NCCL when every
    rank has a card of its own, gloo when ranks share one."""
    from .mesh import make_local_mesh
    cpu = args.device == "cpu"
    if args.init_method:
        world, rank = args.world_size, args.rank
        kw = dict(init_method=args.init_method, world_size=world, rank=rank)
    else:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        kw = {}
    backend = ("gloo" if cpu or world > torch.cuda.device_count()
               else "nccl")
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, **kw)
    return make_local_mesh(args.model_parallel,
                           device_type="cpu" if cpu else "cuda")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="custom-10m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--compression-rank", type=int, default=0)
    ap.add_argument("--mesh", choices=["none", "local"], default="none",
                    help="local: every rank of the world, data-major")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks of a model group on --mesh local")
    ap.add_argument("--init-method", default=None,
                    help="the world's store (file://...); default: "
                         "torchrun's environment")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--heartbeat-timeout", type=float, default=30.0)
    ap.add_argument("--straggler-factor", type=float, default=0.0,
                    help="evict hosts slower than this × median step time "
                         "(0 disables)")
    ap.add_argument("--min-hosts", type=int, default=1)
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-corrupt-ckpt-p", type=float, default=0.0,
                    help="probability of corrupting each written "
                         "checkpoint payload (recovery drill)")
    ap.add_argument("--chaos-kill-host-p", type=float, default=0.0,
                    help="per-heartbeat probability of killing a host")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cfg = resolve_config(args)
    mesh = None
    if args.mesh == "local":
        mesh = _join_world(args)
    lead = mesh is None or dist.get_rank() == 0
    ft = FaultToleranceConfig(heartbeat_timeout=args.heartbeat_timeout,
                              straggler_factor=args.straggler_factor,
                              min_hosts=args.min_hosts)
    if lead:
        print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
              f"{args.steps} steps, batch {args.batch}×{args.seq}"
              + (f", mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                 if mesh is not None else ""))
    chaos = None
    if args.chaos_corrupt_ckpt_p > 0 or args.chaos_kill_host_p > 0:
        from ..guard.chaos import ChaosConfig
        chaos = ChaosConfig(seed=args.chaos_seed,
                            corrupt_checkpoint_p=args.chaos_corrupt_ckpt_p,
                            kill_host_p=args.chaos_kill_host_p)
    try:
        result = train(cfg, steps=args.steps, batch=args.batch,
                       seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                       save_every=args.save_every,
                       compression_rank=args.compression_rank, mesh=mesh,
                       log_every=args.log_every, ft_config=ft, chaos=chaos,
                       device=args.device)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if args.out and lead:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
