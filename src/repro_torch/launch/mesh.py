"""Mesh construction on ``torch.distributed``.

Functions, not module constants: importing this module touches no
process group.  Each builds a ``torch.distributed.device_mesh.DeviceMesh``
over the initialized world (``torch.distributed.init_process_group``
first, with its address, world size and rank given); every rank of the
world calls it, since a mesh smaller than the world still makes its
groups on every rank.  ``device_type`` is ``"cuda"`` (rank r works on
``cuda:(r % device_count)``; raises without a card) or ``"cpu"``.

Shapes come from :func:`repro_torch.dist.fault_tolerance.plan_mesh`, so
the launch path and the elastic-resize path (a supervisor replanning
after an eviction) never disagree about what a valid mesh looks like.
:func:`make_production_mesh` needs a world of 256 or 512 ranks: the
dry-run's fake world (``launch/dryrun.py``) or a real cluster.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..dist.fault_tolerance import plan_mesh

POD_CHIPS = 256
MODEL_PARALLEL = 16


def _device_mesh(shape: Tuple[int, ...], axes: Sequence[str],
                 device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a \"cuda\" mesh needs a CUDA device; pass "
                           "device_type=\"cpu\" to run on the CPU")
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(multi_pod: bool = False, *,
                         device_type: str = "cuda"):
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks)
    over the first ranks of the world; raises on a smaller world."""
    n = 2 * POD_CHIPS if multi_pod else POD_CHIPS
    shape, axes = plan_mesh(n, MODEL_PARALLEL,
                            multi_pod_size=POD_CHIPS if multi_pod else None)
    return _device_mesh(shape, axes, device_type)


def make_elastic_mesh(n_devices: int, model_parallel: int = MODEL_PARALLEL,
                      multi_pod_size: Optional[int] = None, *,
                      device_type: str = "cuda"):
    """The mesh for however many ranks survived — the supervisor calls
    this after an eviction (e.g. 240 ranks → (15, 16)) — over the first
    ranks of the world."""
    shape, axes = plan_mesh(n_devices, model_parallel,
                            multi_pod_size=multi_pod_size)
    return _device_mesh(shape, axes, device_type)


def make_local_mesh(model_parallel: int = 1, axis_names=("data", "model"),
                    *, device_type: str = "cuda"):
    """Every rank of the world, data-major — used by tests and examples."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 0
    if not n or n % model_parallel:
        raise ValueError(f"{n} ranks % model={model_parallel}")
    return _device_mesh((n // model_parallel, model_parallel), axis_names,
                        device_type)
