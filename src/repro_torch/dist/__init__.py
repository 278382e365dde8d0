"""repro_torch.dist — the distributed runtime (paper §6, Data
Partitioning).

LINVIEW's parallelization argument: a factored trigger is a chain of
(big × skinny) products, so row-sharding the big views distributes every
trigger firing with only O(n·k) factor traffic, while re-evaluation moves
whole O(n²) matrices.  The port of the JAX package's ``dist/``, on
``torch.distributed``:

  :mod:`~repro_torch.dist.ivm_shard`        row-sharded execution of
                                            compiled triggers + the
                                            re-eval baseline, with the
                                            bytes of every collective
  :mod:`~repro_torch.dist.checkpoint`       full + LINVIEW factored
                                            incremental checkpoints
                                            (delta = P Qᵀ on disk), in
                                            the reference's format
  :mod:`~repro_torch.dist.fault_tolerance`  heartbeat failure detection,
                                            straggler eviction, elastic
                                            mesh replanning, supervised
                                            restarts

The models' sharded placement (``sharding``) waits for ROADMAP.md Queue 1
item 12b-ii.
"""

from . import checkpoint, fault_tolerance, ivm_shard
from .checkpoint import CheckpointCorruptError, CheckpointManager
from .fault_tolerance import (FaultToleranceConfig, FaultTolerantController,
                              RunPhase, TrainingSupervisor, plan_mesh)
from .ivm_shard import (build_distributed_planned_trigger,
                        build_distributed_trigger, distributed_reeval_matmul,
                        gather_views, shard_views)

__all__ = [
    "ivm_shard", "checkpoint", "fault_tolerance",
    "build_distributed_planned_trigger", "build_distributed_trigger",
    "distributed_reeval_matmul", "gather_views", "shard_views",
    "CheckpointCorruptError", "CheckpointManager",
    "FaultToleranceConfig", "FaultTolerantController", "RunPhase",
    "TrainingSupervisor", "plan_mesh",
]
