"""repro_torch.dist — the distributed runtime (paper §6, Data
Partitioning).

LINVIEW's parallelization argument: a factored trigger is a chain of
(big × skinny) products, so row-sharding the big views distributes every
trigger firing with only O(n·k) factor traffic, while re-evaluation moves
whole O(n²) matrices.  The port of the JAX package's ``dist/``, on
``torch.distributed``:

  :mod:`~repro_torch.dist.sharding`         the models' placement: the
                                            reference's logical-axis
                                            rules and ``resolve_spec``,
                                            each rank's local blocks, the
                                            collectives of explicit SPMD
                                            (tensor, expert and data
                                            parallelism)
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
"""

from . import checkpoint, fault_tolerance, ivm_shard, sharding
from .checkpoint import CheckpointCorruptError, CheckpointManager
from .fault_tolerance import (FaultToleranceConfig, FaultTolerantController,
                              RunPhase, TrainingSupervisor, plan_mesh)
from .ivm_shard import (build_distributed_planned_trigger,
                        build_distributed_trigger, distributed_reeval_matmul,
                        gather_views, shard_views)
from .sharding import (ShardingCtx, current_ctx, named_sharding, resolve_spec,
                       shard, tree_shardings, use_sharding)

__all__ = [
    "sharding", "ivm_shard", "checkpoint", "fault_tolerance",
    "ShardingCtx", "current_ctx", "named_sharding", "resolve_spec",
    "shard", "tree_shardings", "use_sharding",
    "build_distributed_planned_trigger", "build_distributed_trigger",
    "distributed_reeval_matmul", "gather_views", "shard_views",
    "CheckpointCorruptError", "CheckpointManager",
    "FaultToleranceConfig", "FaultTolerantController", "RunPhase",
    "TrainingSupervisor", "plan_mesh",
]
