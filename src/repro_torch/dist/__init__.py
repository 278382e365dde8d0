"""repro_torch.dist — checkpoints and fault tolerance (paper §6's runtime
around a training or serving run).

The port of the JAX package's ``dist/`` without its sharded half:

  :mod:`~repro_torch.dist.checkpoint`       full + LINVIEW factored
                                            incremental checkpoints
                                            (delta = P Qᵀ on disk), in
                                            the reference's format
  :mod:`~repro_torch.dist.fault_tolerance`  heartbeat failure detection,
                                            straggler eviction, elastic
                                            mesh replanning, supervised
                                            restarts

The sharded placement (``sharding``) and the row-sharded trigger firings
(``ivm_shard``) wait for ROADMAP.md Queue 1 item 12b.
"""

from . import checkpoint, fault_tolerance
from .checkpoint import CheckpointCorruptError, CheckpointManager
from .fault_tolerance import (FaultToleranceConfig, FaultTolerantController,
                              RunPhase, TrainingSupervisor, plan_mesh)

__all__ = [
    "checkpoint", "fault_tolerance",
    "CheckpointCorruptError", "CheckpointManager",
    "FaultToleranceConfig", "FaultTolerantController", "RunPhase",
    "TrainingSupervisor", "plan_mesh",
]
