"""LINVIEW core on PyTorch: incremental view maintenance for
linear-algebra programs.

Public API:

    from repro_torch.core import (
        Program, dim, var, matmul, add, transpose, inverse,
        compile_program, IncrementalEngine, ReevalEngine,
    )
"""

from .expr import (Dim, Expr, ShapeError, Var, add, const, identity, inverse,
                   matmul, scale, sub, transpose, var, zero)
from .program import Program, Statement, dim
from .factored import (DeltaCarrier, DeltaRep, DenseDelta, HStack, LowRank,
                       LowRankCarrier, NoOpCarrier, RowLocalCarrier,
                       as_carrier, detect_row_local, pad_factors_to_rank,
                       recompress_factors, row_delta_carrier, stack_carriers,
                       stack_update_arrays)
from .delta import DeltaEnv, derive, derive_delta, IncrementalInverseError
from .compiler import (Assign, CompiledProgram, DeltaView, Trigger,
                       ViewUpdate, batch_bucket, compile_batched_trigger,
                       compile_delta_trigger, compile_program,
                       delta_view_name, extract_inverse_views)
from .codegen import (build_evaluator, build_rowlocal_trigger_fn,
                      build_trigger_fn, compact_chain_names, evaluate)
from .runtime import EngineStats, IncrementalEngine, ReevalEngine, max_abs_diff
from .cost import (Cost, batch_crossover_rank, batched_apply_cost,
                   batched_strategy, expr_cost, lowrank_cost,
                   recompress_cost)
from . import iterative, sherman_morrison

__all__ = [
    "Dim", "Expr", "ShapeError", "Var", "add", "const", "identity",
    "inverse", "matmul", "scale", "sub", "transpose", "var", "zero",
    "Program", "Statement", "dim",
    "DeltaRep", "DenseDelta", "HStack", "LowRank",
    "pad_factors_to_rank", "recompress_factors", "stack_update_arrays",
    "DeltaCarrier", "LowRankCarrier", "RowLocalCarrier", "NoOpCarrier",
    "as_carrier", "detect_row_local", "row_delta_carrier", "stack_carriers",
    "DeltaEnv", "derive", "derive_delta", "IncrementalInverseError",
    "Assign", "CompiledProgram", "DeltaView", "Trigger", "ViewUpdate",
    "batch_bucket", "compile_batched_trigger", "compile_delta_trigger",
    "compile_program", "delta_view_name", "extract_inverse_views",
    "build_evaluator", "build_rowlocal_trigger_fn", "build_trigger_fn",
    "compact_chain_names", "evaluate",
    "EngineStats", "IncrementalEngine", "ReevalEngine", "max_abs_diff",
    "Cost", "batch_crossover_rank", "batched_apply_cost", "batched_strategy",
    "expr_cost", "lowrank_cost", "recompress_cost",
    "iterative", "sherman_morrison",
]
