from repro_torch.engine.distributed import (
    AlgebraFallbackWarning,
    DistMetrics,
    DistributedEngine,
    DistRelation,
    UnsupportedShapeError,
)
from repro_torch.engine.local import (
    ExecutionMetrics,
    ExecutionResult,
    LocalEngine,
    naive_evaluate,
)
from repro_torch.engine.pipeline import (
    CardObservation,
    PipelineExecution,
    SourceChannel,
    VirtualClock,
    compile_plan,
)

__all__ = [
    "DistributedEngine",
    "DistMetrics",
    "DistRelation",
    "AlgebraFallbackWarning",
    "UnsupportedShapeError",
    "LocalEngine",
    "ExecutionMetrics",
    "ExecutionResult",
    "naive_evaluate",
    "CardObservation",
    "PipelineExecution",
    "SourceChannel",
    "VirtualClock",
    "compile_plan",
]
