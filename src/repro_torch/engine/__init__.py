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
