from repro_torch.engine.local import (
    ExecutionMetrics,
    ExecutionResult,
    LocalEngine,
    naive_evaluate,
)

__all__ = [
    "LocalEngine",
    "ExecutionMetrics",
    "ExecutionResult",
    "naive_evaluate",
]
