from repro_torch.serve.base import BackpressureError, ServeBase, ServeStats
from repro_torch.serve.engine import Request, ServeEngine

__all__ = [
    "BackpressureError",
    "Request",
    "ServeBase",
    "ServeEngine",
    "ServeStats",
]
