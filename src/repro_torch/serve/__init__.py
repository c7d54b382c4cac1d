from repro_torch.serve.base import BackpressureError, ServeBase, ServeStats
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.query import QueryRequest, QueryServeEngine
from repro_torch.serve.scheduler import AdmissionController, ArrivalQueue

__all__ = [
    "AdmissionController",
    "ArrivalQueue",
    "BackpressureError",
    "QueryRequest",
    "QueryServeEngine",
    "Request",
    "ServeBase",
    "ServeEngine",
    "ServeStats",
]
