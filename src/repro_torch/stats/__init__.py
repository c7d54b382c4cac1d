from repro_torch.stats.feedback import CardinalityFeedback, SourceDrift
from repro_torch.stats.reduce import reduce_cs
from repro_torch.stats.void import VoidStats, compute_void

__all__ = ["CardinalityFeedback", "SourceDrift", "VoidStats", "compute_void",
           "reduce_cs"]
