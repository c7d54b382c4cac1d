from repro_torch.stats.feedback import CardinalityFeedback, SourceDrift
from repro_torch.stats.reduce import reduce_cs

__all__ = ["CardinalityFeedback", "SourceDrift", "reduce_cs"]
