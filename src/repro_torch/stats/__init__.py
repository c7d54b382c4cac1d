from repro_torch.stats.reduce import reduce_cs

__all__ = ["reduce_cs"]
