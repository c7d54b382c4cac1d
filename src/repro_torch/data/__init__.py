from repro_torch.data.loader import TokenLoader

__all__ = ["TokenLoader"]
