from repro_torch.common.hashing import fnv1a64, splitmix64
from repro_torch.common.util import Timer, stable_unique

__all__ = ["fnv1a64", "splitmix64", "Timer", "stable_unique"]
