from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Timer:
    """Accumulating wall-clock timer: ``with timer: ...``; ``timer.total_s``."""

    total_s: float = 0.0
    count: int = 0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.total_s += time.perf_counter() - self._t0
        self.count += 1

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.total_s / max(1, self.count)


def stable_unique(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """np.unique returning (unique_sorted, inverse) with int32 inverse."""
    uniq, inv = np.unique(values, return_inverse=True)
    return uniq, inv.astype(np.int32)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()
