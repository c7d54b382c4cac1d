"""Deterministic hashing utilities shared by statistics and summaries.

Everything here is pure and reproducible across runs/processes (no PYTHONHASHSEED
dependence) — checkpointable statistics require stable ids.
"""
from __future__ import annotations

import numpy as np

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def fnv1a64(data: bytes) -> int:
    """FNV-1a 64-bit hash of a byte string (used for term-dictionary ids)."""
    h = _FNV_OFFSET
    with np.errstate(over="ignore"):
        for b in data:
            h = np.uint64(h ^ np.uint64(b)) * _FNV_PRIME
    return int(h)


def fnv1a64_np(strings: list[str]) -> np.ndarray:
    """Vectorized-ish FNV-1a over a list of strings -> uint64 array."""
    out = np.empty(len(strings), dtype=np.uint64)
    for i, s in enumerate(strings):
        out[i] = fnv1a64(s.encode("utf-8"))
    return out


def splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer — cheap, high-quality integer mixer.

    Used to hash integer entity ids into summary LSB space. Accepts/returns
    uint64 numpy arrays.
    """
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x += np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def mix_pair(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Order-sensitive hash combine of two uint64 arrays."""
    with np.errstate(over="ignore"):
        return splitmix64(a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) ^ splitmix64(b.astype(np.uint64)))
