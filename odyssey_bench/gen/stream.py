"""The request stream: which pool query each request asks.

It is built so that any window holds the same amount of work.  Popularity
is Zipf over the pool's fixed ranking (exponent 0: every query alike, as
FedBench runs its query set), laid out by stride scheduling (every prefix
of the stream holds each query about as often as its weight says) and then
shuffled inside blocks.
"""
from __future__ import annotations

import numpy as np


def zipf_weights(n: int, exponent: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** exponent
    return w / w.sum()


def popularity_sequence(n: int, exponent: float, length: int, block: int,
                        rng: np.random.Generator) -> np.ndarray:
    """``length`` pool indices under Zipf(``exponent``) popularity."""
    w = zipf_weights(n, exponent)
    counts = np.ceil(w * length).astype(np.int64) + 1
    idx = np.repeat(np.arange(n), counts)
    k = np.arange(len(idx)) - np.repeat(np.cumsum(counts) - counts, counts)
    due = (k + 0.5) / w[idx]                 # stride scheduling
    seq = idx[np.lexsort((idx, due))][:length]
    pad = (-len(seq)) % block
    blocks = np.concatenate([seq, np.full(pad, -1)]).reshape(-1, block)
    blocks = rng.permuted(blocks, axis=1).reshape(-1)
    return blocks[blocks >= 0]
