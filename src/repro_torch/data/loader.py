"""Deterministic, resumable, shard-aware synthetic token pipeline.

Every batch is a pure function of (seed, step, dp_rank), so:
  * restart-at-step-k replays exactly the same stream (checkpoint/restart
    correctness — property-tested);
  * each data-parallel rank draws a disjoint slice without coordination
    (1000-node scalable: no shared queue, no filesystem state);
  * elastic re-scaling: rank count is an argument, not baked state.

A zipfian unigram + shifted-markov structure gives the loss a learnable
signal for the end-to-end train example (not pure noise).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenLoader:
    vocab: int
    batch: int            # per-rank batch
    seq: int
    seed: int = 0
    dp_rank: int = 0
    dp_size: int = 1
    zipf_a: float = 1.3

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.dp_rank)
        ranks = np.arange(1, self.vocab + 1)
        probs = 1.0 / ranks ** self.zipf_a
        probs /= probs.sum()
        base = rng.choice(self.vocab, size=(self.batch, self.seq + 1), p=probs)
        # learnable structure: next token correlates with current
        shift = (base[:, :-1] * 31 + 17) % self.vocab
        mix = rng.random((self.batch, self.seq)) < 0.5
        nxt = np.where(mix, shift, base[:, 1:])
        tokens = base[:, :-1].astype(np.int32)
        labels = nxt.astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
