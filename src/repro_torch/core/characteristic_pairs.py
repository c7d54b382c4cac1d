"""Characteristic Pairs (paper §3.1 "Arbitrary Queries", after [8, 10]).

A CP ``(C_i, C_j, p)`` counts the links via predicate ``p`` from entities with
CS ``C_i`` to entities with CS ``C_j`` — ``count(C_i, C_j, p)`` is the number
of (subject, object) pairs, i.e. of triples, connecting the two CSs.

Intra-dataset CPs come from a single triple table; *federated* CPs (across
datasets) are produced by ``repro_torch.core.federation`` (Algorithm 1) and share the
same ``CPStats`` container so cardinality estimation (formulas 3/4) is
identical for both.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.characteristic_sets import CSStats
from repro_torch.rdf.dataset import TripleTable


@dataclass
class CPStats:
    """Columnar CP statistics, sorted by (pred, cs1, cs2).

    ``cs1``/``cs2`` index into the CS spaces identified by ``src1``/``src2``
    (dataset ids; equal for intra-dataset CPs).
    """

    pred: np.ndarray    # (n_cp,) int32
    cs1: np.ndarray     # (n_cp,) int32 — subject-side CS
    cs2: np.ndarray     # (n_cp,) int32 — object-side CS
    count: np.ndarray   # (n_cp,) int64 — #links (entity pairs / triples)
    src1: int = 0
    src2: int = 0
    _card_cache: dict = field(default_factory=dict, repr=False)  # memoized formulas

    @property
    def n_cp(self) -> int:
        return len(self.pred)

    def with_pred(self, p: int) -> np.ndarray:
        lo, hi = np.searchsorted(self.pred, [p, p + 1])
        return np.arange(lo, hi)

    def select(self, p: int, rel1: np.ndarray, rel2: np.ndarray) -> np.ndarray:
        """Row indices with predicate ``p``, cs1 ∈ rel1, cs2 ∈ rel2."""
        rows = self.with_pred(p)
        if len(rows) == 0:
            return rows
        m = np.isin(self.cs1[rows], rel1) & np.isin(self.cs2[rows], rel2)
        return rows[m]

    def nbytes(self) -> int:
        return int(self.pred.nbytes + self.cs1.nbytes + self.cs2.nbytes + self.count.nbytes)

    def retag(self, src1: int, src2: int) -> "CPStats":
        """Renumber the source tags (statistics-lifecycle source removal).
        The CS indices and counts are untouched, so the memoized-formula
        cache — keyed only on predicate sets — stays valid."""
        self.src1 = src1
        self.src2 = src2
        return self

    def invalidate_caches(self) -> None:
        self._card_cache.clear()

    @staticmethod
    def from_rows(pred: np.ndarray, cs1: np.ndarray, cs2: np.ndarray, count: np.ndarray,
                  src1: int = 0, src2: int = 0) -> "CPStats":
        pred = np.asarray(pred, np.int32)
        cs1 = np.asarray(cs1, np.int32)
        cs2 = np.asarray(cs2, np.int32)
        count = np.asarray(count, np.int64)
        order = np.lexsort((cs2, cs1, pred))
        return CPStats(pred[order], cs1[order], cs2[order], count[order], src1, src2)


def compute_characteristic_pairs(table: TripleTable, cs: CSStats, src: int = 0) -> CPStats:
    """Intra-dataset CPs: aggregate triples whose subject *and* object are
    entities (subjects) of the dataset, keyed by (pred, cs(s), cs(o))."""
    c1 = cs.cs_of_entities(table.s)
    c2 = cs.cs_of_entities(table.o)
    ok = (c1 >= 0) & (c2 >= 0)
    if not ok.any():
        e = np.zeros(0, np.int32)
        return CPStats(e, e.copy(), e.copy(), np.zeros(0, np.int64), src, src)
    p = table.p[ok].astype(np.int64)
    a = c1[ok].astype(np.int64)
    b = c2[ok].astype(np.int64)
    n_cs = max(1, cs.n_cs)
    key = (p * n_cs + a) * n_cs + b
    uk, cnt = np.unique(key, return_counts=True)
    b_ = uk % n_cs
    a_ = (uk // n_cs) % n_cs
    p_ = uk // (n_cs * n_cs)
    return CPStats.from_rows(p_, a_, b_, cnt, src, src)
