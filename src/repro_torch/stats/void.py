"""VOID-level statistics [2] — the granularity the DP-VOID / SPLENDID
baselines use: dataset totals plus per-predicate triple/subject/object counts.
Coarser than CSs, hence the estimation errors the paper attributes to the
uniformity + independence assumptions.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.rdf.dataset import TripleTable


@dataclass
class VoidStats:
    n_triples: int
    n_subjects: int
    n_objects: int
    preds: np.ndarray          # sorted predicate ids
    pred_triples: np.ndarray   # per predicate
    pred_subjects: np.ndarray
    pred_objects: np.ndarray

    def has_pred(self, p: int) -> bool:
        i = np.searchsorted(self.preds, p)
        return i < len(self.preds) and self.preds[i] == p

    def triples_with_pred(self, p: int) -> int:
        i = np.searchsorted(self.preds, p)
        if i < len(self.preds) and self.preds[i] == p:
            return int(self.pred_triples[i])
        return 0

    def pred_stat(self, p: int) -> tuple[int, int, int]:
        i = np.searchsorted(self.preds, p)
        if i < len(self.preds) and self.preds[i] == p:
            return int(self.pred_triples[i]), int(self.pred_subjects[i]), int(self.pred_objects[i])
        return 0, 0, 0

    def estimate_pattern(self, s: int | None, p: int | None, o: int | None) -> float:
        """Classic VOID selectivity with uniformity assumptions."""
        if p is None:
            base = float(self.n_triples)
            if s is not None:
                base /= max(1, self.n_subjects)
            if o is not None:
                base /= max(1, self.n_objects)
            return base
        t, ns, no = self.pred_stat(p)
        if t == 0:
            return 0.0
        est = float(t)
        if s is not None:
            est /= max(1, ns)
        if o is not None:
            est /= max(1, no)
        return est

    def nbytes(self) -> int:
        return int(self.preds.nbytes + self.pred_triples.nbytes
                   + self.pred_subjects.nbytes + self.pred_objects.nbytes + 24)


def compute_void(table: TripleTable) -> VoidStats:
    preds, inv = np.unique(table.p, return_inverse=True)
    pred_triples = np.bincount(inv, minlength=len(preds))
    pred_subjects = np.zeros(len(preds), np.int64)
    pred_objects = np.zeros(len(preds), np.int64)
    for i in range(len(preds)):
        m = inv == i
        pred_subjects[i] = len(np.unique(table.s[m]))
        pred_objects[i] = len(np.unique(table.o[m]))
    return VoidStats(
        n_triples=table.n_triples,
        n_subjects=len(table.subjects()),
        n_objects=len(table.objects()),
        preds=preds,
        pred_triples=pred_triples.astype(np.int64),
        pred_subjects=pred_subjects,
        pred_objects=pred_objects,
    )
