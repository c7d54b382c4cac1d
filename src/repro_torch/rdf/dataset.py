"""Columnar triple tables and federation containers.

A ``TripleTable`` is a set of (s, p, o) int32 triples stored sorted by
(s, p, o) with a per-predicate secondary index sorted by (p, o, s). This gives
O(log n) pattern scans for the access paths SPARQL BGP evaluation needs:
  (s ? ?), (s p ?), (? p ?), (? p o), (s p o), (? ? o)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.rdf.dictionary import TermDict


@dataclass
class TripleTable:
    s: np.ndarray  # int32, sorted lexicographically by (s, p, o)
    p: np.ndarray
    o: np.ndarray
    # secondary order: permutation sorting by (p, o, s)
    pos_perm: np.ndarray = field(default=None)  # type: ignore[assignment]

    @staticmethod
    def from_triples(s: np.ndarray, p: np.ndarray, o: np.ndarray, dedup: bool = True) -> "TripleTable":
        s = np.asarray(s, dtype=np.int32)
        p = np.asarray(p, dtype=np.int32)
        o = np.asarray(o, dtype=np.int32)
        order = np.lexsort((o, p, s))
        s, p, o = s[order], p[order], o[order]
        if dedup and len(s):
            keep = np.ones(len(s), dtype=bool)
            keep[1:] = (s[1:] != s[:-1]) | (p[1:] != p[:-1]) | (o[1:] != o[:-1])
            s, p, o = s[keep], p[keep], o[keep]
        t = TripleTable(s=s, p=p, o=o)
        t.pos_perm = np.lexsort((t.s, t.o, t.p)).astype(np.int32)
        return t

    def __len__(self) -> int:
        return len(self.s)

    @property
    def n_triples(self) -> int:
        return len(self.s)

    def predicates(self) -> np.ndarray:
        return np.unique(self.p)

    def subjects(self) -> np.ndarray:
        return np.unique(self.s)

    def objects(self) -> np.ndarray:
        return np.unique(self.o)

    # -- pattern scans ------------------------------------------------------
    def scan(self, s: int | None, p: int | None, o: int | None) -> np.ndarray:
        """Return row indices (into the canonical (s,p,o) order) matching the
        pattern; ``None`` means unbound."""
        n = len(self.s)
        if n == 0:
            return np.empty(0, dtype=np.int64)
        if s is not None:
            lo, hi = np.searchsorted(self.s, [s, s + 1])
            idx = np.arange(lo, hi)
            if p is not None:
                sub = self.p[lo:hi]
                l2, h2 = np.searchsorted(sub, [p, p + 1])
                idx = idx[l2:h2]
                if o is not None:
                    sub_o = self.o[idx]
                    idx = idx[sub_o == o]
            elif o is not None:
                idx = idx[self.o[idx] == o]
            return idx
        if p is not None:
            # use (p, o, s) order
            ps = self.p[self.pos_perm]
            lo, hi = np.searchsorted(ps, [p, p + 1])
            sel = self.pos_perm[lo:hi]
            if o is not None:
                os_ = self.o[sel]
                l2, h2 = np.searchsorted(os_, [o, o + 1])
                sel = sel[l2:h2]
            return sel.astype(np.int64)
        if o is not None:
            return np.nonzero(self.o == o)[0]
        return np.arange(n)

    def count(self, s: int | None, p: int | None, o: int | None) -> int:
        return len(self.scan(s, p, o))

    def nbytes(self) -> int:
        return int(self.s.nbytes + self.p.nbytes + self.o.nbytes)


@dataclass
class Source:
    """One federation member ("SPARQL endpoint")."""

    name: str
    table: TripleTable
    sid: int = 0

    def ask(self, s: int | None, p: int | None, o: int | None) -> bool:
        """FedX-style ASK probe (DESIGN.md D4: O(log n) local lookup)."""
        return self.table.count(s, p, o) > 0


@dataclass
class Federation:
    sources: list[Source]
    dictionary: TermDict

    def __post_init__(self) -> None:
        for i, src in enumerate(self.sources):
            src.sid = i

    def __len__(self) -> int:
        return len(self.sources)

    def by_name(self, name: str) -> Source:
        for s in self.sources:
            if s.name == name:
                return s
        raise KeyError(name)

    def total_triples(self) -> int:
        return sum(s.table.n_triples for s in self.sources)
