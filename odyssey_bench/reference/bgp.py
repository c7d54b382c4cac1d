"""A plain evaluator of basic graph patterns over the union of a federation's
triples, and the digest that compares answers.

SPARQL semantics over the union graph: the graph is a set of triples
(duplicates within or across sources count once), a basic graph pattern's
solutions are all mappings of its variables that put every pattern in the
graph, projection keeps duplicates, and ``DISTINCT`` removes them.  numpy
only; nothing of the program is imported.
"""
from __future__ import annotations

import numpy as np

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_GOLD = np.uint64(0x9E3779B97F4A7C15)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser, on uint64 arrays (wrapping)."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        return x ^ (x >> np.uint64(31))


def digest(columns: list) -> tuple:
    """(row count, order-free hash of the rows) of equally long columns:
    equal multisets of rows give equal digests."""
    n = len(columns[0]) if columns else 0
    h = np.zeros(n, np.uint64)
    with np.errstate(over="ignore"):
        for j, col in enumerate(columns):
            c = np.asarray(col).astype(np.int64).astype(np.uint64)
            h = _mix(h ^ (c + _GOLD * np.uint64(j + 1)))
        return n, int(h.sum(dtype=np.uint64))


class Graph:
    """The union of the sources' triples, as a set, indexed by predicate."""

    def __init__(self, s: np.ndarray, p: np.ndarray, o: np.ndarray) -> None:
        order = np.lexsort((o, s, p))
        s, p, o = s[order], p[order], o[order]
        keep = np.ones(len(s), bool)
        keep[1:] = (s[1:] != s[:-1]) | (p[1:] != p[:-1]) | (o[1:] != o[:-1])
        self.s, self.p, self.o = s[keep], p[keep], o[keep]

    def __len__(self) -> int:
        return len(self.s)

    def match(self, pattern) -> dict:
        """Bindings of one triple pattern: variable name -> ids."""
        cols = (self.s, self.p, self.o)
        lo, hi = 0, len(self.s)
        if not isinstance(pattern[1], str):
            lo, hi = np.searchsorted(self.p, [pattern[1], pattern[1] + 1])
        sel = np.ones(hi - lo, bool)
        first: dict[str, int] = {}
        for k, term in enumerate(pattern):
            col = cols[k][lo:hi]
            if isinstance(term, str):
                if term in first:
                    sel &= col == cols[first[term]][lo:hi]
                else:
                    first[term] = k
            else:
                sel &= col == term
        return {v: cols[k][lo:hi][sel] for v, k in first.items()}


def _nrows(rel: dict) -> int:
    return len(next(iter(rel.values())))


def _keys(rel: dict, names: list) -> np.ndarray:
    if len(names) == 1:
        return rel[names[0]].astype(np.int64)
    return np.stack([rel[v] for v in names], 1)


def join(left: dict, right: dict) -> dict:
    """Inner join of two bindings on their shared variables (bag)."""
    shared = sorted(set(left) & set(right))
    nl, nr = _nrows(left), _nrows(right)
    if not shared:
        li = np.repeat(np.arange(nl), nr)
        ri = np.tile(np.arange(nr), nl)
    else:
        lk, rk = _keys(left, shared), _keys(right, shared)
        if lk.ndim == 2:          # several shared variables: one id per key
            _, inv = np.unique(np.concatenate([lk, rk]), axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            lk, rk = inv[:nl], inv[nl:]
        order = np.argsort(rk, kind="stable")
        rs = rk[order]
        lo = np.searchsorted(rs, lk, "left")
        cnt = np.searchsorted(rs, lk, "right") - lo
        li = np.repeat(np.arange(nl), cnt)
        pos = np.arange(len(li)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        ri = order[np.repeat(lo, cnt) + pos]
    out = {v: c[li] for v, c in left.items()}
    out.update({v: c[ri] for v, c in right.items() if v not in out})
    return out


def evaluate(graph: Graph, patterns, projection, distinct: bool) -> list:
    """The answer of one basic graph pattern: a column per projected
    variable."""
    rels = [graph.match(tp) for tp in patterns]
    todo = sorted(range(len(rels)), key=lambda i: _nrows(rels[i]))
    cur = rels[todo.pop(0)]
    while todo:
        if _nrows(cur) == 0:
            break
        linked = [i for i in todo if set(rels[i]) & set(cur)]
        i = linked[0] if linked else todo[0]
        todo.remove(i)
        cur = join(cur, rels[i])
    n = _nrows(cur)
    cols = [cur[v] if v in cur else np.zeros(n, np.int64) for v in projection]
    if distinct and n:
        if len(cols) <= 2 and all(int(c.min()) >= 0 and int(c.max()) < 2**31 for c in cols):
            key = cols[0].astype(np.int64)
            if len(cols) == 2:
                key = (key << 31) | cols[1].astype(np.int64)
            key = np.unique(key)
            cols = [key >> 31, key & (2**31 - 1)] if len(cols) == 2 else [key]
        else:
            rows = np.unique(np.stack(cols, 1), axis=0)
            cols = [rows[:, j] for j in range(rows.shape[1])]
    return cols


def answer(graph: Graph, query) -> tuple:
    """The digest of ``query``'s answer."""
    return digest(evaluate(graph, query.patterns, query.projection, query.distinct))
