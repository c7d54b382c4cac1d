"""Pools of distinct queries shaped as FedBench's published queries.

A traffic file transcribes each FedBench query it serves as a small graph:
``nodes`` are its subject variables (or constants), each in a named source,
with the shape of its star (``typed``: the ``rdf:type`` pattern with a
bound class; ``bound``: patterns with a bound object; ``free``: patterns
with an object variable, named) and ``edges`` (``[predicate, node]``: the
link, object property or shared value the query follows).  A node with
``"value": true`` is an object variable alone, as ``?id`` in LS6.

An instance is drawn by a walk over the generated triples, in the order the
nodes are listed: each node after the first is reached over an edge from a
node already placed, forward (its objects) or backward (its subjects), and
each star's predicates (the source's own, never a link or property) and
bound objects are read from its subject's own triples.  So every instance has an answer.  The FedBench constants (a
class, a country, a title) become the walked subject's own values.

A query is plain data: ``patterns`` holds (s, p, o) triples whose terms are
variable names (``str``) or term ids (``int``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from odyssey_bench.gen.federation import RDF_TYPE, FederationData


@dataclass(frozen=True)
class Query:
    name: str
    patterns: tuple                   # ((s, p, o), ...): str variable or int id
    distinct: bool
    projection: tuple                 # variable names

    def renamed(self, perm: np.ndarray) -> "Query":
        """The same query with term ``i`` renamed ``perm[i]``."""
        pats = tuple(tuple(t if isinstance(t, str) else int(perm[t]) for t in tp)
                     for tp in self.patterns)
        return Query(self.name, pats, self.distinct, self.projection)


class _Index:
    """Sorted views of a federation's triples: each subject's triples, and
    each edge predicate's triples by subject and by object."""

    def __init__(self, fd: FederationData) -> None:
        s = np.concatenate([sd.s for sd in fd.sources])
        p = np.concatenate([sd.p for sd in fd.sources])
        o = np.concatenate([sd.o for sd in fd.sources])
        order = np.argsort(s, kind="stable")
        self.s, self.p, self.o = s[order], p[order], o[order]
        self.ranges = {sd.name: (sd.first, sd.first + sd.n) for sd in fd.sources}
        self._by_pred: dict = {}

    def of_subject(self, e: int) -> tuple:
        lo, hi = np.searchsorted(self.s, [e, e + 1])
        return self.p[lo:hi], self.o[lo:hi]

    def pred(self, pid: int) -> tuple:
        """(subjects, objects by subject; objects, subjects by object)."""
        if pid not in self._by_pred:
            sel = self.p == pid
            s, o = self.s[sel], self.o[sel]
            by_o = np.lexsort((s, o))
            self._by_pred[pid] = (s, o, o[by_o], s[by_o])
        return self._by_pred[pid]

    def forward(self, pid: int, e: int) -> np.ndarray:
        s, o, _, _ = self.pred(pid)
        lo, hi = np.searchsorted(s, [e, e + 1])
        return o[lo:hi]

    def backward(self, pid: int, e: int) -> np.ndarray:
        _, _, o, s = self.pred(pid)
        lo, hi = np.searchsorted(o, [e, e + 1])
        return s[lo:hi]


def _in(index: _Index, node: dict, ids: np.ndarray) -> np.ndarray:
    if "source" not in node:
        return ids
    lo, hi = index.ranges[node["source"]]
    return ids[(ids >= lo) & (ids < hi)]


def _walk(index: _Index, fd: FederationData, shape: dict, rng) -> "tuple | None":
    nodes = shape["nodes"]
    by_var = {n["var"]: n for n in nodes}
    edges = [(n["var"], fd.preds[p], t) for n in nodes for p, t in n.get("edges", [])]
    placed: dict[str, int] = {}
    for node in nodes:
        v = node["var"]
        if not placed:
            # the first node: a random triple of its first edge, from its side
            out = [(p, t) for a, p, t in edges if a == v]
            if out:
                p, _ = out[0]
                s, _, _, _ = index.pred(p)
                cand = _in(index, node, s)
            else:
                p = next(p for a, p, t in edges if t == v)
                _, o, _, _ = index.pred(p)
                cand = _in(index, node, o)
        else:
            link = next((a, p, t) for a, p, t in edges
                        if (a == v and t in placed) or (t == v and a in placed))
            a, p, t = link
            cand = (index.backward(p, placed[t]) if a == v
                    else index.forward(p, placed[a]))
            cand = _in(index, node, cand)
        if len(cand) == 0:
            return None
        placed[v] = int(cand[rng.integers(len(cand))])
    for a, p, t in edges:                       # edges that closed no walk step
        if placed[t] not in index.forward(p, placed[a]):
            return None

    named = list(fd.preds.values())
    rdf_type = fd.preds[RDF_TYPE]
    pats = []
    for node in nodes:
        if node.get("value"):
            continue
        v, e = node["var"], placed[node["var"]]
        subj = e if node.get("constant") else v
        ps, os_ = index.of_subject(e)
        if node.get("typed"):
            cls = os_[ps == rdf_type]
            if len(cls) == 0:
                return None
            pats.append((subj, rdf_type, int(cls[0])))
        own = np.unique(ps[~np.isin(ps, named)])
        k_bound, free = int(node.get("bound", 0)), list(node.get("free", []))
        if len(own) < k_bound + len(free):
            return None
        chosen = rng.choice(own, k_bound + len(free), replace=False).tolist()
        for pid in chosen[:k_bound]:
            pats.append((subj, int(pid), int(os_[ps == pid][0])))
        for pid, var in zip(chosen[k_bound:], free):
            pats.append((subj, int(pid), var))
        for p, t in node.get("edges", []):
            obj = placed[t] if by_var[t].get("constant") else t
            pats.append((subj, fd.preds[p], obj))
    return tuple(pats)


def make_pool(fd: FederationData, spec: dict, cache: "dict | None" = None) -> list:
    """``count`` distinct instances of each query of ``spec['queries']``,
    drawn from ``spec['seed']``.  ``cache`` keeps the triple index between
    calls on one federation."""
    rng = np.random.default_rng(spec["seed"])
    cache = {} if cache is None else cache
    if "index" not in cache:
        cache["index"] = _Index(fd)
    index = cache["index"]
    max_attempts = spec.get("max_attempts", 20000)
    seen = set(cache.get("seen", ()))
    out: list = []
    for shape in spec["queries"]:
        made = attempts = 0
        while made < shape["count"]:
            attempts += 1
            if attempts > max_attempts:
                raise RuntimeError(f"{shape['name']}: made {made} of {shape['count']} "
                                   f"distinct instances in {max_attempts} attempts")
            pats = _walk(index, fd, shape, rng)
            if pats is None or pats in seen:
                continue
            seen.add(pats)
            made += 1
            out.append(Query(f"{shape['name']}.{made}", pats, bool(shape.get("distinct")),
                             tuple(shape["project"])))
    cache["seen"] = seen
    return out
