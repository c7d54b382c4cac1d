"""Query decomposition (paper §3.4 step i): BGP -> star-shaped subqueries.

Stars group triple patterns by subject (footnote 3); links between stars are
object->subject variable chains described by CPs. Other shared variables
(e.g. object-object joins) become generic edges with fallback selectivity —
the paper notes the same principles apply to those join types.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.query.algebra import BGPQuery, Const, TriplePattern, Var


@dataclass
class Star:
    idx: int
    subject: object                     # Var | Const
    patterns: list[TriplePattern]

    def bound_preds(self) -> list[int]:
        return [tp.p.tid for tp in self.patterns if isinstance(tp.p, Const)]

    @property
    def has_var_pred(self) -> bool:
        return any(isinstance(tp.p, Var) for tp in self.patterns)

    def variables(self) -> frozenset[str]:
        out: frozenset[str] = frozenset()
        for tp in self.patterns:
            out |= tp.variables()
        return out


@dataclass
class Edge:
    """star ``src`` --pred--> star ``dst`` (pattern's object is dst's subject
    variable). ``pred`` is None for variable predicates; ``generic`` edges are
    shared-variable joins that are not object->subject chains."""

    src: int
    dst: int
    pred: int | None
    pattern: TriplePattern | None
    generic: bool = False
    var: str | None = None


@dataclass
class StarGraph:
    stars: list[Star]
    edges: list[Edge] = field(default_factory=list)
    query: BGPQuery | None = None

    def edges_of(self, i: int) -> list[Edge]:
        return [e for e in self.edges if e.src == i or e.dst == i]

    def connected(self, a: frozenset[int], b: frozenset[int]) -> list[Edge]:
        return [e for e in self.edges
                if (e.src in a and e.dst in b) or (e.src in b and e.dst in a)]

    def detach(self) -> "StarGraph":
        """Copy with fresh Star/Edge containers (terms/patterns are immutable
        and shared).  Plan-cache entries store and serve detached graphs so a
        caller mutating a plan's graph cannot corrupt later hits."""
        stars = [Star(s.idx, s.subject, list(s.patterns)) for s in self.stars]
        edges = [Edge(src=e.src, dst=e.dst, pred=e.pred, pattern=e.pattern,
                      generic=e.generic, var=e.var) for e in self.edges]
        return StarGraph(stars=stars, edges=edges, query=self.query)


def decompose(query: BGPQuery) -> StarGraph:
    return decompose_patterns(query.patterns, query)


def decompose_patterns(patterns: list[TriplePattern],
                       query: BGPQuery | None = None) -> StarGraph:
    """Star decomposition of one conjunctive pattern block.  ``decompose``
    is the whole-query form; the group-tree planner calls this per ``Bgp``
    block of the normalized algebra (each block is its own star graph)."""
    by_subject: dict[object, list[TriplePattern]] = {}
    for tp in patterns:
        key = tp.s  # Var/Const are frozen dataclasses -> hashable
        by_subject.setdefault(key, []).append(tp)
    stars = [Star(i, subj, pats) for i, (subj, pats) in enumerate(by_subject.items())]

    subj_var_of = {s.subject.name: s.idx for s in stars if isinstance(s.subject, Var)}
    edges: list[Edge] = []
    seen_obj_pairs: set[tuple[int, int, int | None]] = set()
    for s in stars:
        for tp in s.patterns:
            if isinstance(tp.o, Var) and tp.o.name in subj_var_of:
                j = subj_var_of[tp.o.name]
                if j != s.idx:
                    pred = tp.p.tid if isinstance(tp.p, Const) else None
                    edges.append(Edge(src=s.idx, dst=j, pred=pred, pattern=tp))
                    seen_obj_pairs.add((s.idx, j, pred))
    # generic shared-variable edges (object-object etc.)
    var_stars: dict[str, set[int]] = {}
    for s in stars:
        for tp in s.patterns:
            for t in (tp.o,):
                if isinstance(t, Var) and t.name not in subj_var_of:
                    var_stars.setdefault(t.name, set()).add(s.idx)
    for v, ss in var_stars.items():
        ss_l = sorted(ss)
        for i in range(len(ss_l)):
            for j in range(i + 1, len(ss_l)):
                edges.append(Edge(src=ss_l[i], dst=ss_l[j], pred=None, pattern=None,
                                  generic=True, var=v))
    return StarGraph(stars=stars, edges=edges, query=query)
