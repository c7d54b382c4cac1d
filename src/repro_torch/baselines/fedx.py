"""FedX-style baseline [17]: ASK-based source selection, variable-counting
join ordering [18], exclusive groups, bind joins.

Emits the same ``PhysicalPlan`` structure as Odyssey so the engines and
metrics are shared. ``warm=True`` reuses the ASK cache (FedX-Warm).
"""
from __future__ import annotations

import time

from repro_torch.core.decomposition import decompose
from repro_torch.core.planner import JoinPlanNode, PhysicalPlan, PlanNode, SubqueryNode
from repro_torch.core.source_selection import SourceSelection
from repro_torch.query.algebra import BGPQuery, Const, TriplePattern, Var
from repro_torch.rdf.dataset import Federation


def variable_counting_score(tp: TriplePattern, bound_vars: set[str]) -> float:
    """Heuristic selectivity [18]: constants/bound variables make a pattern
    selective; subjects more selective than objects, objects more than
    predicates."""
    score = 0.0
    s_free = isinstance(tp.s, Var) and tp.s.name not in bound_vars
    p_free = isinstance(tp.p, Var) and tp.p.name not in bound_vars
    o_free = isinstance(tp.o, Var) and tp.o.name not in bound_vars
    if s_free:
        score += 4.0
    if p_free:
        score += 1.0
    if o_free:
        score += 2.0
    return score


class FedXOptimizer:
    def __init__(self, fed: Federation, warm: bool = False):
        self.fed = fed
        self.warm = warm
        self._ask_cache: dict[tuple, list[int]] = {}   # warm: survives calls
        self.ask_count = 0                             # real ASK requests sent

    def _probe(self, key: tuple) -> list[int]:
        """One real ASK round: one request per endpoint, counted exactly."""
        s, p, o = key
        srcs = [i for i, src in enumerate(self.fed.sources) if src.ask(s, p, o)]
        self.ask_count += len(self.fed.sources)
        return srcs

    def _sources_for(self, tp: TriplePattern,
                     memo: dict[tuple, list[int]] | None = None) -> list[int]:
        """Relevant sources for one pattern.  ``memo`` is the per-selection
        probe memo (one ``optimize`` call == one source selection), so
        patterns sharing an ASK signature cost a single probe round per
        selection; warm mode keeps the memo across calls (FedX-Warm) while
        cold mode re-probes per selection, FedX's documented cold behavior.
        Returns a fresh list so callers can prune/mutate their copy without
        corrupting the memo."""
        key = tp.constants()
        if self.warm:
            memo = self._ask_cache
        elif memo is None:
            memo = {}
        srcs = memo.get(key)
        if srcs is None:
            srcs = self._probe(key)
            memo[key] = srcs
        return list(srcs)

    def optimize(self, query: BGPQuery) -> PhysicalPlan:
        t0 = time.perf_counter()
        graph = decompose(query)
        memo: dict[tuple, list[int]] = {}
        pat_sources = [self._sources_for(tp, memo) for tp in query.patterns]

        # exclusive groups: patterns with the same singleton source
        groups: dict[int, list[int]] = {}
        singles: list[int] = []
        for i, srcs in enumerate(pat_sources):
            if len(srcs) == 1:
                groups.setdefault(srcs[0], []).append(i)
            else:
                singles.append(i)
        units: list[tuple[list[int], list[int]]] = []  # (pattern idxs, sources)
        for src, idxs in groups.items():
            units.append((idxs, [src]))
        for i in singles:
            units.append(([i], pat_sources[i]))

        # variable-counting greedy order over units (exclusive groups first on
        # ties, FedX's documented behavior)
        ordered: list[tuple[list[int], list[int]]] = []
        bound: set[str] = set()
        remaining = list(units)
        while remaining:
            def unit_score(u: tuple[list[int], list[int]]) -> tuple:
                idxs, srcs = u
                sc = min(variable_counting_score(query.patterns[i], bound) for i in idxs)
                connected = any(
                    query.patterns[i].variables() & bound for i in idxs
                ) if bound else True
                return (not connected, sc, len(srcs) > 1, -len(idxs))
            remaining.sort(key=unit_score)
            u = remaining.pop(0)
            ordered.append(u)
            for i in u[0]:
                bound |= query.patterns[i].variables()

        # left-deep bind-join plan
        def leaf(u: tuple[list[int], list[int]]) -> SubqueryNode:
            idxs, srcs = u
            pats = [query.patterns[i] for i in idxs]
            star_ids = sorted({_star_of(graph, i) for i in idxs})
            return SubqueryNode(stars=star_ids, patterns=pats, sources=list(srcs))

        root: PlanNode = leaf(ordered[0])
        for u in ordered[1:]:
            rhs = leaf(u)
            jvars = sorted(_vars(root) & set(
                v for i in u[0] for v in query.patterns[i].variables()))
            root = JoinPlanNode(left=root, right=rhs, strategy="bind", join_vars=jvars)

        sel = _selection_from_patterns(graph, query, pat_sources)
        plan = PhysicalPlan(root=root, query=query, graph=graph, selection=sel)
        plan.optimization_ms = (time.perf_counter() - t0) * 1e3
        return plan


def _star_of(graph, pat_idx: int) -> int:
    tp = graph.query.patterns[pat_idx]
    for s in graph.stars:
        if tp in s.patterns:
            return s.idx
    return 0


def _vars(node: PlanNode) -> set[str]:
    if isinstance(node, SubqueryNode):
        out: set[str] = set()
        for tp in node.patterns:
            out |= set(tp.variables())
        return out
    if not isinstance(node, JoinPlanNode):
        raise TypeError(f"not a plan node: {node!r}")
    return _vars(node.left) | _vars(node.right)


def _selection_from_patterns(graph, query: BGPQuery, pat_sources: list[list[int]]) -> SourceSelection:
    """Adapt per-pattern source lists into the shared SourceSelection shape
    (star sources = union over its patterns) with exact per-pattern NSS."""
    star_sources = []
    for s in graph.stars:
        srcs: set[int] = set()
        for tp in s.patterns:
            srcs |= set(pat_sources[query.patterns.index(tp)])
        star_sources.append(sorted(srcs))
    sel = SourceSelection(star_sources=star_sources, star_cs=[{} for _ in graph.stars])
    total = sum(len(s) for s in pat_sources)
    sel.pattern_source_count = lambda g, _t=total: _t  # type: ignore[assignment]
    return sel
