"""DP-VOID baseline (paper §4): dynamic programming over *triple patterns*
with VOID-granularity statistics — uniformity + independence assumptions,
exactly the estimation errors CSs/CPs were designed to avoid. With
``use_ask=True`` this approximates SPLENDID/SemaGrow (VOID + ASK-refined
source selection)."""
from __future__ import annotations

import time
from itertools import combinations

from repro_torch.core.cost import CostModel
from repro_torch.core.decomposition import decompose
from repro_torch.core.planner import JoinPlanNode, PhysicalPlan, PlanNode, SubqueryNode
from repro_torch.query.algebra import BGPQuery, Const, TriplePattern, Var
from repro_torch.rdf.dataset import Federation
from repro_torch.stats.void import VoidStats, compute_void

from repro_torch.baselines.fedx import _selection_from_patterns, _star_of


class VoidDPOptimizer:
    def __init__(self, fed: Federation, void: list[VoidStats] | None = None,
                 use_ask: bool = False, cost_model: CostModel | None = None):
        self.fed = fed
        self.void = void or [compute_void(s.table) for s in fed.sources]
        self.use_ask = use_ask
        self.cm = cost_model or CostModel()

    def _sources_for(self, tp: TriplePattern) -> list[int]:
        s, p, o = tp.constants()
        out = []
        for i, v in enumerate(self.void):
            if p is not None:
                if not v.has_pred(p):
                    continue
                if self.use_ask and not self.fed.sources[i].ask(s, p, o):
                    continue
                out.append(i)
            else:
                if self.use_ask and not self.fed.sources[i].ask(s, p, o):
                    continue
                out.append(i)
        return out

    def _card(self, tp: TriplePattern, srcs: list[int]) -> float:
        s, p, o = tp.constants()
        return sum(self.void[i].estimate_pattern(s, p, o) for i in srcs)

    def optimize(self, query: BGPQuery) -> PhysicalPlan:
        t0 = time.perf_counter()
        graph = decompose(query)
        pats = query.patterns
        n = len(pats)
        pat_sources = [self._sources_for(tp) for tp in pats]
        base_card = [max(self._card(tp, pat_sources[i]), 0.0) for i, tp in enumerate(pats)]

        # independence-assumption join selectivity: 1/max(distinct join keys)
        def pair_sel(i: int, j: int) -> float:
            shared = pats[i].variables() & pats[j].variables()
            if not shared:
                return 1.0
            sel = 1.0
            for _v in shared:
                d1 = max(1.0, base_card[i])
                d2 = max(1.0, base_card[j])
                sel *= 1.0 / max(1.0, min(d1, d2))
            return sel

        def subset_card(ss: frozenset[int]) -> float:
            card = 1.0
            for i in ss:
                card *= base_card[i]
            for i, j in combinations(sorted(ss), 2):
                card *= pair_sel(i, j)
            return card

        best: dict[frozenset[int], tuple[float, PlanNode, float]] = {}
        for i in range(n):
            ss = frozenset([i])
            node = SubqueryNode(stars=[_star_of(graph, i)], patterns=[pats[i]],
                                sources=pat_sources[i], est_cardinality=base_card[i])
            best[ss] = (self.cm.leaf_cost(base_card[i], pat_sources[i]), node, base_card[i])

        for size in range(2, n + 1):
            for combo in combinations(range(n), size):
                ss = frozenset(combo)
                cand = None
                for k in range(1, size):
                    for sub in combinations(combo, k):
                        a = frozenset(sub)
                        b = ss - a
                        if a not in best or b not in best:
                            continue
                        ca, na, karda = best[a]
                        cb, nb, kardb = best[b]
                        # require connectivity
                        va = set().union(*[pats[i].variables() for i in a])
                        vb = set().union(*[pats[i].variables() for i in b])
                        if not (va & vb) and size < n:
                            continue
                        card = subset_card(ss)
                        hash_cost = ca + cb + self.cm.hash_join_cost(card)
                        bind_ok = isinstance(nb, SubqueryNode)
                        bind_cost = (ca + self.cm.bind_join_cost(karda, card, nb.sources)
                                     if bind_ok else float("inf"))
                        strategy = "bind" if bind_cost < hash_cost else "hash"
                        cost = min(hash_cost, bind_cost)
                        if cand is None or cost < cand[0]:
                            jvars = sorted(va & vb)
                            cand = (cost, JoinPlanNode(left=na, right=nb, strategy=strategy,
                                                       join_vars=jvars, est_cardinality=card), card)
                if cand is not None and (ss not in best or cand[0] < best[ss][0]):
                    best[ss] = cand

        full = frozenset(range(n))
        root = best[full][1] if full in best else best[max(best, key=len)][1]
        sel = _selection_from_patterns(graph, query, pat_sources)
        plan = PhysicalPlan(root=root, query=query, graph=graph, selection=sel)
        plan.optimization_ms = (time.perf_counter() - t0) * 1e3
        return plan
