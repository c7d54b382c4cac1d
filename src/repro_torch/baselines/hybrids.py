"""Hybrid optimizers (paper §4.2, Fig. 9):

* ``OdysseyFedX`` — Odyssey's CS/CP source selection + star decomposition,
  FedX's variable-counting join ordering + bind joins.
* ``FedXOdyssey`` — FedX's ASK source selection, Odyssey's decomposition +
  DP join ordering over CS/CP cardinalities.
"""
from __future__ import annotations

import time

from repro_torch.baselines.fedx import variable_counting_score
from repro_torch.core.decomposition import decompose
from repro_torch.core.federation import FederatedStats
from repro_torch.core.join_order import (DEFAULT_DEVICE, dp_join_order,
                                         order_star_patterns)
from repro_torch.core.planner import (JoinPlanNode, OdysseyOptimizer, PhysicalPlan,
                                PlanNode, SubqueryNode, _vars_of)
from repro_torch.core.source_selection import SourceSelection, select_sources
from repro_torch.query.algebra import BGPQuery
from repro_torch.rdf.dataset import Federation


class OdysseyFedX:
    """Odyssey source selection/decomposition + FedX ordering."""

    def __init__(self, stats: FederatedStats):
        self.stats = stats

    def optimize(self, query: BGPQuery) -> PhysicalPlan:
        t0 = time.perf_counter()
        graph = decompose(query)
        sel = select_sources(graph, self.stats)
        # units: stars; merge stars sharing one exclusive source
        groups: dict[int, list[int]] = {}
        multi: list[int] = []
        for s in graph.stars:
            srcs = sel.star_sources[s.idx]
            if len(srcs) == 1:
                groups.setdefault(srcs[0], []).append(s.idx)
            else:
                multi.append(s.idx)
        units: list[tuple[list[int], list[int]]] = []
        for src, stars in groups.items():
            units.append((stars, [src]))
        for si in multi:
            units.append(([si], sel.star_sources[si]))

        ordered: list[tuple[list[int], list[int]]] = []
        bound: set[str] = set()
        remaining = list(units)
        while remaining:
            def score(u):
                stars, srcs = u
                sc = min(min(variable_counting_score(tp, bound)
                             for tp in graph.stars[si].patterns) for si in stars)
                connected = any(graph.stars[si].variables() & bound
                                for si in stars) if bound else True
                return (not connected, sc, len(srcs) > 1)
            remaining.sort(key=score)
            u = remaining.pop(0)
            ordered.append(u)
            for si in u[0]:
                bound |= graph.stars[si].variables()

        def leaf(u):
            stars, srcs = u
            pats = []
            for si in sorted(stars):
                pats.extend(order_star_patterns(graph.stars[si], self.stats, sel,
                                                query.distinct))
            return SubqueryNode(stars=sorted(stars), patterns=pats, sources=list(srcs))

        root: PlanNode = leaf(ordered[0])
        for u in ordered[1:]:
            rhs = leaf(u)
            jvars = sorted(_vars_of(root) & _vars_of(rhs))
            root = JoinPlanNode(left=root, right=rhs, strategy="bind", join_vars=jvars)
        plan = PhysicalPlan(root=root, query=query, graph=graph, selection=sel)
        plan.fallback = any(s.has_var_pred for s in graph.stars)
        plan.optimization_ms = (time.perf_counter() - t0) * 1e3
        return plan


class FedXOdyssey(OdysseyOptimizer):
    """FedX ASK-based source selection + Odyssey decomposition/DP ordering.
    The DP runs with ``dp_backend`` on ``device`` (the card by default)."""

    def __init__(self, stats: FederatedStats, fed: Federation,
                 dp_backend: str = "torch", device: str = DEFAULT_DEVICE):
        super().__init__(stats, dp_backend=dp_backend, device=device)
        self.fed = fed

    def optimize(self, query: BGPQuery) -> PhysicalPlan:
        t0 = time.perf_counter()
        graph = decompose(query)
        # ASK selection per star: sources answering every pattern of the star
        star_sources: list[list[int]] = []
        star_cs: list[dict] = []
        import numpy as np
        for s in graph.stars:
            srcs = []
            for i, src in enumerate(self.fed.sources):
                if all(src.ask(*tp.constants()) for tp in s.patterns):
                    srcs.append(i)
            star_sources.append(srcs)
            star_cs.append({i: self.stats.cs[i].relevant_cs(s.bound_preds())
                            for i in srcs})
        sel = SourceSelection(star_sources=star_sources, star_cs=star_cs)
        tree = dp_join_order(graph, self.stats, sel, self.cost_model,
                             query.distinct, dp_backend=self.dp_backend,
                             device=self.device)
        root = self._emit(tree, graph, sel, query)
        plan = PhysicalPlan(root=root, query=query, graph=graph, selection=sel)
        plan.fallback = any(s.has_var_pred for s in graph.stars)
        plan.optimization_ms = (time.perf_counter() - t0) * 1e3
        return plan
