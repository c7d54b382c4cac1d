"""HiBISCuS-style baseline [14]: hypergraph source pruning via IRI-authority
intersections on join variables, on top of FedX-style ASK selection and
variable-counting ordering."""
from __future__ import annotations

import time

import numpy as np

from repro_torch.baselines.fedx import FedXOptimizer, _selection_from_patterns
from repro_torch.core.planner import PhysicalPlan
from repro_torch.query.algebra import BGPQuery, Const, TriplePattern, Var
from repro_torch.rdf.dataset import Federation


class HibiscusOptimizer(FedXOptimizer):
    def __init__(self, fed: Federation, warm: bool = False):
        super().__init__(fed, warm=warm)
        # per source, per predicate: subject/object authority sets
        auth = fed.dictionary.authority_array()
        self.subj_auth: list[dict[int, set[int]]] = []
        self.obj_auth: list[dict[int, set[int]]] = []
        for src in fed.sources:
            t = src.table
            sa: dict[int, set[int]] = {}
            oa: dict[int, set[int]] = {}
            for p in np.unique(t.p).tolist():
                rows = t.scan(None, int(p), None)
                sa[int(p)] = set(auth[t.s[rows]].tolist())
                oa[int(p)] = set(auth[t.o[rows]].tolist())
            self.subj_auth.append(sa)
            self.obj_auth.append(oa)

    def _prune_by_authorities(self, query: BGPQuery, pat_sources: list[list[int]]) -> list[list[int]]:
        """Drop a source for tp_i if, for some join variable, the authority
        sets of the joined positions cannot intersect with *any* surviving
        source of the partner pattern."""
        pats = query.patterns

        def auth_of(pi: int, src: int, pos: str) -> set[int]:
            tp = pats[pi]
            if not isinstance(tp.p, Const):
                return set().union(*self.subj_auth[src].values()) if pos == "s" else \
                    set().union(*self.obj_auth[src].values())
            table = self.subj_auth if pos == "s" else self.obj_auth
            return table[src].get(tp.p.tid, set())

        changed = True
        while changed:
            changed = False
            for i, tp_i in enumerate(pats):
                for j, tp_j in enumerate(pats):
                    if i == j:
                        continue
                    shared = tp_i.variables() & tp_j.variables()
                    for v in shared:
                        pos_i = "s" if (isinstance(tp_i.s, Var) and tp_i.s.name == v) else \
                            ("o" if (isinstance(tp_i.o, Var) and tp_i.o.name == v) else None)
                        pos_j = "s" if (isinstance(tp_j.s, Var) and tp_j.s.name == v) else \
                            ("o" if (isinstance(tp_j.o, Var) and tp_j.o.name == v) else None)
                        if pos_i is None or pos_j is None:
                            continue
                        partner_auth: set[int] = set()
                        for b in pat_sources[j]:
                            partner_auth |= auth_of(j, b, pos_j)
                        keep = [a for a in pat_sources[i]
                                if auth_of(i, a, pos_i) & partner_auth]
                        if len(keep) < len(pat_sources[i]):
                            pat_sources[i] = keep
                            changed = True
        return pat_sources

    def optimize(self, query: BGPQuery) -> PhysicalPlan:
        t0 = time.perf_counter()
        # one probe memo for the whole selection: the probes here are the
        # only real ASKs; super().optimize sees the pruned lists below
        memo: dict[tuple, list[int]] = {}
        pat_sources = [self._sources_for(tp, memo) for tp in query.patterns]
        pat_sources = self._prune_by_authorities(query, pat_sources)
        # reuse FedX ordering/grouping on the pruned sources
        orig = self._sources_for
        try:
            cache = {id(tp): srcs for tp, srcs in zip(query.patterns, pat_sources)}
            self._sources_for = lambda tp, memo=None: cache[id(tp)]  # type: ignore[assignment]
            plan = super().optimize(query)
        finally:
            self._sources_for = orig  # type: ignore[assignment]
        plan.optimization_ms = (time.perf_counter() - t0) * 1e3
        return plan
