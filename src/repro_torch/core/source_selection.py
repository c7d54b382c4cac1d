"""Source selection (paper §3.4 step i): CS/CP-based relevance with
link-aware pruning — never produces false negatives.

1. A source is a candidate for a star iff it has at least one CS containing
   *all* of the star's bound predicates (plus federated-CS handling for
   entities split across datasets).
2. CP pruning: for every object->subject edge between stars, a source pair
   (a, b) is viable only if a CP (intra for a == b, federated otherwise)
   links a relevant CS of the edge's source star in ``a`` to a relevant CS of
   its target star in ``b`` via the edge predicate. Sources that appear in no
   viable pair for some incident edge are pruned. Iterated to fixpoint.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.decomposition import Star, StarGraph
from repro_torch.core.federation import FederatedStats
from repro_torch.query.algebra import Const


@dataclass
class SourceSelection:
    star_sources: list[list[int]]                        # per star
    star_cs: list[dict[int, np.ndarray]]                 # star -> {src: relevant CS}
    edge_pairs: dict[int, set[tuple[int, int]]] = field(default_factory=dict)
    # memo for per-(star, preds) cardinalities / per-edge selectivities; the
    # selection is per-query, so the memo's lifetime matches the planning call
    _memo: dict = field(default_factory=dict, repr=False)

    def pattern_source_count(self, graph: StarGraph) -> int:
        """NSS metric: Σ over triple patterns of #selected sources."""
        return sum(len(self.star_sources[s.idx]) * len(s.patterns) for s in graph.stars)

    def detach(self) -> "SourceSelection":
        """Copy with fresh containers and an *empty* memo.  Cached plans must
        never hand out the stored selection by reference: a caller mutating
        ``star_sources``/``star_cs`` (failover-style source exclusion does
        exactly that) would corrupt every later cache hit, and the shared
        ``_memo`` would outlive its documented per-query lifetime."""
        return SourceSelection(
            star_sources=[list(s) for s in self.star_sources],
            star_cs=[dict(d) for d in self.star_cs],
            edge_pairs={k: set(v) for k, v in self.edge_pairs.items()},
        )


# --------------------------------------------------------------------------
# Shared probe/stat memo for batched selection
# --------------------------------------------------------------------------

def _star_key(star: Star) -> tuple:
    """Everything per-star relevance depends on: subject constant (or var),
    the *ordered* bound-predicate list, and the unprunable-var-pred flag.
    Object constants are deliberately absent — they never affect selection,
    which is what lets templated queries share one selection."""
    subj = star.subject.tid if isinstance(star.subject, Const) else None
    return (subj, tuple(star.bound_preds()), star.has_var_pred)


def selection_key(graph: StarGraph) -> tuple:
    """Everything ``select_sources`` depends on: per-star keys plus the
    ordered edge list.  Graphs with equal keys get equal selections, so a
    batch computes one selection per distinct key."""
    return (tuple(_star_key(s) for s in graph.stars),
            tuple((e.src, e.dst, e.pred, e.generic) for e in graph.edges))


class SelectionMemo:
    """Cross-query memo for ``select_sources_batch``: per-star relevant-CS
    scans, federated-CS candidate sets, and CP edge-viability probes are
    priced once for the whole batch.  Values are exactly what the unmemoized
    code computes (same functions, same inputs), so memoized selections stay
    bit-identical to ``select_sources`` without a memo; the arrays stored
    here are treated as immutable (the same contract ``star_cs`` already
    has across ``SourceSelection.detach`` copies)."""

    def __init__(self) -> None:
        self.star_rel: dict[tuple, tuple[list[int], dict[int, np.ndarray]]] = {}
        self.fed_cand: dict[frozenset, set[int]] = {}
        self.cp_probe: dict[tuple, bool] = {}

    def edge_viable(self, stats: FederatedStats, a: int, b: int, pred: int,
                    rel1: np.ndarray, rel2: np.ndarray) -> bool:
        """Memoized "does a CP link a relevant CS of ``a`` to one of ``b``
        via ``pred``" probe — the inner test of the CP pruning fixpoint."""
        key = (a, b, pred, rel1.tobytes(), rel2.tobytes())
        hit = self.cp_probe.get(key)
        if hit is None:
            cp = stats.cp_between(a, b)
            hit = cp is not None and len(cp.select(pred, rel1, rel2)) > 0
            self.cp_probe[key] = hit
        return hit


def _star_relevant_cs(star: Star, stats: FederatedStats, src: int) -> np.ndarray:
    cs = stats.cs[src]
    preds = star.bound_preds()
    if isinstance(star.subject, Const):
        c = cs.cs_of_entity(star.subject.tid)
        if c < 0:
            return np.zeros(0, np.int32)
        have = set(cs.preds_of(c).tolist())
        if all(p in have for p in preds):
            return np.asarray([c], np.int32)
        return np.zeros(0, np.int32)
    return cs.relevant_cs(preds)


def _fed_cs_candidates(star: Star, stats: FederatedStats) -> set[int]:
    """Sources that can contribute via *federated CSs* (entity described in
    two datasets whose combined predicate set covers the star)."""
    out: set[int] = set()
    preds = set(star.bound_preds())
    if not preds:
        return out
    for (a, b), triples in stats.fed_cs.items():
        for (ca, cb, _cnt) in triples:
            pa = set(stats.cs[a].preds_of(ca).tolist())
            pb = set(stats.cs[b].preds_of(cb).tolist())
            if preds <= (pa | pb) and not (preds <= pa) and not (preds <= pb):
                out.add(a)
                out.add(b)
    return out


def _star_candidates(star: Star, stats: FederatedStats,
                     memo: SelectionMemo | None,
                     ) -> tuple[list[int], dict[int, np.ndarray]]:
    """Pre-pruning candidates of one star: ``(star_sources, star_cs)``.
    Memoized on ``_star_key`` when a batch memo is supplied — the block
    depends on nothing else."""
    key = _star_key(star) if memo is not None else None
    if memo is not None:
        hit = memo.star_rel.get(key)
        if hit is not None:
            srcs, rel = hit
            return list(srcs), dict(rel)
    n_src = len(stats.cs)
    if star.has_var_pred and not star.bound_preds():
        # variable predicate with nothing to prune on: all sources
        srcs = list(range(n_src))
        rel = {s: np.arange(stats.cs[s].n_cs, dtype=np.int32) for s in srcs}
    else:
        rel = {}
        for s in range(n_src):
            r = _star_relevant_cs(star, stats, s)
            if len(r):
                rel[s] = r
        if memo is not None:
            fkey = frozenset(star.bound_preds())
            fed = memo.fed_cand.get(fkey)
            if fed is None:
                fed = _fed_cs_candidates(star, stats)
                memo.fed_cand[fkey] = fed
        else:
            fed = _fed_cs_candidates(star, stats)
        for s in fed:
            if s not in rel:
                rel[s] = np.arange(stats.cs[s].n_cs, dtype=np.int32)
        srcs = sorted(rel)
    if memo is not None:
        memo.star_rel[key] = (list(srcs), dict(rel))
    return srcs, rel


def select_sources(graph: StarGraph, stats: FederatedStats,
                   memo: SelectionMemo | None = None) -> SourceSelection:
    star_sources: list[list[int]] = []
    star_cs: list[dict[int, np.ndarray]] = []

    for star in graph.stars:
        srcs, rel = _star_candidates(star, stats, memo)
        star_cs.append(rel)
        star_sources.append(srcs)

    sel = SourceSelection(star_sources=star_sources, star_cs=star_cs)

    # --- CP-based edge pruning to fixpoint ---------------------------------
    changed = True
    while changed:
        changed = False
        for ei, e in enumerate(graph.edges):
            if e.generic or e.pred is None:
                continue
            viable: set[tuple[int, int]] = set()
            ok_src: set[int] = set()
            ok_dst: set[int] = set()
            for a in sel.star_sources[e.src]:
                rel1 = sel.star_cs[e.src].get(a)
                if rel1 is None or len(rel1) == 0:
                    continue
                for b in sel.star_sources[e.dst]:
                    rel2 = sel.star_cs[e.dst].get(b)
                    if rel2 is None or len(rel2) == 0:
                        continue
                    if memo is not None:
                        hit = memo.edge_viable(stats, a, b, e.pred, rel1, rel2)
                    else:
                        cp = stats.cp_between(a, b)
                        hit = cp is not None and len(cp.select(e.pred, rel1, rel2)) > 0
                    if hit:
                        viable.add((a, b))
                        ok_src.add(a)
                        ok_dst.add(b)
            sel.edge_pairs[ei] = viable
            new_src = [s for s in sel.star_sources[e.src] if s in ok_src]
            new_dst = [s for s in sel.star_sources[e.dst] if s in ok_dst]
            if new_src != sel.star_sources[e.src]:
                sel.star_sources[e.src] = new_src
                _prune_star_cs(sel.star_cs[e.src], new_src)
                changed = True
            if new_dst != sel.star_sources[e.dst]:
                sel.star_sources[e.dst] = new_dst
                _prune_star_cs(sel.star_cs[e.dst], new_dst)
                changed = True
    # the final (no-change) sweep computed every edge's viable pairs against
    # the fixpoint star_sources, so edge_pairs is consistent; filter anyway so
    # the invariant holds even for degenerate single-pass exits
    for ei, pairs in sel.edge_pairs.items():
        e = graph.edges[ei]
        keep_a = set(sel.star_sources[e.src])
        keep_b = set(sel.star_sources[e.dst])
        sel.edge_pairs[ei] = {(a, b) for (a, b) in pairs
                              if a in keep_a and b in keep_b}
    return sel


def concat_selections(graphs: "list[StarGraph]",
                      sels: "list[SourceSelection]",
                      query=None) -> "tuple[StarGraph, SourceSelection]":
    """Concatenate per-block star graphs and selections into one plan-level
    (graph, selection) pair with stars/edges reindexed by block offset.

    The group-tree planner decomposes and selects each conjunctive block
    independently; ``PhysicalPlan.graph``/``selection`` (the NSS metric,
    failover's source exclusion) want one object covering the whole query.
    Containers are fresh (``detach``-grade) so the blocks' own selections
    are not aliased."""
    stars: list[Star] = []
    edges: list = []
    star_sources: list[list[int]] = []
    star_cs: list[dict[int, np.ndarray]] = []
    edge_pairs: dict[int, set[tuple[int, int]]] = {}
    soff = eoff = 0
    for g, sel in zip(graphs, sels):
        for s in g.stars:
            stars.append(Star(s.idx + soff, s.subject, list(s.patterns)))
        for e in g.edges:
            edges.append(type(e)(src=e.src + soff, dst=e.dst + soff,
                                 pred=e.pred, pattern=e.pattern,
                                 generic=e.generic, var=e.var))
        star_sources.extend(list(x) for x in sel.star_sources)
        star_cs.extend(dict(x) for x in sel.star_cs)
        for ei, pairs in sel.edge_pairs.items():
            edge_pairs[ei + eoff] = set(pairs)
        soff += len(g.stars)
        eoff += len(g.edges)
    graph = StarGraph(stars=stars, edges=edges, query=query)
    return graph, SourceSelection(star_sources=star_sources, star_cs=star_cs,
                                  edge_pairs=edge_pairs)


def select_sources_batch(graphs: "list[StarGraph]", stats: FederatedStats,
                         memo: SelectionMemo | None = None,
                         ) -> "list[SourceSelection]":
    """Source selection over a whole batch, priced once where queries agree:

    * graphs with equal ``selection_key`` (selection ignores object
      constants, so every instance of a query template shares one key) run
      the pruning fixpoint **once**; every member receives a detached copy
      (fresh containers + empty per-query memo) of the shared result;
    * across *distinct* keys the per-star relevant-CS scans, federated-CS
      candidate sets and CP edge-viability probes still dedupe through the
      shared ``SelectionMemo``, so a star repeated across shapes is priced
      once for the union of the batch's stars.

    Each returned selection is bit-identical to ``select_sources(graph,
    stats)`` on its own — the memo only skips recomputing values the
    unmemoized path would derive identically."""
    memo = memo if memo is not None else SelectionMemo()
    done: dict[tuple, SourceSelection] = {}
    out: list[SourceSelection] = []
    for g in graphs:
        key = selection_key(g)
        base = done.get(key)
        if base is None:
            base = select_sources(g, stats, memo=memo)
            done[key] = base
        out.append(base.detach())
    return out


def _prune_star_cs(rel: dict[int, np.ndarray], keep: list[int]) -> None:
    """Keep ``star_cs`` consistent with a pruned ``star_sources``: consumers
    that read ``star_cs`` directly (federated-CS fallback entries included)
    must not see CS sets for sources the CP fixpoint eliminated."""
    keep_set = set(keep)
    for s in [s for s in rel if s not in keep_set]:
        del rel[s]
