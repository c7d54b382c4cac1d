"""The Odyssey optimizer (paper §3.4): preprocessing + source selection,
join-order optimization, subquery optimization (merging), and plan emission.

``OdysseyOptimizer.optimize`` produces a ``PhysicalPlan`` the engine
(``repro_torch.engine.local``) executes, plus the paper's plan-level metrics
(optimization time, #selected sources, #subqueries).  The join-order DP
runs on the card by default (``dp_backend='torch'``, ``device='cuda'``).

Serving-scale additions on top of the paper:

* **Plan cache** — plans are keyed by a canonical query signature
  (``query_signature``: pattern structure with variables canonicalized by
  first occurrence, constant ids verbatim, plus the DISTINCT flag).  A
  repeated or templated query skips decomposition, source selection and the
  join-order DP entirely; on a hit the cached plan is rebound to the incoming
  query (variables renamed if the new query uses different names).  Entries
  are *epoch-keyed*: each records the statistics epoch it was planned under,
  and a hit under a newer epoch (after ``FederatedStats.remove_source`` /
  ``add_source`` / ``refresh_source``) is a miss — the stale entry is
  lazily evicted and the structure-only signature re-warms naturally.

* **Batched planning** — ``optimize_batch`` plans a batch through
  ``repro_torch.core.batch_planner``: one epoch snapshot, shared source
  selection and one stacked DP sweep per structural shape, bit-identical
  per query to the ``optimize`` loop.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace

from repro_torch.core.cost import CostModel
from repro_torch.core.decomposition import StarGraph, decompose, decompose_patterns
from repro_torch.core.federation import FederatedStats
from repro_torch.core.join_order import (
    DEFAULT_DEVICE,
    DP_BACKENDS,
    JoinTree,
    dp_join_order,
    order_star_patterns,
    star_source_cardinalities,
)
from repro_torch.core.source_selection import (
    SourceSelection,
    concat_selections,
    select_sources,
)
from repro_torch.query.algebra import (
    And,
    BGPQuery,
    Bgp,
    Comparison,
    Const,
    Expr,
    Filter,
    GroupNode,
    Join,
    LeftJoin,
    Not,
    Or,
    Term,
    TriplePattern,
    Union,
    Var,
    expr_variables,
    group_variables,
    is_well_designed,
    normalize,
)


@dataclass
class PlanNode:
    pass


@dataclass
class SubqueryNode(PlanNode):
    """One SPARQL subquery dispatched to ``sources`` (merged stars ==
    exclusive group executed remotely as a single query)."""

    stars: list[int]
    patterns: list[TriplePattern]            # in execution order
    sources: list[int]
    est_cardinality: float = 0.0
    # per-source expected rows, aligned with ``sources`` — what the pipeline
    # scores each endpoint's observed scan cardinality against (feedback)
    est_source_cards: "list[float] | None" = None


@dataclass
class JoinPlanNode(PlanNode):
    left: PlanNode
    right: PlanNode
    strategy: str                            # "hash" | "bind"
    join_vars: list[str] = field(default_factory=list)
    est_cardinality: float = 0.0


@dataclass
class LeftJoinPlanNode(PlanNode):
    """OPTIONAL: every left row survives; right columns are UNDEF where the
    arm found no match.  Child order is semantic (never commuted)."""

    left: PlanNode
    right: PlanNode
    join_vars: list[str] = field(default_factory=list)
    est_cardinality: float = 0.0


@dataclass
class UnionPlanNode(PlanNode):
    """UNION: outer union of the children's results, schemas aligned with
    UNDEF padding."""

    children: list[PlanNode] = field(default_factory=list)
    est_cardinality: float = 0.0


@dataclass
class FilterPlanNode(PlanNode):
    """FILTER over the child's rows.  The normalization pass places these at
    the deepest point where the expression's variables are certainly bound,
    so the engine evaluates them as early as possible."""

    expr: Expr
    child: PlanNode
    est_cardinality: float = 0.0


@dataclass
class PhysicalPlan:
    root: PlanNode
    query: BGPQuery
    graph: StarGraph
    selection: SourceSelection
    optimization_ms: float = 0.0
    fallback: bool = False                   # variable-predicate fallback
    cached: bool = False                     # served from the plan cache
    stats_epoch: int = 0                     # statistics epoch it was planned under
    well_designed: bool = True               # OPTIONAL reordering was licensed

    def subqueries(self) -> list[SubqueryNode]:
        out: list[SubqueryNode] = []

        def walk(n: PlanNode) -> None:
            if isinstance(n, SubqueryNode):
                out.append(n)
            elif isinstance(n, (JoinPlanNode, LeftJoinPlanNode)):
                walk(n.left)
                walk(n.right)
            elif isinstance(n, UnionPlanNode):
                for c in n.children:
                    walk(c)
            elif isinstance(n, FilterPlanNode):
                walk(n.child)

        walk(self.root)
        return out

    @property
    def n_subqueries(self) -> int:
        """NSQ: subqueries dispatched (a subquery sent to k sources counts k,
        matching how the FedBench studies count endpoint requests)."""
        return sum(max(1, len(sq.sources)) for sq in self.subqueries())

    @property
    def n_selected_sources(self) -> int:
        """NSS: Σ over triple patterns of #selected sources."""
        return self.selection.pattern_source_count(self.graph)


# --------------------------------------------------------------------------
# Plan cache
# --------------------------------------------------------------------------

def query_signature(query: BGPQuery) -> tuple[tuple, tuple[str, ...]]:
    """Canonical signature of a BGP query: pattern structure with variables
    numbered by first occurrence, constant term ids verbatim, and the
    DISTINCT flag.  Returns ``(signature, var_order)`` where ``var_order``
    lists the query's variable names in canonical-index order (used to rebind
    a cached plan onto a query that differs only in variable names).

    Queries differing in any constant, in DISTINCT, or in pattern order get
    distinct signatures; the projection does not affect the plan shape and is
    re-attached from the incoming query on a hit.

    A query carrying a group tree (``query.root``) is hashed over the *full
    algebra*: node kinds, filter expressions, and child order (LeftJoin child
    order is semantic).  The degenerate ``root is None`` case keeps the
    legacy flat-pattern signature bit-for-bit, and the algebra signatures
    live under a distinct ``"alg"`` tag — an OPTIONAL/UNION/FILTER variant
    of a template can never alias its plain-BGP cache entry.
    """
    names: dict[str, int] = {}

    def term_key(t: Term) -> tuple:
        if isinstance(t, Const):
            return ("c", t.tid)
        if not isinstance(t, Var):
            raise TypeError(f"not a term: {t!r}")
        return ("v", names.setdefault(t.name, len(names)))

    if query.root is None:
        pats = tuple((term_key(tp.s), term_key(tp.p), term_key(tp.o))
                     for tp in query.patterns)
        return (pats, bool(query.distinct)), tuple(names)

    def expr_key(e: Expr) -> tuple:
        if isinstance(e, Comparison):
            return ("cmp", e.op, term_key(e.lhs), term_key(e.rhs))
        if isinstance(e, (And, Or)):
            tag = "and" if isinstance(e, And) else "or"
            return (tag, tuple(expr_key(p) for p in e.parts))
        if not isinstance(e, Not):
            raise TypeError(f"not a filter expression: {e!r}")
        return ("not", expr_key(e.part))

    def node_key(n: GroupNode) -> tuple:
        if isinstance(n, Bgp):
            return ("bgp", tuple((term_key(tp.s), term_key(tp.p),
                                  term_key(tp.o)) for tp in n.patterns))
        if isinstance(n, Join):
            return ("join", tuple(node_key(c) for c in n.children))
        if isinstance(n, LeftJoin):
            return ("leftjoin", node_key(n.left), node_key(n.right))
        if isinstance(n, Union):
            return ("union", tuple(node_key(m) for m in n.members))
        if not isinstance(n, Filter):
            raise TypeError(f"not a group node: {n!r}")
        return ("filter", expr_key(n.expr), node_key(n.child))

    sig = ("alg", node_key(query.root))
    # filter-only variables may trail the pattern variables; make sure every
    # query variable has a canonical index so rebinding can rename the tree
    for tp in query.patterns:
        for t in (tp.s, tp.p, tp.o):
            if isinstance(t, Var):
                names.setdefault(t.name, len(names))
    return (sig, bool(query.distinct)), tuple(names)


@dataclass
class CacheEntry:
    plan: PhysicalPlan                        # pristine, detached copy
    var_order: tuple[str, ...]
    epoch: int = 0                            # stats epoch it was planned under


class PlanCache:
    """LRU map: query signature -> pristine plan + the statistics epoch it
    was planned under.

    Epoch-aware: a lookup under a *newer* epoch is a miss — the entry was
    planned over statistics that have since been mutated (source removed,
    added or refreshed), so its source ids and cardinalities may be stale.
    Eviction is lazy: stale entries are dropped on touch, and because
    ``query_signature`` is structure-only, a templated workload re-warms the
    cache naturally after a refresh (first arrival per template replans, the
    rest hit)."""

    def __init__(self, max_entries: int = 1024):
        self.max_entries = max_entries
        self._entries: OrderedDict[tuple, CacheEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.stale_evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, sig: tuple, epoch: int | None = None) -> CacheEntry | None:
        entry = self._entries.get(sig)
        if entry is None:
            self.misses += 1
            return None
        if epoch is not None and entry.epoch != epoch:
            del self._entries[sig]            # lazy eviction of a stale plan
            self.stale_evictions += 1
            self.misses += 1
            return None
        self._entries.move_to_end(sig)
        self.hits += 1
        # repro: ignore[RPR002] -- entry.plan is stored pre-detached (put() runs
        # _detach_plan) and every hit site re-detaches before handing the plan
        # to callers (see optimize()/_rebind); the entry itself never escapes
        return entry

    def put(self, sig: tuple, plan: PhysicalPlan, var_order: tuple[str, ...],
            epoch: int = 0) -> None:
        # store a pristine, detached plan: the caller keeps (and may mutate)
        # `plan`, its tree, its selection and its graph
        self._entries[sig] = CacheEntry(_detach_plan(plan), var_order, epoch)
        self._entries.move_to_end(sig)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        self._entries.clear()
        self.hits = 0
        self.misses = 0
        self.stale_evictions = 0


def _detach_plan(plan: PhysicalPlan) -> PhysicalPlan:
    """A plan that shares no mutable state with ``plan``: fresh tree, fresh
    selection containers (empty per-query memo), fresh graph containers.
    Without this, a caller mutating ``plan.selection.star_sources`` (exactly
    what failover-style source exclusion does) corrupts every later hit."""
    return replace(plan, root=_copy_node(plan.root),
                   selection=plan.selection.detach(),
                   graph=plan.graph.detach())


def _copy_node(node: PlanNode) -> PlanNode:
    """Fresh plan tree with fresh mutable fields.  Cached plans must never
    share their ``root`` with plans handed to callers: engines and callers
    adjust ``est_cardinality`` / ``sources`` in place, which would silently
    corrupt every later cache hit.  Every ``PlanNode`` variant must be
    handled here — an unhandled variant would alias the stored entry
    (RPR002 checks this mechanically)."""
    if isinstance(node, SubqueryNode):
        return SubqueryNode(stars=list(node.stars), patterns=list(node.patterns),
                            sources=list(node.sources),
                            est_cardinality=node.est_cardinality,
                            est_source_cards=(None if node.est_source_cards is None
                                              else list(node.est_source_cards)))
    if isinstance(node, LeftJoinPlanNode):
        return LeftJoinPlanNode(left=_copy_node(node.left),
                                right=_copy_node(node.right),
                                join_vars=list(node.join_vars),
                                est_cardinality=node.est_cardinality)
    if isinstance(node, UnionPlanNode):
        return UnionPlanNode(children=[_copy_node(c) for c in node.children],
                             est_cardinality=node.est_cardinality)
    if isinstance(node, FilterPlanNode):
        # Expr trees are frozen dataclasses (immutable): shared by contract
        return FilterPlanNode(expr=node.expr, child=_copy_node(node.child),
                              est_cardinality=node.est_cardinality)
    if not isinstance(node, JoinPlanNode):
        raise TypeError(f"not a plan node: {node!r}")
    return JoinPlanNode(left=_copy_node(node.left), right=_copy_node(node.right),
                        strategy=node.strategy, join_vars=list(node.join_vars),
                        est_cardinality=node.est_cardinality)


def _rename_term(t: Term, ren: dict[str, str]) -> Term:
    return Var(ren[t.name]) if isinstance(t, Var) else t


def _rename_expr(e: Expr, ren: dict[str, str]) -> Expr:
    if isinstance(e, Comparison):
        return Comparison(e.op, _rename_term(e.lhs, ren), _rename_term(e.rhs, ren))
    if isinstance(e, And):
        return And(tuple(_rename_expr(p, ren) for p in e.parts))
    if isinstance(e, Or):
        return Or(tuple(_rename_expr(p, ren) for p in e.parts))
    if not isinstance(e, Not):
        raise TypeError(f"not a filter expression: {e!r}")
    return Not(_rename_expr(e.part, ren))


def _rename_node(node: PlanNode, ren: dict[str, str]) -> PlanNode:
    if isinstance(node, SubqueryNode):
        pats = [TriplePattern(_rename_term(tp.s, ren), _rename_term(tp.p, ren),
                              _rename_term(tp.o, ren)) for tp in node.patterns]
        return SubqueryNode(stars=list(node.stars), patterns=pats,
                            sources=list(node.sources),
                            est_cardinality=node.est_cardinality,
                            est_source_cards=(None if node.est_source_cards is None
                                              else list(node.est_source_cards)))
    if isinstance(node, LeftJoinPlanNode):
        return LeftJoinPlanNode(left=_rename_node(node.left, ren),
                                right=_rename_node(node.right, ren),
                                join_vars=sorted(ren[v] for v in node.join_vars),
                                est_cardinality=node.est_cardinality)
    if isinstance(node, UnionPlanNode):
        return UnionPlanNode(children=[_rename_node(c, ren)
                                       for c in node.children],
                             est_cardinality=node.est_cardinality)
    if isinstance(node, FilterPlanNode):
        return FilterPlanNode(expr=_rename_expr(node.expr, ren),
                              child=_rename_node(node.child, ren),
                              est_cardinality=node.est_cardinality)
    if not isinstance(node, JoinPlanNode):
        raise TypeError(f"not a plan node: {node!r}")
    return JoinPlanNode(left=_rename_node(node.left, ren),
                        right=_rename_node(node.right, ren),
                        strategy=node.strategy,
                        join_vars=sorted(ren[v] for v in node.join_vars),
                        est_cardinality=node.est_cardinality)


def _rename_graph(graph: StarGraph, ren: dict[str, str]) -> StarGraph:
    """Rename the variables of a (detached) star graph in place of
    re-decomposing: algebra plans concatenate per-block graphs, a shape
    ``decompose(query)`` cannot reproduce."""
    from repro_torch.core.decomposition import Edge, Star

    def rn_tp(tp: TriplePattern) -> TriplePattern:
        return TriplePattern(_rename_term(tp.s, ren), _rename_term(tp.p, ren),
                             _rename_term(tp.o, ren))

    stars = [Star(s.idx, _rename_term(s.subject, ren), [rn_tp(tp) for tp in s.patterns])
             for s in graph.stars]
    edges = [Edge(src=e.src, dst=e.dst, pred=e.pred,
                  pattern=rn_tp(e.pattern) if e.pattern is not None else None,
                  generic=e.generic,
                  var=ren.get(e.var, e.var) if e.var is not None else None)
             for e in graph.edges]
    return StarGraph(stars=stars, edges=edges, query=graph.query)


class OdysseyOptimizer:
    """Cost-based federated optimizer over CS/CP statistics, with an LRU plan
    cache in front of the full optimization pipeline."""

    def __init__(self, stats: FederatedStats, cost_model: CostModel | None = None,
                 plan_cache_size: int = 1024, dp_block_bytes: int | None = None,
                 dp_backend: str = "torch", device: str = DEFAULT_DEVICE):
        self.stats = stats
        self.cost_model = cost_model or CostModel()
        self.plan_cache: PlanCache | None = (
            PlanCache(plan_cache_size) if plan_cache_size > 0 else None)
        # peak bytes for the join-order DP's per-layer candidate tiles
        # (None == repro_torch.core.join_order.DP_BLOCK_BYTES)
        self.dp_block_bytes = dp_block_bytes
        # who runs the DP sweep: 'numpy' (in-process tiled layer loop) or
        # 'torch' (the repro_torch.kernels.dp_layer CUDA kernels on
        # ``device``, state resident across layers, dense layer tiles as the
        # oversized-schedule fallback; their plain versions on a CPU
        # device); plans are bit-identical either way
        if dp_backend not in DP_BACKENDS:
            raise ValueError(f"unknown dp_backend {dp_backend!r} "
                             f"(expected one of {DP_BACKENDS})")
        self.dp_backend = dp_backend
        self.device = device
        # what the last optimize_batch call shared (BatchPlanReport)
        self.last_batch_report = None

    @property
    def stats_epoch(self) -> int:
        """Epoch of the underlying statistics (0 for legacy stats objects)."""
        return getattr(self.stats, "epoch", 0)

    def optimize(self, query: BGPQuery, use_cache: bool = True) -> PhysicalPlan:
        t0 = time.perf_counter()
        epoch = self.stats_epoch               # one snapshot per planning call
        sig = var_order = None
        if use_cache and self.plan_cache is not None:
            sig, var_order = query_signature(query)
            entry = self.plan_cache.get(sig, epoch=epoch)
            if entry is not None:
                plan = self._rebind(entry, var_order, query)
                plan.optimization_ms = (time.perf_counter() - t0) * 1e3
                return plan
        plan = self._optimize_uncached(query, t0)
        plan.stats_epoch = epoch
        if sig is not None:
            self.plan_cache.put(sig, plan, var_order, epoch=epoch)
        return plan

    def optimize_batch(self, queries: "list[BGPQuery]") -> "list[PhysicalPlan]":
        """Plan a batch through the truly batched pipeline
        (``repro_torch.core.batch_planner.plan_batch``): one epoch snapshot,
        plan-cache hits and exact-signature duplicates rebound per query,
        one shared source-selection pass over the union of the remaining
        queries' stars, and one stacked DP sweep per structural shape on
        ``self.device``.  Bit-identical per query to
        ``[self.optimize(q) for q in queries]`` — batching changes the
        planning cost, never the plans.  The sharing achieved is reported on
        ``self.last_batch_report``."""
        from repro_torch.core.batch_planner import plan_batch

        return plan_batch(self, queries)

    def _optimize_uncached(self, query: BGPQuery, t0: float) -> PhysicalPlan:
        if not query.is_conjunctive():
            return self._optimize_algebra(query, t0)
        graph = decompose(query)
        sel = select_sources(graph, self.stats)
        tree = dp_join_order(graph, self.stats, sel, self.cost_model, query.distinct,
                             block_bytes=self.dp_block_bytes,
                             dp_backend=self.dp_backend, device=self.device)
        root = self._emit(tree, graph, sel, query)
        plan = PhysicalPlan(root=root, query=query, graph=graph, selection=sel,
                            stats_epoch=self.stats_epoch)
        plan.fallback = any(s.has_var_pred for s in graph.stars)
        plan.optimization_ms = (time.perf_counter() - t0) * 1e3
        return plan

    # -- group-tree (OPTIONAL / UNION / FILTER) planning --------------------
    def _optimize_algebra(self, query: BGPQuery, t0: float) -> PhysicalPlan:
        """Compositional planning over the normalized group tree: each ``Bgp``
        block runs the unchanged conjunctive pipeline (star decomposition →
        source selection → bitmask DP → emission), and the blocks are composed
        with LeftJoin/Union/Filter plan nodes costed by ``CostModel``.  The
        plan-level graph/selection concatenate the per-block results so NSS
        and source-failover keep working on extended plans."""
        root_alg = normalize(query.algebra())
        graphs: list[StarGraph] = []
        sels: list[SourceSelection] = []
        root = self._plan_group(root_alg, query, graphs, sels)
        graph, sel = concat_selections(graphs, sels, query)
        plan = PhysicalPlan(root=root, query=query, graph=graph, selection=sel,
                            stats_epoch=self.stats_epoch,
                            well_designed=is_well_designed(root_alg))
        plan.fallback = any(s.has_var_pred for s in graph.stars)
        plan.optimization_ms = (time.perf_counter() - t0) * 1e3
        return plan

    def _plan_group(self, node: GroupNode, query: BGPQuery,
                    graphs: "list[StarGraph]",
                    sels: "list[SourceSelection]") -> PlanNode:
        cm = self.cost_model
        if isinstance(node, Bgp):
            if not node.patterns:
                raise ValueError(
                    "empty group pattern (e.g. a bare OPTIONAL) is not "
                    "supported — every group needs at least one triple pattern")
            block = decompose_patterns(list(node.patterns), query)
            sel = select_sources(block, self.stats)
            tree = dp_join_order(block, self.stats, sel, cm, query.distinct,
                                 block_bytes=self.dp_block_bytes,
                                 dp_backend=self.dp_backend,
                                 device=self.device)
            planned = self._emit(tree, block, sel, query)
            soff = sum(len(g.stars) for g in graphs)
            if soff:
                _offset_stars(planned, soff)
            graphs.append(block)
            sels.append(sel)
            return planned
        if isinstance(node, Join):
            children = [self._plan_group(c, query, graphs, sels)
                        for c in node.children]
            # left-deep, cheapest block first (stable: ties keep group order)
            children.sort(key=lambda n: n.est_cardinality)
            cur = children[0]
            for nxt in children[1:]:
                shared = sorted(_vars_of(cur) & _vars_of(nxt))
                card = cm.cross_join_card(cur.est_cardinality,
                                          nxt.est_cardinality, len(shared))
                cur = JoinPlanNode(left=cur, right=nxt, strategy="hash",
                                   join_vars=shared, est_cardinality=card)
            return cur
        if isinstance(node, LeftJoin):
            left = self._plan_group(node.left, query, graphs, sels)
            right = self._plan_group(node.right, query, graphs, sels)
            shared = sorted(_vars_of(left) & _vars_of(right))
            card_join = cm.cross_join_card(left.est_cardinality,
                                           right.est_cardinality, len(shared))
            return LeftJoinPlanNode(
                left=left, right=right, join_vars=shared,
                est_cardinality=cm.left_join_card(left.est_cardinality,
                                                  card_join))
        if isinstance(node, Union):
            children = [self._plan_group(m, query, graphs, sels)
                        for m in node.members]
            card = cm.union_card([c.est_cardinality for c in children])
            return UnionPlanNode(children=children, est_cardinality=card)
        if not isinstance(node, Filter):
            raise TypeError(f"not a group node: {node!r}")
        child = self._plan_group(node.child, query, graphs, sels)
        card = child.est_cardinality * cm.filter_selectivity(node.expr)
        return FilterPlanNode(expr=node.expr, child=child, est_cardinality=card)

    def _rebind(self, entry: CacheEntry, var_order: tuple[str, ...],
                query: BGPQuery) -> PhysicalPlan:
        """Attach a cached plan to an equivalent incoming query.  Stars keep
        their indices under variable renaming (decomposition groups patterns
        by first occurrence of the subject), so the source selection carries
        over; only variable names inside the plan tree may need rewriting.

        Every hit owns its tree, selection and graph: callers mutate
        est_cardinality/sources/star_sources in place, and aliasing the
        cached copy (or another hit) would corrupt every later hit."""
        cached, cached_order = entry.plan, entry.var_order
        if cached_order == var_order:
            return replace(cached, root=_copy_node(cached.root), query=query,
                           selection=cached.selection.detach(),
                           graph=cached.graph.detach(), cached=True,
                           stats_epoch=entry.epoch)
        ren = dict(zip(cached_order, var_order))
        root = _rename_node(cached.root, ren)
        if query.root is None:
            graph = decompose(query)
        else:
            # algebra plans concatenate per-block star graphs — a shape
            # decompose(query) cannot rebuild — so rename the cached one
            graph = _rename_graph(cached.graph, ren)
            graph.query = query
        return replace(cached, root=root, query=query, graph=graph,
                       selection=cached.selection.detach(), cached=True,
                       stats_epoch=entry.epoch)

    # -- plan emission with subquery merging (§3.4 step iii) ---------------
    def _emit(self, tree: JoinTree, graph: StarGraph, sel: SourceSelection,
              query: BGPQuery) -> PlanNode:
        if tree.kind == "leaf":
            stars = sorted(tree.stars)
            patterns: list[TriplePattern] = []
            for si in stars:
                patterns.extend(order_star_patterns(graph.stars[si], self.stats, sel,
                                                    query.distinct))
            sources = tree.sources if tree.sources is not None else sel.star_sources[stars[0]]
            sources = list(sources)
            # estimate plumb-through for the pipeline's cardinality feedback:
            # a single-star leaf gets the per-source split of its star
            # cardinality; a merged exclusive group joins remotely, so the
            # best attribution is an even split of the group estimate
            if len(stars) == 1:
                per = star_source_cardinalities(graph.stars[stars[0]], self.stats,
                                                sel, query.distinct, sources)
            else:
                n = max(1, len(sources))
                per = [tree.cardinality / n] * len(sources)
            return SubqueryNode(stars=stars, patterns=patterns, sources=sources,
                                est_cardinality=tree.cardinality,
                                est_source_cards=per)
        left = self._emit(tree.left, graph, sel, query)    # type: ignore[arg-type]
        right = self._emit(tree.right, graph, sel, query)  # type: ignore[arg-type]
        join_vars = sorted(_vars_of(left) & _vars_of(right))
        return JoinPlanNode(left=left, right=right, strategy=tree.strategy or "hash",
                            join_vars=join_vars, est_cardinality=tree.cardinality)


def _vars_of(node: PlanNode) -> set[str]:
    if isinstance(node, SubqueryNode):
        out: set[str] = set()
        for tp in node.patterns:
            out |= set(tp.variables())
        return out
    if isinstance(node, (JoinPlanNode, LeftJoinPlanNode)):
        return _vars_of(node.left) | _vars_of(node.right)
    if isinstance(node, UnionPlanNode):
        out = set()
        for c in node.children:
            out |= _vars_of(c)
        return out
    if not isinstance(node, FilterPlanNode):
        raise TypeError(f"not a plan node: {node!r}")
    return _vars_of(node.child) | set(expr_variables(node.expr))


def _offset_stars(node: PlanNode, off: int) -> None:
    """Shift the star indices of one planned block so they index into the
    concatenated plan-level graph (``concat_selections``).  Block trees only
    contain Subquery/Join nodes — composition nodes are added above them."""
    if isinstance(node, SubqueryNode):
        node.stars = [s + off for s in node.stars]
        return
    if not isinstance(node, JoinPlanNode):
        raise TypeError(f"not a block plan node: {node!r}")
    _offset_stars(node.left, off)
    _offset_stars(node.right, off)
