"""Host ("oracle") execution engine: exact, dynamically-shaped numpy
evaluation of physical plans over a federation, with the paper's runtime
metrics (NTT = tuples shipped endpoint->engine, requests, wall time).

The executor of the planning loop (ET / NTT figures).  ``execute`` runs
the operator pipeline (``repro_torch.engine.pipeline``); the recursive
evaluator stays as ``execute_recursive``, the pipeline's oracle.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.planner import (
    FilterPlanNode,
    JoinPlanNode,
    LeftJoinPlanNode,
    PhysicalPlan,
    PlanNode,
    SubqueryNode,
    UnionPlanNode,
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
    TriplePattern,
    Union,
    Var,
)
from repro_torch.rdf.dataset import Federation, Source

Relation = dict[str, np.ndarray]  # same-length columns keyed by var name

# Unbound marker inside int32 relation columns (term ids are non-negative).
# OPTIONAL pads unmatched right columns and UNION pads schema gaps with it;
# comparisons involving it are false (two-valued FILTER semantics, see
# docs/algebra.md).  Normalization's well-designed check guarantees a
# possibly-UNDEF variable never becomes a join key of a reordered plan.
UNDEF = int(np.int32(-1))


def _empty(vars_: "list[str]") -> Relation:
    return {v: np.zeros(0, np.int32) for v in vars_}


def _nrows(rel: Relation) -> int:
    if not rel:
        return 0
    return len(next(iter(rel.values())))


def _concat(rels: "list[Relation]") -> Relation:
    """Union of same-schema relations. Keeps the column structure even when
    every input is empty — an empty-with-columns relation annihilates joins,
    whereas the no-columns relation ``{}`` is the join identity."""
    nonempty = [r for r in rels if _nrows(r)]
    if not nonempty:
        for r in rels:
            if r:
                return {k: v[:0] for k, v in r.items()}
        return {}
    keys = nonempty[0].keys()
    return {k: np.concatenate([r[k] for r in nonempty]) for k in keys}


def _dedup(rel: Relation) -> Relation:
    n = _nrows(rel)
    if n == 0:
        return rel
    keys = sorted(rel.keys())
    stacked = np.stack([rel[k].astype(np.int64) for k in keys], axis=1)
    _, idx = np.unique(stacked, axis=0, return_index=True)
    return {k: rel[k][np.sort(idx)] for k in rel}


def _outer_union(rels: "list[Relation]") -> Relation:
    """UNION of possibly different-schema relations: the output schema is the
    union of the inputs' variables, missing columns padded with UNDEF."""
    allvars = sorted(set().union(*[set(r) for r in rels])) if rels else []
    parts: list[Relation] = []
    for r in rels:
        n = _nrows(r)
        parts.append({v: (r[v] if v in r else np.full(n, UNDEF, np.int32))
                      for v in allvars})
    return _concat(parts)


def filter_mask(expr: Expr, rel: Relation) -> np.ndarray:
    """Row mask of ``expr`` over ``rel`` — the one FILTER evaluator, shared by
    the engine, the oracle and the tests.  Two-valued semantics: a comparison
    whose side is unbound (a missing column or an UNDEF cell) is false, ``!``
    is plain negation, and ordering comparisons are over term ids."""
    n = _nrows(rel)

    def col(t) -> np.ndarray:
        if isinstance(t, Const):
            return np.full(n, t.tid, np.int64)
        c = rel.get(t.name)
        return c.astype(np.int64) if c is not None else np.full(n, UNDEF, np.int64)

    if isinstance(expr, Comparison):
        lv, rv = col(expr.lhs), col(expr.rhs)
        bound = (lv != UNDEF) & (rv != UNDEF)
        ops = {"=": np.equal, "!=": np.not_equal, "<": np.less,
               "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}
        return bound & ops[expr.op](lv, rv)
    if isinstance(expr, And):
        out = np.ones(n, bool)
        for p in expr.parts:
            out &= filter_mask(p, rel)
        return out
    if isinstance(expr, Or):
        out = np.zeros(n, bool)
        for p in expr.parts:
            out |= filter_mask(p, rel)
        return out
    if not isinstance(expr, Not):
        raise TypeError(f"expected Not, got {expr!r}")
    return ~filter_mask(expr.part, rel)


def join_indices(left: Relation,
                 right: Relation) -> "tuple[np.ndarray, np.ndarray]":
    """Row-index pairs ``(li, ri)`` of the inner join on the shared
    variables (cartesian when disjoint).  Emission order is canonical:
    ``li`` ascending, and within one ``li`` the ``ri`` ascending — the
    stable argsort keeps equal-key runs in original order — which is the
    order the operator pipeline reproduces by sorting accumulated pairs."""
    shared = sorted(set(left) & set(right))
    nl, nr = _nrows(left), _nrows(right)
    if not shared:  # cartesian
        li = np.repeat(np.arange(nl), nr)
        ri = np.tile(np.arange(nr), nl)
    else:
        lk = np.stack([left[v].astype(np.int64) for v in shared], axis=1)
        rk = np.stack([right[v].astype(np.int64) for v in shared], axis=1)
        # sort-merge on packed keys
        def pack(a: np.ndarray) -> np.ndarray:
            h = np.zeros(len(a), np.int64)
            for c in range(a.shape[1]):
                h = h * 1_000_003 + a[:, c]
            return h
        hl, hr = pack(lk), pack(rk)
        order_r = np.argsort(hr, kind="stable")
        hr_s = hr[order_r]
        lo = np.searchsorted(hr_s, hl, side="left")
        hi = np.searchsorted(hr_s, hl, side="right")
        cnt = hi - lo
        li = np.repeat(np.arange(nl), cnt)
        ri_pos = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi)]) if cnt.sum() else np.zeros(0, np.int64)
        ri = order_r[ri_pos.astype(np.int64)]
        if shared and len(li):
            # guard against packed-hash collisions: verify equality
            ok = np.ones(len(li), bool)
            for v in shared:
                ok &= left[v][li] == right[v][ri]
            li, ri = li[ok], ri[ok]
    return li, ri


def join_rels(left: Relation, right: Relation) -> Relation:
    if not left:
        return right
    if not right:
        return left
    li, ri = join_indices(left, right)
    out: Relation = {}
    for v in left:
        out[v] = left[v][li]
    for v in right:
        if v not in out:
            out[v] = right[v][ri]
    return out


def left_join_rels(left: Relation, right: Relation) -> Relation:
    """OPTIONAL: the inner join plus every unmatched left row, right-only
    columns padded with UNDEF."""
    if not left:
        return right
    if not right:
        return left
    li, ri = join_indices(left, right)
    matched = np.zeros(_nrows(left), bool)
    matched[li] = True
    un = np.nonzero(~matched)[0]
    out: Relation = {}
    for v in left:
        out[v] = np.concatenate([left[v][li], left[v][un]])
    for v in right:
        if v not in out:
            out[v] = np.concatenate(
                [right[v][ri], np.full(len(un), UNDEF, right[v].dtype)])
    return out


@dataclass
class ExecutionMetrics:
    transferred_tuples: int = 0        # endpoint -> engine rows (NTT)
    requests: int = 0                  # subquery dispatches
    intermediate_rows: int = 0
    wall_ms: float = 0.0
    overflowed: bool = False


@dataclass(frozen=True)
class ExecutionResult:
    """What executing one ``PhysicalPlan`` produced: the result relation,
    the engine's runtime metrics (``ExecutionMetrics`` here,
    ``DistMetrics`` from the distributed engine), the plan it ran, and the
    statistics epoch that plan was emitted under — so serving/failover
    layers can attribute an answer without threading side channels.

    Deprecation shim: iterating unpacks as the legacy ``(rows, metrics)``
    tuple, so out-of-tree ``rows, m = engine.execute(plan)`` callers keep
    working (with a ``DeprecationWarning``) instead of breaking.  Prefer
    the named fields.

    ``card_log`` carries the pipeline's observed-vs-estimated cardinality
    samples (``repro_torch.engine.pipeline.CardObservation``; empty on the
    recursive path) — the signal ``repro_torch.stats.feedback`` turns into
    triggered ``refresh_source`` calls.  ``fallback`` names the engine
    substitution, if any, that produced this result.
    """

    rows: Relation
    metrics: object
    plan: "PhysicalPlan | None" = None
    stats_epoch: int = 0
    card_log: tuple = ()
    fallback: "str | None" = None

    def __iter__(self):
        warnings.warn(
            "unpacking ExecutionResult as a (rows, metrics) tuple is "
            "deprecated; use result.rows / result.metrics",
            DeprecationWarning, stacklevel=2)
        return iter((self.rows, self.metrics))


class LocalEngine:
    """Host execution engine.

    ``execute`` lowers the plan onto the adaptive operator pipeline
    (``repro_torch.engine.pipeline``) — bit-identical rows and NTT/request
    metrics to the recursive evaluator, which survives as
    ``execute_recursive`` (``use_pipeline=False`` routes everything there)
    and remains the differential oracle of the pipeline tests.

    ``scan_policy`` is the pipeline's dispatch order (``"static"`` |
    ``"adaptive"`` | ``"random"``); ``clock`` an optional virtual clock for
    deterministic latency simulation.  Plain ``LocalEngine`` ignores
    injected faults (``honor_faults=False``).
    """

    honor_faults = False

    def __init__(self, fed: Federation, use_pipeline: bool = True,
                 scan_policy: str = "static", clock=None):
        self.fed = fed
        self.use_pipeline = use_pipeline
        self.scan_policy = scan_policy
        self.clock = clock

    # -- pattern / star evaluation at one endpoint ---------------------------
    def _eval_pattern(self, src: Source, tp: TriplePattern,
                      bindings: Relation | None = None) -> Relation:
        s, p, o = tp.constants()
        table = src.table
        out_vars = [t.name for t in (tp.s, tp.p, tp.o) if isinstance(t, Var)]
        if bindings is None or not any(
            isinstance(t, Var) and t.name in bindings for t in (tp.s, tp.p, tp.o)
        ):
            rows = table.scan(s, p, o)
            rel: Relation = {}
            if isinstance(tp.s, Var):
                rel[tp.s.name] = table.s[rows]
            if isinstance(tp.p, Var):
                rel[tp.p.name] = table.p[rows]
            if isinstance(tp.o, Var):
                rel[tp.o.name] = table.o[rows]
            if bindings is not None:
                return self._join(bindings, rel)
            return rel
        # bound evaluation: loop distinct relevant binding rows (bind join)
        join_vars = [v for v in (tp.s, tp.p, tp.o)
                     if isinstance(v, Var) and v.name in bindings]
        jnames = [v.name for v in join_vars]
        stacked = np.stack([bindings[v].astype(np.int64) for v in jnames], axis=1)
        uniq = np.unique(stacked, axis=0)
        parts: list[Relation] = []
        for row in uniq:
            bind = dict(zip(jnames, row.tolist()))
            s2 = bind.get(tp.s.name, s) if isinstance(tp.s, Var) else s
            p2 = bind.get(tp.p.name, p) if isinstance(tp.p, Var) else p
            o2 = bind.get(tp.o.name, o) if isinstance(tp.o, Var) else o
            rows = table.scan(s2, p2, o2)
            rel = {}
            if isinstance(tp.s, Var):
                rel[tp.s.name] = table.s[rows] if tp.s.name not in bind else np.full(len(rows), bind[tp.s.name], np.int32)
            if isinstance(tp.p, Var):
                rel[tp.p.name] = table.p[rows] if tp.p.name not in bind else np.full(len(rows), bind[tp.p.name], np.int32)
            if isinstance(tp.o, Var):
                rel[tp.o.name] = table.o[rows] if tp.o.name not in bind else np.full(len(rows), bind[tp.o.name], np.int32)
            parts.append(rel)
        matches = _concat(parts) if parts else _empty(out_vars)
        return self._join(bindings, matches)

    # -- generic hash join (module-level helpers, shared with the pipeline) --
    def _join_indices(self, left: Relation,
                      right: Relation) -> "tuple[np.ndarray, np.ndarray]":
        return join_indices(left, right)

    def _join(self, left: Relation, right: Relation) -> Relation:
        return join_rels(left, right)

    def _left_join(self, left: Relation, right: Relation) -> Relation:
        return left_join_rels(left, right)

    def _eval_subquery(self, node: SubqueryNode, metrics: ExecutionMetrics,
                       bindings: Relation | None = None) -> Relation:
        """Evaluate the (merged) star subquery at each selected endpoint and
        union — intermediate joins happen remotely, only results ship."""
        full_vars: set[str] = set()
        for tp in node.patterns:
            full_vars |= set(tp.variables())
        if bindings:
            full_vars |= set(bindings)
        parts: list[Relation] = []
        for sid in node.sources:
            src = self.fed.sources[sid]
            rel: Relation | None = bindings
            for tp in node.patterns:
                rel = self._eval_pattern(src, tp, rel)
                if _nrows(rel) == 0 and rel:
                    break
            if rel is None or _nrows(rel) == 0:
                rel = _empty(sorted(full_vars))
            metrics.requests += 1
            metrics.transferred_tuples += _nrows(rel)
            parts.append(rel)
        out = _concat(parts)
        if not out:
            return _empty(sorted(full_vars))
        return out

    def _execute(self, node: PlanNode, metrics: ExecutionMetrics) -> Relation:
        if isinstance(node, SubqueryNode):
            return self._eval_subquery(node, metrics)
        if isinstance(node, LeftJoinPlanNode):
            left = self._execute(node.left, metrics)
            metrics.intermediate_rows += _nrows(left)
            right = self._execute(node.right, metrics)
            metrics.intermediate_rows += _nrows(right)
            return self._left_join(left, right)
        if isinstance(node, UnionPlanNode):
            parts = [self._execute(c, metrics) for c in node.children]
            for p in parts:
                metrics.intermediate_rows += _nrows(p)
            return _outer_union(parts)
        if isinstance(node, FilterPlanNode):
            rel = self._execute(node.child, metrics)
            metrics.intermediate_rows += _nrows(rel)
            m = filter_mask(node.expr, rel)
            return {v: c[m] for v, c in rel.items()}
        if not isinstance(node, JoinPlanNode):
            raise TypeError(f"expected JoinPlanNode, got {node!r}")
        left = self._execute(node.left, metrics)
        metrics.intermediate_rows += _nrows(left)
        if node.strategy == "bind" and isinstance(node.right, SubqueryNode):
            right_bound = self._eval_subquery(node.right, metrics, bindings=left)
            metrics.intermediate_rows += _nrows(right_bound)
            return right_bound
        right = self._execute(node.right, metrics)
        metrics.intermediate_rows += _nrows(right)
        return self._join(left, right)

    def execute(self, plan: PhysicalPlan) -> ExecutionResult:
        if self.use_pipeline:
            from repro_torch.engine.pipeline import compile_plan
            exec_ = compile_plan(plan, self.fed, honor_faults=self.honor_faults,
                                 policy=self.scan_policy, clock=self.clock)
            return exec_.run()
        return self.execute_recursive(plan)

    def execute_recursive(self, plan: PhysicalPlan) -> ExecutionResult:
        """The recursive evaluator — the pipeline's differential oracle
        (bit-identical rows and metrics by contract)."""
        metrics = ExecutionMetrics()
        t0 = time.perf_counter()
        rel = self._execute(plan.root, metrics)
        # query completion (§3.4 step iv): projection + DISTINCT.  Algebra
        # queries fill never-bound projection variables with UNDEF (the
        # oracle does the same); the legacy flat-BGP path keeps its 0-fill.
        fill = 0 if plan.query.root is None else UNDEF
        proj = plan.query.effective_projection()
        rel = {v: rel.get(v, np.full(_nrows(rel), fill, np.int32)) for v in proj}
        if plan.query.distinct:
            rel = _dedup(rel)
        metrics.wall_ms = (time.perf_counter() - t0) * 1e3
        return ExecutionResult(rows=rel, metrics=metrics, plan=plan,
                               stats_epoch=plan.stats_epoch)


# --------------------------------------------------------------------------
# Gold-standard evaluator: the full group algebra over the union of sources
# --------------------------------------------------------------------------

def _naive_group(eng: LocalEngine, src: Source, node: GroupNode) -> Relation:
    """Recursive oracle evaluation of a (raw, un-normalized) group tree over
    one source.  Deliberately structured nothing like the planner: joins
    follow the syntactic order, so differential tests exercise normalization
    and join reordering, not just the operators."""
    if isinstance(node, Bgp):
        rel: Relation = {}
        for tp in node.patterns:
            rel = eng._eval_pattern(src, tp, rel if rel else None)
        return rel
    if isinstance(node, Join):
        rel = {}
        for c in node.children:
            rel = eng._join(rel, _naive_group(eng, src, c))
        return rel
    if isinstance(node, LeftJoin):
        return eng._left_join(_naive_group(eng, src, node.left),
                              _naive_group(eng, src, node.right))
    if isinstance(node, Union):
        return _outer_union([_naive_group(eng, src, m) for m in node.members])
    if not isinstance(node, Filter):
        raise TypeError(f"expected Filter, got {node!r}")
    rel = _naive_group(eng, src, node.child)
    m = filter_mask(node.expr, rel)
    return {v: c[m] for v, c in rel.items()}


def naive_evaluate(fed: Federation, query: BGPQuery) -> set[tuple[int, ...]]:
    from repro_torch.rdf.dataset import TripleTable

    s = np.concatenate([src.table.s for src in fed.sources])
    p = np.concatenate([src.table.p for src in fed.sources])
    o = np.concatenate([src.table.o for src in fed.sources])
    table = TripleTable.from_triples(s, p, o)
    union = Source("union", table)
    eng = LocalEngine(Federation([union], fed.dictionary))
    if query.root is None:
        rel: Relation = {}
        for tp in query.patterns:
            nxt = eng._eval_pattern(union, tp, rel if rel else None)
            rel = nxt
            if _nrows(rel) == 0 and rel:
                break
        fill = 0
    else:
        rel = _naive_group(eng, union, query.algebra())
        fill = UNDEF
    proj = query.effective_projection()
    n = _nrows(rel)
    cols = [rel.get(v, np.full(n, fill, np.int32)) for v in proj]
    return set(zip(*[c.tolist() for c in cols])) if n else set()
