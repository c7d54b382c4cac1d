"""SPARQL group-graph-pattern algebra.

The conjunctive core is unchanged (``Var``/``Const``/``TriplePattern`` and
``BGPQuery``); on top of it sits a recursive *group tree* covering the
non-conjunctive constructs the Odyssey evaluation queries use:

``Bgp``        a conjunctive block of triple patterns (the DP-planned unit)
``Join``       conjunction of arbitrary sub-groups (``{ G1 . G2 }``)
``LeftJoin``   OPTIONAL (``G1 OPTIONAL { G2 }``); child order is semantic
``Union``      UNION of alternatives (n-ary, flattened)
``Filter``     FILTER over a group, with a small expression language
               (comparisons over term ids, ``&&``/``||``/``!``)

``BGPQuery`` stays the single query type: ``root is None`` means the query is
the degenerate one-node case ``Bgp(patterns)`` and every pre-existing call
site keeps working mechanically; a non-``None`` ``root`` carries the full
tree while ``patterns`` always holds the tree's triple patterns flattened in
tree order (so ``variables()``/``len()`` and structure-agnostic consumers
keep their meaning).

``normalize`` rewrites a tree into the planner's canonical form (see
``docs/algebra.md``):

1. *Union hoisting* — UNION distributes out of Join / Filter / LeftJoin-left
   so each branch becomes an independent (mostly conjunctive) plan problem.
2. *Well-designed OPTIONAL pull-up* — ``Join(LeftJoin(L, R), S)`` is
   rewritten to ``LeftJoin(Join(L, S), R)`` when ``vars(R) ∩ vars(S) ⊆
   vars(L)`` (the well-designedness condition of Pérez et al., applied per
   arm as in arXiv 1810.09780), maximizing the conjunctive core handed to
   the star-decomposition + DP pipeline.  Non-well-designed arms are left
   in place — correctness first, reordering only where licensed.
3. *Filter pushdown* — every conjunct is pushed into the deepest group that
   certainly binds its variables (never into an OPTIONAL arm, always into
   all UNION branches), so FILTER evaluates as early as its variables are
   bound.

Filter semantics are deliberately two-valued over term ids: a comparison
involving an unbound variable (UNDEF) is *false*, ``!`` is plain negation.
The engine and the ``naive_evaluate`` oracle share one evaluator, so plans
and oracle agree by construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Term:
    pass


@dataclass(frozen=True)
class Var(Term):
    name: str  # without leading '?'

    def __repr__(self) -> str:
        return f"?{self.name}"


@dataclass(frozen=True)
class Const(Term):
    tid: int  # term-dictionary id

    def __repr__(self) -> str:
        return f"<{self.tid}>"


@dataclass(frozen=True)
class TriplePattern:
    s: Term
    p: Term
    o: Term

    def variables(self) -> frozenset[str]:
        return frozenset(t.name for t in (self.s, self.p, self.o) if isinstance(t, Var))

    def constants(self) -> tuple[int | None, int | None, int | None]:
        """(s, p, o) with None where unbound — the engine's scan signature."""
        return tuple(t.tid if isinstance(t, Const) else None for t in (self.s, self.p, self.o))  # type: ignore[return-value]

    @property
    def has_var_predicate(self) -> bool:
        return isinstance(self.p, Var)


# --------------------------------------------------------------------------
# Filter expressions
# --------------------------------------------------------------------------

COMPARISON_OPS = ("=", "!=", "<", "<=", ">", ">=")


@dataclass(frozen=True)
class Expr:
    pass


@dataclass(frozen=True)
class Comparison(Expr):
    op: str                       # one of COMPARISON_OPS
    lhs: Term
    rhs: Term

    def __post_init__(self):
        if self.op not in COMPARISON_OPS:
            raise ValueError(f"unknown comparison operator {self.op!r}")

    def __repr__(self) -> str:
        return f"({self.lhs!r} {self.op} {self.rhs!r})"


@dataclass(frozen=True)
class And(Expr):
    parts: tuple[Expr, ...]


@dataclass(frozen=True)
class Or(Expr):
    parts: tuple[Expr, ...]


@dataclass(frozen=True)
class Not(Expr):
    part: Expr


def expr_variables(expr: Expr) -> frozenset[str]:
    if isinstance(expr, Comparison):
        return frozenset(t.name for t in (expr.lhs, expr.rhs) if isinstance(t, Var))
    if isinstance(expr, (And, Or)):
        out: frozenset[str] = frozenset()
        for p in expr.parts:
            out |= expr_variables(p)
        return out
    if not isinstance(expr, Not):
        raise TypeError(f"expected Not, got {expr!r}")
    return expr_variables(expr.part)


def conjuncts(expr: Expr) -> list[Expr]:
    """Flatten nested ``And`` into its conjunct list (pushdown unit)."""
    if isinstance(expr, And):
        out: list[Expr] = []
        for p in expr.parts:
            out.extend(conjuncts(p))
        return out
    return [expr]


# --------------------------------------------------------------------------
# Group tree
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class GroupNode:
    pass


@dataclass(frozen=True)
class Bgp(GroupNode):
    patterns: tuple[TriplePattern, ...]


@dataclass(frozen=True)
class Join(GroupNode):
    children: tuple[GroupNode, ...]


@dataclass(frozen=True)
class LeftJoin(GroupNode):
    left: GroupNode
    right: GroupNode


@dataclass(frozen=True)
class Union(GroupNode):
    members: tuple[GroupNode, ...]


@dataclass(frozen=True)
class Filter(GroupNode):
    expr: Expr
    child: GroupNode


def group_triples(node: GroupNode) -> list[TriplePattern]:
    """All triple patterns of the tree, flattened in tree order."""
    if isinstance(node, Bgp):
        return list(node.patterns)
    if isinstance(node, Join):
        return [tp for c in node.children for tp in group_triples(c)]
    if isinstance(node, LeftJoin):
        return group_triples(node.left) + group_triples(node.right)
    if isinstance(node, Union):
        return [tp for m in node.members for tp in group_triples(m)]
    if not isinstance(node, Filter):
        raise TypeError(f"expected Filter, got {node!r}")
    return group_triples(node.child)


def group_variables(node: GroupNode) -> frozenset[str]:
    """Variables that *may* be bound by the group (pattern variables)."""
    out: frozenset[str] = frozenset()
    for tp in group_triples(node):
        out |= tp.variables()
    return out


def certain_variables(node: GroupNode) -> frozenset[str]:
    """Variables bound in *every* solution of the group: all pattern vars of
    a Bgp, the union across Join children, only the left side of a LeftJoin
    (the OPTIONAL arm may stay unmatched), the intersection across Union
    members, and the child's for Filter.  This is the safety condition for
    filter pushdown and the well-designedness check."""
    if isinstance(node, Bgp):
        out: frozenset[str] = frozenset()
        for tp in node.patterns:
            out |= tp.variables()
        return out
    if isinstance(node, Join):
        out = frozenset()
        for c in node.children:
            out |= certain_variables(c)
        return out
    if isinstance(node, LeftJoin):
        return certain_variables(node.left)
    if isinstance(node, Union):
        if not node.members:
            return frozenset()
        out = certain_variables(node.members[0])
        for m in node.members[1:]:
            out &= certain_variables(m)
        return out
    if not isinstance(node, Filter):
        raise TypeError(f"expected Filter, got {node!r}")
    return certain_variables(node.child)


def _all_vars(node: GroupNode) -> frozenset[str]:
    """Pattern vars plus filter-expression vars — occurrence in the
    well-designedness sense."""
    if isinstance(node, Filter):
        return _all_vars(node.child) | expr_variables(node.expr)
    if isinstance(node, Join):
        out: frozenset[str] = frozenset()
        for c in node.children:
            out |= _all_vars(c)
        return out
    if isinstance(node, LeftJoin):
        return _all_vars(node.left) | _all_vars(node.right)
    if isinstance(node, Union):
        out = frozenset()
        for m in node.members:
            out |= _all_vars(m)
        return out
    if not isinstance(node, Bgp):
        raise TypeError(f"expected Bgp, got {node!r}")
    return group_variables(node)


def is_well_designed(root: GroupNode) -> bool:
    """Pérez et al.'s condition: for every ``LeftJoin(l, r)`` occurrence,
    each variable of ``r`` that also occurs *outside* the LeftJoin must
    occur in ``l``.  Well-designed trees license the OPTIONAL reordering
    ``normalize`` performs (arXiv 1810.09780)."""

    ok = True

    def walk(node: GroupNode, outside: frozenset[str]) -> None:
        nonlocal ok
        if not ok:
            return
        if isinstance(node, LeftJoin):
            lv, rv = _all_vars(node.left), _all_vars(node.right)
            if not (rv & outside) <= lv:
                ok = False
                return
            walk(node.left, outside | rv)
            walk(node.right, outside | lv)
        elif isinstance(node, Join):
            for i, c in enumerate(node.children):
                sib = frozenset()
                for j, d in enumerate(node.children):
                    if j != i:
                        sib |= _all_vars(d)
                walk(c, outside | sib)
        elif isinstance(node, Union):
            for m in node.members:
                walk(m, outside)
        elif isinstance(node, Filter):
            walk(node.child, outside | expr_variables(node.expr))

    walk(root, frozenset())
    return ok


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------


def normalize(node: GroupNode) -> GroupNode:
    """Canonical planning form: unions hoisted, well-designed OPTIONAL arms
    pulled above maximal conjunctive cores, filters pushed to the deepest
    group that certainly binds their variables.  Semantics-preserving under
    the two-valued filter semantics shared by engine and oracle."""
    structured = _structure(node)
    return _push_filters(structured)


def _structure(node: GroupNode) -> GroupNode:
    if isinstance(node, Bgp):
        return node
    if isinstance(node, Filter):
        child = _structure(node.child)
        if isinstance(child, Union):       # FILTER distributes over UNION
            return Union(tuple(_structure(Filter(node.expr, m))
                               for m in child.members))
        return Filter(node.expr, child)
    if isinstance(node, Union):
        members: list[GroupNode] = []
        for m in node.members:
            sm = _structure(m)
            if isinstance(sm, Union):
                members.extend(sm.members)
            else:
                members.append(sm)
        if len(members) == 1:
            return members[0]
        return Union(tuple(members))
    if isinstance(node, LeftJoin):
        left = _structure(node.left)
        right = _structure(node.right)
        if isinstance(left, Union):        # OPTIONAL applies per branch
            return Union(tuple(_structure(LeftJoin(m, right))
                               for m in left.members))
        return LeftJoin(left, right)
    if not isinstance(node, Join):
        raise TypeError(f"expected Join, got {node!r}")
    if not node.children:
        return Bgp(())
    children: list[GroupNode] = []
    filters: list[Expr] = []
    for c in node.children:
        sc = _structure(c)
        # lift filters whose vars the child itself binds; pushdown re-places
        # them at the deepest binder after restructuring
        while isinstance(sc, Filter) and \
                expr_variables(sc.expr) <= group_variables(sc.child):
            filters.append(sc.expr)
            sc = sc.child
        if isinstance(sc, Join):
            children.extend(sc.children)
        else:
            children.append(sc)
    # hoist the first UNION child: Join(..., Union(A, B), ...) ->
    # Union(Join(..., A, ...), Join(..., B, ...)), recursively
    for i, c in enumerate(children):
        if isinstance(c, Union):
            branches = []
            for m in c.members:
                j: GroupNode = Join(tuple(children[:i] + [m] + children[i + 1:]))
                for e in filters:
                    j = Filter(e, j)
                branches.append(_structure(j))
            return Union(tuple(branches))
    # pull well-designed OPTIONAL arms above the join so the conjunctive
    # core is maximal: Join(LeftJoin(L, R), S) -> LeftJoin(Join(L, S), R)
    # when vars(R) ∩ vars(S) ⊆ vars(L)
    arms: list[GroupNode] = []
    changed = True
    while changed:
        changed = False
        for i, c in enumerate(children):
            if not isinstance(c, LeftJoin):
                continue
            sib: frozenset[str] = frozenset()
            for j, d in enumerate(children):
                if j != i:
                    sib |= _all_vars(d)
            for e in filters:
                sib |= expr_variables(e)
            if (_all_vars(c.right) & sib) <= _all_vars(c.left):
                children[i] = c.left
                arms.append(c.right)
                changed = True
                break
    # merge every Bgp child into one conjunctive block (at the position of
    # the first), in child order
    bgp_pats: list[TriplePattern] = []
    merged: list[GroupNode] = []
    bgp_at = -1
    for c in children:
        if isinstance(c, Bgp):
            if bgp_at < 0:
                bgp_at = len(merged)
                merged.append(c)           # placeholder, replaced below
            bgp_pats.extend(c.patterns)
        else:
            merged.append(c)
    if bgp_at >= 0:
        merged[bgp_at] = Bgp(tuple(bgp_pats))
    out: GroupNode = merged[0] if len(merged) == 1 else Join(tuple(merged))
    for arm in arms:
        out = LeftJoin(out, arm)
    for e in filters:
        out = Filter(e, out)
    if isinstance(out, (LeftJoin, Filter)):
        return _structure(out)             # arms/filters may enable more
    return out


def _push_filters(node: GroupNode) -> GroupNode:
    exprs: list[Expr] = []
    while isinstance(node, Filter):
        exprs.extend(conjuncts(node.expr))
        node = node.child
    if isinstance(node, Join):
        node = Join(tuple(_push_filters(c) for c in node.children))
    elif isinstance(node, LeftJoin):
        node = LeftJoin(_push_filters(node.left), _push_filters(node.right))
    elif isinstance(node, Union):
        node = Union(tuple(_push_filters(m) for m in node.members))
    for e in exprs:
        node = _place_filter(e, node)
    return node


def _place_filter(expr: Expr, node: GroupNode) -> GroupNode:
    """Push one conjunct into the deepest group that certainly binds its
    variables.  Never descends into an OPTIONAL arm (that would turn filtered
    rows into unmatched-left survivors); always distributes over UNION."""
    vs = expr_variables(expr)
    if isinstance(node, Union):
        return Union(tuple(_place_filter(expr, m) for m in node.members))
    if isinstance(node, Join):
        for i, c in enumerate(node.children):
            if vs <= certain_variables(c):
                kids = list(node.children)
                kids[i] = _place_filter(expr, c)
                return Join(tuple(kids))
        return Filter(expr, node)
    if isinstance(node, LeftJoin):
        if vs <= certain_variables(node.left):
            return LeftJoin(_place_filter(expr, node.left), node.right)
        return Filter(expr, node)
    if isinstance(node, Filter):
        return Filter(node.expr, _place_filter(expr, node.child))
    return Filter(expr, node)


# --------------------------------------------------------------------------
# Query
# --------------------------------------------------------------------------


@dataclass
class BGPQuery:
    patterns: list[TriplePattern]
    distinct: bool = False
    projection: list[str] = field(default_factory=list)  # empty => all vars
    name: str = ""
    # full group tree; None == the degenerate one-node case Bgp(patterns).
    # When set, `patterns` holds the tree's triples flattened in tree order.
    root: GroupNode | None = None

    def variables(self) -> frozenset[str]:
        out: frozenset[str] = frozenset()
        for tp in self.patterns:
            out |= tp.variables()
        return out

    def effective_projection(self) -> list[str]:
        return self.projection if self.projection else sorted(self.variables())

    def __len__(self) -> int:
        return len(self.patterns)

    def algebra(self) -> GroupNode:
        """The group tree (``Bgp(patterns)`` for the degenerate case)."""
        return self.root if self.root is not None else Bgp(tuple(self.patterns))

    def is_conjunctive(self) -> bool:
        """True iff the query is a plain BGP — the planner's fast path, kept
        bit-identical to the pre-algebra pipeline."""
        return self.root is None or isinstance(normalize(self.root), Bgp)


def from_algebra(root: GroupNode, distinct: bool = False,
                 projection: list[str] | None = None,
                 name: str = "") -> BGPQuery:
    """Build a query from a group tree; ``patterns`` is the flattened triple
    list so structure-agnostic consumers (variable sets, NSS metrics,
    baselines on conjunctive queries) keep working."""
    if isinstance(root, Bgp):
        return BGPQuery(list(root.patterns), distinct=distinct,
                        projection=list(projection or []), name=name)
    return BGPQuery(group_triples(root), distinct=distinct,
                    projection=list(projection or []), name=name, root=root)
