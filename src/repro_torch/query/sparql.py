"""A small SPARQL-subset parser and serializer.

    SELECT [DISTINCT] (?v ... | *) WHERE { group }

A group may contain triple patterns over prefixed names / full IRIs /
variables / string literals, '.' separators, nested groups in braces,
``OPTIONAL { ... }``, ``{ ... } UNION { ... }`` chains, and
``FILTER (expr)`` with comparisons (``= != < <= > >=``) over variables and
terms composed with ``&& || !`` and parentheses.  ``serialize_sparql`` is
the inverse: ``parse_sparql(serialize_sparql(q, d), d)`` reconstructs the
same group tree (term ids resolve through the same dictionary).

Recognized-but-unsupported SPARQL constructs (GRAPH, SERVICE, MINUS, BIND,
VALUES, EXISTS, ASK, CONSTRUCT, DESCRIBE) raise a ``ValueError`` naming the
construct, never a bare ``KeyError``.  The optimizer itself consumes
``BGPQuery``; this module keeps examples and round-trip tests runnable
without external dependencies.
"""
from __future__ import annotations

import re

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
    from_algebra,
)
from repro_torch.rdf.dictionary import TermDict, TermKind

_TOKEN = re.compile(
    r"\?[A-Za-z_][\w]*"          # variables
    r"|<[^>\s]*>"                # full IRIs (no whitespace => '<' stays an op)
    r"|\"[^\"]*\""               # string literals
    r"|[A-Za-z_][\w.\-]*:[\w.\-]*"  # prefixed names
    r"|&&|\|\||!=|<=|>=|[{}().!=<>*]"  # operators / punctuation
    r"|[A-Za-z_][\w]*",          # bare keywords (SELECT, OPTIONAL, ...)
)

_UNSUPPORTED = {"GRAPH", "SERVICE", "MINUS", "BIND", "VALUES", "EXISTS",
                "NOT", "ASK", "CONSTRUCT", "DESCRIBE"}


class _Parser:
    def __init__(self, tokens: list[str], dictionary: TermDict):
        self.toks = tokens
        self.i = 0
        self.d = dictionary

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise ValueError("unexpected end of query")
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def expect(self, tok: str) -> None:
        got = self.peek()
        if got is None or got.upper() != tok.upper():
            raise ValueError(f"expected {tok!r} at token {self.i}: "
                             f"{self.toks[max(0, self.i - 2): self.i + 3]}")
        self.i += 1

    def _check_supported(self, tok: str) -> None:
        if tok.upper() in _UNSUPPORTED:
            raise ValueError(
                f"unsupported SPARQL construct '{tok.upper()}' — this subset "
                "covers BGPs, OPTIONAL, UNION and FILTER")

    # -- terms --------------------------------------------------------------
    def term(self, tok: str) -> Term:
        if tok.startswith("?"):
            return Var(tok[1:])
        if tok.startswith("<"):
            return Const(self.d.add(tok[1:-1], TermKind.IRI))
        if tok.startswith('"'):
            return Const(self.d.add(tok[1:-1], TermKind.LITERAL))
        if ":" in tok:  # prefixed name
            return Const(self.d.add(tok, TermKind.IRI))
        self._check_supported(tok)
        raise ValueError(f"expected a term, got {tok!r}")

    # -- filter expressions -------------------------------------------------
    def expr(self) -> Expr:
        return self._or_expr()

    def _or_expr(self) -> Expr:
        parts = [self._and_expr()]
        while self.peek() == "||":
            self.next()
            parts.append(self._and_expr())
        return parts[0] if len(parts) == 1 else Or(tuple(parts))

    def _and_expr(self) -> Expr:
        parts = [self._unary_expr()]
        while self.peek() == "&&":
            self.next()
            parts.append(self._unary_expr())
        return parts[0] if len(parts) == 1 else And(tuple(parts))

    def _unary_expr(self) -> Expr:
        tok = self.peek()
        if tok == "!":
            self.next()
            return Not(self._unary_expr())
        if tok == "(":
            self.next()
            e = self._or_expr()
            self.expect(")")
            return e
        lhs = self.term(self.next())
        op = self.next()
        if op == "=" or op == "!=" or op in ("<", "<=", ">", ">="):
            rhs = self.term(self.next())
            return Comparison(op, lhs, rhs)
        raise ValueError(f"expected a comparison operator, got {op!r}")

    # -- groups -------------------------------------------------------------
    def group(self) -> GroupNode:
        """Parse one ``{ ... }`` group (the opening brace is consumed by the
        caller)."""
        elements: list[GroupNode] = []
        filters: list[Expr] = []
        acc: list[Term] = []
        pats: list[TriplePattern] = []

        def flush_bgp() -> None:
            if acc:
                raise ValueError("dangling terms in BGP")
            if pats:
                elements.append(Bgp(tuple(pats)))
                pats.clear()

        while True:
            tok = self.peek()
            if tok is None:
                raise ValueError("unterminated group: missing '}'")
            up = tok.upper()
            if tok == "}":
                self.next()
                break
            if tok == ".":
                self.next()
                continue
            if up == "OPTIONAL":
                self.next()
                self.expect("{")
                arm = self.group()
                flush_bgp()
                if not elements:
                    base: GroupNode = Bgp(())
                elif len(elements) == 1:
                    base = elements.pop()
                else:
                    base = Join(tuple(elements))
                elements.clear()
                elements.append(LeftJoin(base, arm))
                continue
            if up == "FILTER":
                self.next()
                self.expect("(")
                filters.append(self.expr())
                self.expect(")")
                continue
            if tok == "{":
                self.next()
                g = self.group()
                while self.peek() is not None and self.peek().upper() == "UNION":
                    self.next()
                    self.expect("{")
                    g2 = self.group()
                    if isinstance(g, Union):
                        g = Union(g.members + (g2,))
                    else:
                        g = Union((g, g2))
                flush_bgp()
                elements.append(g)
                continue
            self._check_supported(tok)
            acc.append(self.term(self.next()))
            if len(acc) == 3:
                pats.append(TriplePattern(*acc))
                acc.clear()
        flush_bgp()
        if not elements:
            node: GroupNode = Bgp(())
        elif len(elements) == 1:
            node = elements[0]
        else:
            node = Join(tuple(elements))
        for e in filters:
            node = Filter(e, node)
        return node


def parse_sparql(text: str, dictionary: TermDict) -> BGPQuery:
    p = _Parser(_TOKEN.findall(text), dictionary)
    p.expect("SELECT")
    distinct = False
    if p.peek() is not None and p.peek().upper() == "DISTINCT":
        distinct = True
        p.next()
    projection: list[str] = []
    if p.peek() == "*":
        p.next()
    else:
        while p.peek() is not None and p.peek().startswith("?"):
            projection.append(p.next()[1:])
    p.expect("WHERE")
    p.expect("{")
    root = p.group()
    return from_algebra(root, distinct=distinct, projection=projection)


# --------------------------------------------------------------------------
# Serialization (the parser's inverse)
# --------------------------------------------------------------------------


def _ser_term(t: Term, d: TermDict) -> str:
    if isinstance(t, Var):
        return f"?{t.name}"
    if not isinstance(t, Const):
        raise TypeError(f"not a term: {t!r}")
    text = d.term_of(t.tid)
    if d.kinds[t.tid] == int(TermKind.LITERAL):
        return f'"{text}"'
    if "://" in text or " " in text:
        return f"<{text}>"
    return text if ":" in text else f"<{text}>"


def _ser_expr(e: Expr, d: TermDict) -> str:
    if isinstance(e, Comparison):
        return f"{_ser_term(e.lhs, d)} {e.op} {_ser_term(e.rhs, d)}"
    if isinstance(e, And):
        return " && ".join(f"({_ser_expr(p, d)})" for p in e.parts)
    if isinstance(e, Or):
        return " || ".join(f"({_ser_expr(p, d)})" for p in e.parts)
    if not isinstance(e, Not):
        raise TypeError(f"not a filter expression: {e!r}")
    return f"!({_ser_expr(e.part, d)})"


def _ser_group(node: GroupNode, d: TermDict) -> str:
    """Serialize a group node to the *contents* of a braced group."""
    if isinstance(node, Bgp):
        return " . ".join(
            f"{_ser_term(tp.s, d)} {_ser_term(tp.p, d)} {_ser_term(tp.o, d)}"
            for tp in node.patterns)
    if isinstance(node, Join):
        return " ".join(f"{{ {_ser_group(c, d)} }}" for c in node.children)
    if isinstance(node, LeftJoin):
        left = _ser_group(node.left, d)
        # Filter must stay braced too: an unbraced trailing FILTER would
        # re-parse with the whole group (incl. the OPTIONAL) as its scope
        if isinstance(node.left, (Union, Join, Filter)):
            left = f"{{ {left} }}"
        return f"{left} OPTIONAL {{ {_ser_group(node.right, d)} }}"
    if isinstance(node, Union):
        return " UNION ".join(f"{{ {_ser_group(m, d)} }}" for m in node.members)
    if not isinstance(node, Filter):
        raise TypeError(f"not a group node: {node!r}")
    return f"{_ser_group(node.child, d)} FILTER ({_ser_expr(node.expr, d)})"


def serialize_sparql(query: BGPQuery, dictionary: TermDict) -> str:
    proj = " ".join(f"?{v}" for v in query.projection) if query.projection else "*"
    head = "SELECT DISTINCT" if query.distinct else "SELECT"
    return f"{head} {proj} WHERE {{ {_ser_group(query.algebra(), dictionary)} }}"
