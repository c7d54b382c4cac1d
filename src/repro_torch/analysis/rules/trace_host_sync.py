"""RPT001 trace-host-sync: host syncs inside captured bodies (the port's
answer to the reference's RPR001).

The bug class: ``x.item()`` / ``x.tolist()`` / ``x.cpu()`` / ``x.numpy()``
/ ``float(x)`` / ``int(x)`` / ``bool(x)`` of a tensor inside a body that
runs under capture or replay (an autograd Function's ``forward`` /
``backward``, a ``torch.library`` operator body or its fake, a
``checkpoint`` target, a CUDA-graph capture; see ``jitinfo``).  Under the
dry-run's fake tensors it raises; under a graph capture it is illegal;
under autograd and ``checkpoint`` replay it silently waits for the card
once per call, the per-layer round trip the reference's RPR001 exists to
catch.

Python scalars are not tensors, so a coercion of a *host* value is not
flagged.  A value is host when every leaf of its expression is:

- a constant, or a module-level name bound to one;
- a parameter annotated with a scalar type (``int``, ``float``, ``bool``,
  ``str``, optionally ``| None``);
- an operator parameter whose ``schema=`` type is not a ``Tensor`` (the
  launchers' ``int(bool(causal)), int(window)``);
- a parameter of a module-private function (``_name``) that every call in
  the module passes a host value, propagated to a fixpoint;
- tensor metadata: ``.shape`` / ``.ndim`` / ``.dtype`` / ``.device``,
  ``.dim()`` / ``.numel()`` / ``.size()`` / ``.stride()`` /
  ``.data_ptr()`` / ``.element_size()``, ``len(...)``;
- a local name every assignment of which in its function is host, or the
  index of an ``enumerate`` / ``range`` loop over host bounds.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.core import FileContext, Finding, Rule, register
from repro_torch.analysis.jitinfo import JitInfo

_COERCIONS = {"float", "int", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_META_ATTRS = {"shape", "ndim", "dtype", "device", "itemsize", "is_cuda",
               "requires_grad", "layout"}
_META_METHODS = {"dim", "numel", "size", "stride", "data_ptr",
                 "element_size", "is_contiguous", "get_device",
                 "is_floating_point", "nelement"}
_HOST_CALLS = {"len", "int", "float", "bool", "abs", "min", "max", "round",
               "str", "range", "isinstance"}
_SCALAR_WORDS = {"int", "float", "bool", "str", "None", "Optional",
                 "typing", "complex"}


def _is_scalar_annotation(ann: "ast.AST | None") -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        text = ann.value
    else:
        text = ast.unparse(ann)
    words = [w for w in text.replace("|", " ").replace("[", " ")
             .replace("]", " ").replace(",", " ").replace(".", " ").split()]
    return bool(words) and all(w in _SCALAR_WORDS for w in words) \
        and any(w != "None" for w in words)


def _params(fn: ast.AST) -> "list[ast.arg]":
    a = fn.args
    return list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)


def _positional(fn: ast.AST) -> "list[str]":
    a = fn.args
    return [p.arg for p in list(a.posonlyargs) + list(a.args)]


def _module_constants(tree: ast.Module) -> "set[str]":
    out = set()
    for stmt in tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            value = stmt.value
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            if value is not None and _all_constant(value):
                for t in targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _all_constant(node: ast.AST) -> bool:
    return all(isinstance(s, (ast.Constant, ast.Tuple, ast.List, ast.UnaryOp,
                              ast.BinOp, ast.unaryop, ast.operator, ast.Load))
               for s in ast.walk(node))


class HostValues:
    """Which names of each function of one module hold Python scalars."""

    def __init__(self, tree: ast.Module, jit: JitInfo):
        self.tree = tree
        self.jit = jit
        self.consts = _module_constants(tree)
        self._host: dict[int, set[str]] = {}
        self._calls = self._call_sites()
        self._assigns = {id(fn): self._assignments(fn)
                         for fn in jit.function_nodes()
                         if not isinstance(fn, ast.Lambda)}
        changed = True
        while changed:
            changed = False
            for fn in jit.function_nodes():
                got = self._infer(fn)
                if got != self._host.get(id(fn)):
                    self._host[id(fn)] = got
                    changed = True

    def names(self, fn: ast.AST) -> "set[str]":
        return self._host.get(id(fn), set())

    # -- call sites of module-private functions ------------------------------

    def _call_sites(self) -> "dict[str, list[tuple[ast.Call, ast.AST]]]":
        """Name -> [(call, calling function)] for calls ``_name(...)``.  A
        private name also used other than as a callee (passed on, stored)
        is left out: its callers are not all in sight."""
        sites: dict = {}
        escaped = set()
        owner: dict[int, ast.AST] = {}
        # the innermost function wins: outer functions come first in source
        # order, and the ones nested in them overwrite their nodes
        for fn in sorted(self.jit.function_nodes(),
                         key=lambda f: (f.lineno, f.col_offset)):
            for node in ast.walk(fn):
                owner[id(node)] = fn
        callees = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                callees.add(id(node.func))
                if node.func.id.startswith("_"):
                    sites.setdefault(node.func.id, []).append(
                        (node, owner.get(id(node))))
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Name) and node.id.startswith("_") \
                    and id(node) not in callees \
                    and isinstance(node.ctx, ast.Load):
                escaped.add(node.id)
        return {k: v for k, v in sites.items() if k not in escaped}

    def _site_host(self, fn: ast.AST, idx: "int | None", name: str) -> bool:
        """Does every call of ``fn`` in the module pass a host value (or
        leave a constant default) for parameter ``name``?"""
        fname = getattr(fn, "name", None)
        sites = self._calls.get(fname or "")
        if not fname or not sites:
            return False
        defaults = self._defaults(fn)
        for call, caller in sites:
            if any(isinstance(a, ast.Starred) for a in call.args) or any(
                    kw.arg is None for kw in call.keywords):
                return False
            arg = None
            if idx is not None and idx < len(call.args):
                arg = call.args[idx]
            for kw in call.keywords:
                if kw.arg == name:
                    arg = kw.value
            if arg is None:
                if name not in defaults or not _all_constant(defaults[name]):
                    return False
                continue
            host = self.names(caller) if caller is not None else set()
            if not self.is_host(arg, host):
                return False
        return True

    @staticmethod
    def _defaults(fn: ast.AST) -> "dict[str, ast.AST]":
        a = fn.args
        pos = list(a.posonlyargs) + list(a.args)
        out = {p.arg: d for p, d in zip(pos[len(pos) - len(a.defaults):],
                                        a.defaults)}
        out.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults)
                    if d is not None})
        return out

    # -- per-function inference ---------------------------------------------

    def _infer(self, fn: ast.AST) -> "set[str]":
        host: set[str] = set()
        enc = self.jit.enclosing(fn)
        if enc is not None:
            host |= self.names(enc)
        schema = self.jit.schema_params(fn)
        positional = _positional(fn)
        for p in _params(fn):
            host.discard(p.arg)                 # shadows an enclosing name
            typ = schema.get(p.arg)
            if typ is not None and not typ.startswith("Tensor"):
                host.add(p.arg)
            elif _is_scalar_annotation(p.annotation):
                host.add(p.arg)
            elif isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                idx = positional.index(p.arg) if p.arg in positional else None
                if self._site_host(fn, idx, p.arg):
                    host.add(p.arg)
        if isinstance(fn, ast.Lambda):
            return host
        assigns = self._assigns[id(fn)]
        local: set[str] = set()
        changed = True
        while changed:
            changed = False
            for name, bindings in assigns.items():
                if name in local:
                    continue
                if all(self._bound_host(b, host | local) for b in bindings):
                    local.add(name)
                    changed = True
        return (host - set(assigns)) | local

    def _bound_host(self, binding, host: "set[str]") -> bool:
        """A binding is a list of ``(expr, scope)`` that must all be host;
        ``scope`` None is the function itself, else the callee whose return
        value the expression is."""
        if binding is None:
            return False
        return all(self.is_host(expr, host if scope is None
                                else self.names(scope))
                   for expr, scope in binding)

    def _returned_tuple(self, value: ast.AST, n: int):
        """For ``value`` a call of this module's function ``_f`` whose every
        ``return`` is an ``n``-tuple display: per element, the ``(expr,
        callee)`` pairs (one per return)."""
        if not (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)):
            return None
        fns = self.jit.functions_named(value.func.id)
        if len(fns) != 1:
            return None
        fn = fns[0]
        rets = [r.value for r in self._own_nodes(fn) if isinstance(r, ast.Return)]
        if not rets or not all(isinstance(r, ast.Tuple) and len(r.elts) == n
                               for r in rets):
            return None
        return [[(r.elts[i], fn) for r in rets] for i in range(n)]

    def _assignments(self, fn: ast.AST) -> "dict[str, list]":
        """Local name -> its bindings (see ``_bound_host``)."""
        out: dict[str, list] = {}

        def bind(target, binding):
            if isinstance(target, ast.Name):
                out.setdefault(target.id, []).append(binding)
            elif isinstance(target, (ast.Tuple, ast.List)):
                n = len(target.elts)
                parts = [None] * n
                if binding is not None and len(binding) == 1:
                    expr, scope = binding[0]
                    if self._is_meta(expr):         # B, S, D = x.shape
                        parts = [binding] * n
                    elif isinstance(expr, (ast.Tuple, ast.List)) \
                            and len(expr.elts) == n:
                        parts = [[(e, scope)] for e in expr.elts]
                    elif scope is None:
                        parts = self._returned_tuple(expr, n) or parts
                for elt, part in zip(target.elts, parts):
                    bind(elt, part)
            elif isinstance(target, ast.Starred):
                bind(target.value, None)

        for node in self._own_nodes(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    bind(t, [(node.value, None)])
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                bind(node.target, [(node.value, None)])
            elif isinstance(node, ast.AugAssign):
                bind(node.target, [(node.value, None)])
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                bind(node.target, self._loop_value(node))
            elif isinstance(node, ast.withitem) and node.optional_vars:
                bind(node.optional_vars, None)
            elif isinstance(node, ast.NamedExpr):
                bind(node.target, [(node.value, None)])
        return out

    @staticmethod
    def _loop_value(loop):
        """``range(n)`` binds a host index (when ``n`` is host);
        ``enumerate(xs)`` binds a host count and an unknown item."""
        it = loop.iter
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name):
            if it.func.id == "range":
                return [(it, None)]
            if it.func.id == "enumerate" and isinstance(loop.target, ast.Tuple) \
                    and len(loop.target.elts) == 2:
                return [(ast.Tuple(elts=[ast.Constant(0), ast.Name("<item>")],
                                   ctx=ast.Load()), None)]
        return None

    def _own_nodes(self, fn: ast.AST) -> Iterable[ast.AST]:
        """The nodes of ``fn``'s body, not of functions nested in it."""
        stack = list(fn.body) if isinstance(fn.body, list) else [fn.body]
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (*_FUNC_TYPES, ast.ClassDef)):
                    stack.append(child)

    # -- expressions ----------------------------------------------------------

    @staticmethod
    def _is_meta(node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
            return True
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _META_METHODS)

    def is_host(self, node: "ast.AST | None", host: "set[str]") -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Name):
            return node.id in host or node.id in self.consts
        if self._is_meta(node):
            return all(self.is_host(a, host) for a in
                       getattr(node, "args", []))
        if isinstance(node, ast.Subscript):
            return self.is_host(node.value, host) and \
                self.is_host(node.slice, host)
        if isinstance(node, ast.Slice):
            return all(self.is_host(p, host) for p in
                       (node.lower, node.upper, node.step) if p is not None)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) and node.func.id in _HOST_CALLS:
                if node.func.id == "len":
                    return True
                return all(self.is_host(a, host) for a in node.args) and all(
                    self.is_host(k.value, host) for k in node.keywords)
            return False
        if isinstance(node, ast.BinOp):
            return self.is_host(node.left, host) and \
                self.is_host(node.right, host)
        if isinstance(node, ast.UnaryOp):
            return self.is_host(node.operand, host)
        if isinstance(node, ast.BoolOp):
            return all(self.is_host(v, host) for v in node.values)
        if isinstance(node, ast.Compare):
            return self.is_host(node.left, host) and all(
                self.is_host(c, host) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return all(self.is_host(p, host) for p in
                       (node.test, node.body, node.orelse))
        if isinstance(node, (ast.Tuple, ast.List)):
            return all(self.is_host(e, host) for e in node.elts)
        if isinstance(node, ast.JoinedStr):
            return True
        return False


_FUNC_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


@register
class TraceHostSync(Rule):
    """Counterpart of the reference's RPR001 trace-host-sync."""

    rule_id = "RPT001"
    name = "trace-host-sync"
    description = ("host sync (.item()/.tolist()/.cpu()/.numpy()/float/int/"
                   "bool of a tensor) inside a captured or replayed body")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        bodies = ctx.jit.traced_bodies()
        if not bodies:
            return
        values = HostValues(ctx.tree, ctx.jit)
        seen: set[int] = set()
        for body in bodies:
            where = getattr(body, "name", None) or (
                "<lambda>" if isinstance(body, ast.Lambda)
                else "the graph capture")
            scope = body if isinstance(body, _FUNC_TYPES) else next(
                (a for a in ctx.ancestors(body) if isinstance(a, _FUNC_TYPES)),
                None)           # a capture region reads its function's names
            host = values.names(scope) if scope is not None else set()
            for node in self._own_calls(ctx, body):
                if id(node) in seen:
                    continue
                seen.add(id(node))
                hit = self._classify(node, values, host)
                if hit:
                    yield ctx.finding(
                        self, node,
                        f"{hit} inside captured `{where}` waits for the card "
                        "(or fails on fake tensors and under graph capture); "
                        "keep the value on the device or take it before the "
                        "capture boundary")

    @staticmethod
    def _own_calls(ctx, body) -> Iterable[ast.Call]:
        """Calls in ``body`` outside the functions nested in it (those are
        traced bodies of their own, with their own host names)."""
        stack = list(ast.iter_child_nodes(body))
        while stack:
            node = stack.pop()
            if isinstance(node, _FUNC_TYPES):
                continue
            if isinstance(node, ast.Call):
                yield node
            stack.extend(ast.iter_child_nodes(node))

    @staticmethod
    def _classify(call: ast.Call, values: HostValues, host) -> "str | None":
        func = call.func
        if isinstance(func, ast.Name) and func.id in _COERCIONS:
            if len(call.args) == 1 and not call.keywords \
                    and not values.is_host(call.args[0], host):
                return f"`{func.id}(...)`"
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS \
                and not call.args and not call.keywords:
            return f"`.{func.attr}()`"
        return None
