"""Capture-boundary inference for the port: "does this body run under
capture or replay?"

The counterpart of ``repro.analysis.jitinfo``.  Purely syntactic, per
module.  A function (or lambda) is considered *traced* when it is

- ``forward`` / ``backward`` of a ``torch.autograd.Function`` subclass
  (run under autograd, and traced by the compiler and the dry-run's fake
  tensors),
- the body of a ``torch.library`` operator: the function given to
  ``custom_op`` (call or decorator form) or to ``register_fake`` (the
  dry-run runs these on fake tensors and DTensors),
- the target of ``torch.utils.checkpoint.checkpoint``, replayed in the
  backward pass,
- defined lexically inside a traced function, or
- called by name (or as ``self.<name>`` / ``cls.<name>``) from a traced
  body in the same module, propagated to a fixpoint.

Besides functions, a ``with torch.cuda.graph(...):`` block is a traced
*region*: its statements are captured once and replayed, and the
functions it calls by name are traced.

Unlike the reference, an attribute call on another object
(``torch.ops.repro_torch.flash_attention(...)``, ``L.rmsnorm(...)``)
does not mark a same-module function of that name: the call reaches the
other object, not this module's definition.

For an operator registered with a ``schema=`` string, ``schema_params``
gives the schema's type of each parameter by name (an f-string schema is
resolved through the module's string constants), so rules can tell a
``Tensor`` argument from an ``int`` or ``bool`` one.

False negatives are accepted by design (cross-module reachability is out
of scope); false positives are kept near zero.
"""
from __future__ import annotations

import ast

_FUNCTION_BASES = {"Function"}          # torch.autograd.Function
_FUNCTION_METHODS = {"forward", "backward"}
_OP_FACTORIES = {"custom_op"}
_OP_REGISTRARS = {"register_fake"}
_FUNC_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _terminal_name(node: ast.AST) -> "str | None":
    """`torch.library.custom_op` -> 'custom_op', `checkpoint` -> 'checkpoint'."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def dotted(node: ast.AST) -> str:
    """`torch.utils.checkpoint.checkpoint` -> that text ('' if not a name)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _str_constants(tree: ast.Module) -> "dict[str, str]":
    """Module-level ``NAME = "text"`` (or an f-string of such names)."""
    out: dict[str, str] = {}
    for stmt in tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            text = resolve_str(stmt.value, out)
            if text is not None:
                out[stmt.targets[0].id] = text
    return out


def resolve_str(node: ast.AST, consts: "dict[str, str]") -> "str | None":
    """The text of a string constant, a name bound to one, an f-string or
    a ``+`` of such parts; None when any part is not known."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.FormattedValue):
                if v.format_spec is not None or v.conversion not in (-1, None):
                    return None
                v = v.value
            text = resolve_str(v, consts)
            if text is None:
                return None
            parts.append(text)
        return "".join(parts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = resolve_str(node.left, consts)
        right = resolve_str(node.right, consts)
        if left is not None and right is not None:
            return left + right
    return None


def parse_schema(schema: str) -> "dict[str, str]":
    """``"(Tensor q, int window, float scale) -> Tensor"`` ->
    ``{"q": "Tensor", "window": "int", "scale": "float"}``."""
    head = schema.split("->")[0].strip()
    if not (head.startswith("(") and head.endswith(")")):
        return {}
    out: dict[str, str] = {}
    for arg in head[1:-1].split(","):
        arg = arg.split("=")[0].strip()
        if not arg or arg == "*":
            continue
        words = arg.split()
        if len(words) >= 2:
            out[words[-1]] = " ".join(words[:-1])
    return out


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        text = dotted(base)
        if _terminal_name(base) in _FUNCTION_BASES and (
                text == "Function" or text.endswith("autograd.Function")):
            return True
    return False


class JitInfo:
    """Traced-body inference for one module AST (see the module docstring)."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self._funcs: dict[int, ast.AST] = {}
        self._by_name: dict[str, list[ast.AST]] = {}
        self._enclosing: dict[int, ast.AST] = {}   # func node -> nearest func
        self._traced: set[int] = set()
        self._regions: list[ast.With] = []
        self._schemas: dict[int, dict[str, str]] = {}
        self._consts = _str_constants(tree)
        self._checkpoint_names = self._imported_checkpoints()
        self._collect()
        self._seed_roots()
        self._propagate()

    # -- public ------------------------------------------------------------

    def traced_functions(self) -> list[ast.AST]:
        return [n for n in self._funcs.values() if id(n) in self._traced]

    def function_nodes(self) -> list[ast.AST]:
        return list(self._funcs.values())

    def capture_regions(self) -> "list[ast.With]":
        """The ``with torch.cuda.graph(...):`` blocks of the module."""
        return list(self._regions)

    def traced_bodies(self) -> list[ast.AST]:
        """Traced functions and capture regions, in source order."""
        bodies = self.traced_functions() + self.capture_regions()
        return sorted(bodies, key=lambda n: (n.lineno, n.col_offset))

    def schema_params(self, func_node: ast.AST) -> "dict[str, str]":
        """Parameter name -> schema type for an operator body registered
        with a ``schema=`` string (empty otherwise)."""
        return self._schemas.get(id(func_node), {})

    def functions_named(self, name: str) -> list[ast.AST]:
        return list(self._by_name.get(name, []))

    def enclosing(self, func_node: ast.AST) -> "ast.AST | None":
        """The function ``func_node`` is defined in (None at module level)."""
        return self._enclosing.get(id(func_node))

    # -- construction ------------------------------------------------------

    def _imported_checkpoints(self) -> "set[str]":
        names = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("torch.utils.checkpoint"):
                for alias in node.names:
                    if alias.name == "checkpoint":
                        names.add(alias.asname or alias.name)
        return names

    def _collect(self) -> None:
        stack: list[ast.AST] = []

        def visit(node: ast.AST) -> None:
            is_func = isinstance(node, _FUNC_TYPES)
            if is_func:
                self._funcs[id(node)] = node
                if stack:
                    self._enclosing[id(node)] = stack[-1]
                name = getattr(node, "name", None)
                if name:
                    self._by_name.setdefault(name, []).append(node)
                stack.append(node)
            for child in ast.iter_child_nodes(node):
                visit(child)
            if is_func:
                stack.pop()

        visit(self.tree)

    def _resolve(self, expr: ast.AST) -> list[ast.AST]:
        """The functions of this module a callable expression names."""
        if isinstance(expr, ast.Lambda):
            return [expr]
        if isinstance(expr, ast.Name):
            return self._by_name.get(expr.id, [])
        if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
                and expr.value.id in ("self", "cls")):
            return self._by_name.get(expr.attr, [])
        return []

    def _mark(self, expr: ast.AST, schema: "dict[str, str] | None" = None) -> None:
        for fn in self._resolve(expr):
            self._traced.add(id(fn))
            if schema:
                self._schemas[id(fn)] = schema

    def _is_checkpoint(self, func: ast.AST) -> bool:
        if isinstance(func, ast.Name):
            return func.id in self._checkpoint_names
        return dotted(func).endswith("checkpoint.checkpoint")

    def _is_graph_capture(self, expr: ast.AST) -> bool:
        return (isinstance(expr, ast.Call)
                and dotted(expr.func).endswith("cuda.graph"))

    def _op_schema(self, call: ast.Call) -> "dict[str, str] | None":
        for kw in call.keywords:
            if kw.arg == "schema":
                text = resolve_str(kw.value, self._consts)
                return parse_schema(text) if text is not None else None
        return None

    def _seed_roots(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef) and _is_autograd_function(node):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and item.name in _FUNCTION_METHODS:
                        self._traced.add(id(item))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    name = _terminal_name(target)
                    if name in _OP_FACTORIES or name in _OP_REGISTRARS:
                        self._traced.add(id(node))
                        schema = (self._op_schema(dec)
                                  if isinstance(dec, ast.Call) else None)
                        if schema:
                            self._schemas[id(node)] = schema
            elif isinstance(node, ast.With):
                if any(self._is_graph_capture(item.context_expr)
                       for item in node.items):
                    self._regions.append(node)
            elif isinstance(node, ast.Call):
                self._seed_call(node)

    def _seed_call(self, call: ast.Call) -> None:
        name = _terminal_name(call.func)
        if name in _OP_FACTORIES:
            schema = self._op_schema(call)
            fns = call.args[1:2] + [kw.value for kw in call.keywords
                                    if kw.arg == "fn"]
            for fn in fns:
                self._mark(fn, schema)
        elif name in _OP_REGISTRARS:
            for arg in call.args:
                self._mark(arg)
        elif self._is_checkpoint(call.func):
            if call.args:
                self._mark(call.args[0])

    def _propagate(self) -> None:
        """Worklist to a fixpoint: a def nested in a traced body is traced
        (lexical nesting), and so is a same-module function a traced body
        calls by name."""
        nested: dict[int, list] = {}
        for fid, enc in self._enclosing.items():
            nested.setdefault(id(enc), []).append(self._funcs[fid])
        todo = self.traced_functions() + list(self._regions)
        while todo:
            body = todo.pop()
            reached = list(nested.get(id(body), []))
            for call in ast.walk(body):
                if isinstance(call, ast.Call):
                    reached += [fn for fn in self._resolve(call.func)
                                if not isinstance(fn, ast.Lambda)]
            for fn in reached:
                if id(fn) not in self._traced:
                    self._traced.add(id(fn))
                    todo.append(fn)
