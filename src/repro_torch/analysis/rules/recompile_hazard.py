"""RPT004 recompile-hazard: compiled programs and kernel builds that are
made again per call (the port's answer to the reference's RPR004).

The reference's bug was a ``functools.lru_cache`` keyed on the
cost model's *values* over a program builder, so a parameter sweep
compiled, and past 64 entries evicted, one program per tuple.  The
port's forms of the same class:

- ``torch.compile(...)`` called inside a loop (or a comprehension): each
  pass builds a new compiled wrapper, and its guards are checked, or its
  graph compiled, again;
- ``torch.compile(f)(x)``: the wrapper is built and thrown away in one
  expression, so the next execution of the line compiles again;
- ``functools.lru_cache`` / ``functools.cache`` over a function that builds
  or loads a kernel or a compiled program (``torch.compile``, ``nvcc``,
  ``ctypes.CDLL``, ``load_inline``, ``triton.jit``, ``build_kernels``):
  the cache keys on the arguments' values and equality, not on what the
  build depends on (the source and the flags, as ``kernels/build.py``
  keys its libraries), and tensor arguments are hashed by identity.

A cache over a function that builds nothing of the kind, such as DTensor's
cache of sharding decisions (``launch/roofline.py``'s ``lru_cached``), is
not flagged: it keys on structure.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.core import FileContext, Finding, Rule, register
from repro_torch.analysis.jitinfo import dotted

_CACHES = {"lru_cache", "cache"}
_BUILD_MARKERS = ("torch.compile(", "nvcc", "CDLL(", "cdll.", "load_inline(",
                  "cpp_extension.load(", "triton.jit", "build_kernels(")
_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)


def _is_compile(func: ast.AST) -> bool:
    return dotted(func) == "torch.compile"


def _cache_name(node: ast.AST) -> "str | None":
    """``functools.lru_cache(...)`` / ``lru_cache`` / ``functools.cache`` ->
    the cache's name (None when ``node`` is not one)."""
    base = node.func if isinstance(node, ast.Call) else node
    text = dotted(base)
    name = text.split(".")[-1] if text else None
    if name not in _CACHES:
        return None
    if name == "cache" and text not in ("functools.cache", "cache"):
        return None
    return name


@register
class RecompileHazard(Rule):
    """Counterpart of the reference's RPR004 recompile-hazard."""

    rule_id = "RPT004"
    name = "recompile-hazard"
    description = ("torch.compile built per call (in a loop or invoked on "
                   "the spot), or a value-keyed cache over a kernel build")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        defs = {n.name: n for n in ast.walk(ctx.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                yield from self._check_call(ctx, node, defs)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    name = _cache_name(dec)
                    if name and self._builds(node):
                        yield self._cache_finding(ctx, dec, name, node.name)

    def _check_call(self, ctx, call, defs) -> Iterable[Finding]:
        if _is_compile(call.func) and any(
                isinstance(a, _LOOPS) for a in ctx.ancestors(call)):
            yield ctx.finding(
                self, call,
                "`torch.compile` inside a loop builds a new compiled wrapper "
                "each pass (guards rechecked, graphs recompiled) — compile "
                "once outside the loop and reuse it")
        if isinstance(call.func, ast.Call) and _is_compile(call.func.func):
            yield ctx.finding(
                self, call,
                "`torch.compile(f)(...)` builds and discards the compiled "
                "wrapper in one expression: every execution compiles again "
                "— bind the compiled callable once and reuse it")
        # functools.lru_cache(...)(fn): the call form of the decorator
        if isinstance(call.func, ast.Call) and _cache_name(call.func) \
                and call.args and isinstance(call.args[0], ast.Name):
            fn = defs.get(call.args[0].id)
            if fn is not None and self._builds(fn):
                yield self._cache_finding(ctx, call, _cache_name(call.func),
                                          fn.name)

    @staticmethod
    def _builds(fn: ast.AST) -> bool:
        body = "".join(ast.unparse(stmt) for stmt in fn.body)
        return any(m in body for m in _BUILD_MARKERS)

    def _cache_finding(self, ctx, node, name, fn_name) -> Finding:
        return ctx.finding(
            self, node,
            f"`{name}` over `{fn_name}`, which builds or loads a kernel or a "
            "compiled program: the cache keys on argument values (tensors "
            "by identity), not on what the build depends on — key it on the "
            "source and flags, as `kernels/build.py` does")
