"""Generic hygiene rules: the non-jax bug surface that still bit this repo.

- RPR101 mutable-default-arg: ``def f(x, acc=[])`` — the default is shared
  across calls; one caller's mutation leaks into the next.
- RPR102 broad-except: ``except:`` / ``except Exception:`` without a
  re-raise swallows everything, including the bit-identity assertion errors
  the differential tests exist to surface.  Deliberate record-and-continue
  boundaries (the dry-run sweep, resilience wrappers) suppress with the
  boundary contract as the reason.
- RPR103 assert-in-library: ``assert`` in ``src/`` vanishes under
  ``python -O`` — shape/contract checks that matter must raise.  (Asserts
  in tests and benchmarks are the point, and are not flagged.)
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.core import FileContext, Finding, Rule, register

_MUTABLE_CALLS = {"list", "dict", "set", "OrderedDict", "defaultdict", "Counter"}


@register
class MutableDefaultArg(Rule):
    rule_id = "RPR101"
    name = "mutable-default-arg"
    description = "mutable default argument shared across calls"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                continue
            for default in list(fn.args.defaults) + [
                    d for d in fn.args.kw_defaults if d is not None]:
                if self._is_mutable(default):
                    name = getattr(fn, "name", "<lambda>")
                    yield ctx.finding(
                        self, default,
                        f"mutable default in `{name}`: one call's mutation "
                        "leaks into the next — default to None and build "
                        "inside the body")

    def _is_mutable(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            base = node.func
            name = base.attr if isinstance(base, ast.Attribute) else (
                base.id if isinstance(base, ast.Name) else None)
            return name in _MUTABLE_CALLS
        return False


@register
class BroadExcept(Rule):
    rule_id = "RPR102"
    name = "broad-except"
    description = "bare/broad except without re-raise swallows real failures"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = node.type is None or (
                isinstance(node.type, ast.Name)
                and node.type.id in ("Exception", "BaseException"))
            if not broad:
                continue
            if any(isinstance(sub, ast.Raise) for sub in ast.walk(node)):
                continue
            what = "bare `except:`" if node.type is None else \
                f"`except {node.type.id}:`"
            yield ctx.finding(
                self, node,
                f"{what} without re-raise swallows everything (including "
                "differential-test assertion errors) — narrow the exception "
                "set, or suppress citing the record-and-continue boundary")


@register
class AssertInLibrary(Rule):
    rule_id = "RPR103"
    name = "assert-in-library"
    description = "assert in library code vanishes under python -O"

    def applies(self, ctx: FileContext) -> bool:
        path = ctx.path.replace("\\", "/")
        parts = path.split("/")
        in_src = "src" in parts or "/repro/" in f"/{path}"
        is_test = any(p.startswith("test") or p == "tests" for p in parts)
        return in_src and not is_test

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assert):
                yield ctx.finding(
                    self, node,
                    "`assert` in library code is stripped under `python -O` "
                    "— raise an explicit exception for contract checks that "
                    "must hold in production")
