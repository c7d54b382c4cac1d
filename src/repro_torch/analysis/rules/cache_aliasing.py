"""RPR002 cache-aliasing: caches handing out (or storing) shared mutable state.

The bug class: ``PlanCache`` hits returned the *stored* plan tree;
callers mutated ``est_cardinality`` / ``sources`` / ``selection.star_sources``
in place — exactly what failover-style source exclusion does — and silently
corrupted every later hit.  The fix pattern is to detach/deep-copy at the
cache boundary (store pristine, hand out fresh).

Detection: inside a class whose name contains ``Cache`` (or ``Memo``), a
``get``/``put``-shaped method that

- returns a value read straight out of a ``self.<store>`` container
  (``return self._entries[k]`` / ``x = self._entries.get(k); ...; return x``)
  without routing it through a call (``detach``/``deepcopy``/constructor), or
- stores a bare caller-owned parameter into ``self.<store>`` without a
  wrapping call.

Handing out genuinely immutable entries (compiled callables, tuples) is
fine — suppress with a reason stating the immutability contract.

A second check guards *detach completeness*: modules that define a
``PlanNode``-style class hierarchy next to copy/rename detach helpers
(``_copy_node`` / ``_rename_node`` / ``detach``) must reference every
subclass by name inside each helper.  When a new plan-node variant (say
``LeftJoinPlanNode``) is added but the detach helper's dispatch chain is
not extended, cache hits hand out trees whose new nodes alias the stored
entry — the same corruption, one level down.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.core import FileContext, Finding, Rule, register

_GET_NAMES = {"get", "lookup", "fetch", "hit"}
_PUT_NAMES = {"put", "set", "store", "add", "insert"}

# detach-helper shapes: functions whose job is a per-variant deep copy of a
# node tree; every node subclass must appear in each of them
_DETACH_HELPER_NAMES = {"_copy_node", "_rename_node"}
_NODE_BASE_SUFFIX = "PlanNode"


def _is_self_store_read(node: ast.AST) -> bool:
    """``self.<attr>[k]`` or ``self.<attr>.get(k)``."""
    if isinstance(node, ast.Subscript):
        return _is_self_attr(node.value)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in ("get", "setdefault", "pop"):
        return _is_self_attr(node.func.value)
    return False


def _is_self_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self")


@register
class CacheAliasing(Rule):
    rule_id = "RPR002"
    name = "cache-aliasing"
    description = ("cache get/put hands out or stores a shared mutable object "
                   "without detach/deepcopy at the boundary")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            if "Cache" not in cls.name and "Memo" not in cls.name:
                continue
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if meth.name in _GET_NAMES:
                    yield from self._check_get(ctx, cls, meth)
                elif meth.name in _PUT_NAMES:
                    yield from self._check_put(ctx, cls, meth)
        yield from self._check_detach_completeness(ctx)

    def _check_get(self, ctx, cls, meth) -> Iterable[Finding]:
        tainted: set[str] = set()
        for node in ast.walk(meth):
            if isinstance(node, ast.Assign) and _is_self_store_read(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        tainted.add(tgt.id)
            elif isinstance(node, ast.Assign):
                # reassignment from anything else cleanses the name
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        tainted.discard(tgt.id)
            elif isinstance(node, ast.Return) and node.value is not None:
                val = node.value
                direct = _is_self_store_read(val)
                aliased = isinstance(val, ast.Name) and val.id in tainted
                if direct or aliased:
                    yield ctx.finding(
                        self, node,
                        f"`{cls.name}.{meth.name}` returns the stored entry "
                        "itself; a caller mutating it corrupts every later "
                        "hit — detach/deep-copy at the boundary (or suppress "
                        "with the immutability contract as the reason)")

    def _check_detach_completeness(self, ctx) -> Iterable[Finding]:
        """Every ``*PlanNode`` subclass defined in a module must be referenced
        by name inside each of the module's detach helpers (``_copy_node`` /
        ``_rename_node``) — an unhandled variant aliases the cached tree."""
        base_names = {
            cls.name for cls in ctx.tree.body
            if isinstance(cls, ast.ClassDef) and cls.name.endswith(_NODE_BASE_SUFFIX)
            and not any(isinstance(b, ast.Name) and
                        b.id.endswith(_NODE_BASE_SUFFIX) for b in cls.bases)
        }
        subclasses = [
            cls.name for cls in ctx.tree.body
            if isinstance(cls, ast.ClassDef)
            and any(isinstance(b, ast.Name) and b.id in base_names
                    for b in cls.bases)
        ]
        if not subclasses:
            return
        for fn in ctx.tree.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name not in _DETACH_HELPER_NAMES:
                continue
            referenced = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
            for missing in subclasses:
                if missing not in referenced:
                    yield ctx.finding(
                        self, fn,
                        f"detach helper `{fn.name}` does not handle plan-node "
                        f"variant `{missing}`; a cached tree containing one "
                        "would be handed out aliased — extend the dispatch "
                        "chain")

    def _check_put(self, ctx, cls, meth) -> Iterable[Finding]:
        params = {a.arg for a in meth.args.args[1:]}    # skip self
        for node in ast.walk(meth):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and _is_self_attr(tgt.value) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id in params:
                    yield ctx.finding(
                        self, node,
                        f"`{cls.name}.{meth.name}` stores caller-owned "
                        f"`{node.value.id}` directly; the caller keeps a "
                        "reference and can mutate the cached entry — store a "
                        "detached copy")
