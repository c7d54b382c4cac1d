"""RPT003 bench-parity: a timed comparison whose two sides cross different
boundaries (the port's answer to the reference's RPR003).

The reference's bug: a kernel benchmark timed a jitted reference against
a bare lambda, charging one side dispatch that the other never paid.  The port's measurements (``chip_smoke.py``,
``scripts/``) time a kernel, its plain version and the library call side
by side, as ``kernel_ms`` (or ``ms``), ``plain_ms`` and ``library_ms``.
Each side's number means something only beside a rival timed the same
way: device time from CUDA events of calls queued behind a sleep
(``queued_ms``), CUDA events around each call (``cuda_ms``), or a host
clock, closed by ``torch.cuda.synchronize()`` or not.

Detection (``chip_smoke.py``, files under ``scripts/``, ``*_bench.py``):

- a *timer* is a function of the module that calls its first parameter
  and reads a clock; its boundary is ``CUDA events queued behind a
  sleep``, ``CUDA events``, ``host clock closed by a sync`` or ``host
  clock``;
- within one function, a value is timed when it is a timer's result (a
  call, or a name bound to one, the first element where a tuple is
  unpacked), or an inline host span ``(time.perf_counter() - t0) ...``
  (closed by a sync when ``synchronize()`` is called between the two
  clock reads);
- a comparison is two timed values in one ``/`` or ``-``, one comparison
  operator, or one row: a dict display or a call's keywords with keys
  ``<p>ms`` / ``<p>kernel_ms``, ``<p>plain_ms`` and ``<p>library_ms`` for
  one prefix ``<p>``.

A comparison whose sides cross different boundaries is flagged.  Values
of unknown origin give no verdict.
"""
from __future__ import annotations

import ast
import re
from typing import Iterable

from repro_torch.analysis.core import FileContext, Finding, Rule, register
from repro_torch.analysis.jitinfo import dotted

_HOST_CLOCKS = {"time.perf_counter", "time.time", "time.monotonic",
                "time.perf_counter_ns", "time.monotonic_ns", "perf_counter"}
_ROW_KEY = re.compile(r"^(?P<prefix>.*?)(?:kernel_|plain_|library_)?ms$")
_QUEUED = "CUDA events of calls queued behind a sleep"
_EVENTS = "CUDA events around each call"
_HOST_SYNC = "a host clock closed by torch.cuda.synchronize()"
_HOST = "a host clock with no sync"


def _is_bench_file(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    return (parts[-1] == "chip_smoke.py" or "scripts" in parts[:-1]
            or parts[-1].endswith("_bench.py"))


def _is_clock(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and dotted(node.func) in _HOST_CLOCKS


def _calls(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == name for n in ast.walk(node))


def _timer_boundary(fn: ast.AST) -> "str | None":
    """The boundary a timer crosses (None: ``fn`` is not a timer)."""
    params = [a.arg for a in fn.args.args]
    if not params:
        return None
    calls_fn = any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                   and n.func.id == params[0] for n in ast.walk(fn))
    if not calls_fn:
        return None
    if _calls(fn, "elapsed_time"):
        return _QUEUED if _calls(fn, "_sleep") else _EVENTS
    if any(_is_clock(n) for n in ast.walk(fn)):
        return _HOST_SYNC if _calls(fn, "synchronize") else _HOST
    return None


class _Scope:
    """The timed values of one function."""

    def __init__(self, fn: ast.AST, timers: "dict[str, str]"):
        self.fn = fn
        self.timers = timers
        self.clock_starts: dict[str, list] = {}    # t0 -> lines of its reads
        self.syncs = [n.lineno for n in ast.walk(fn) if isinstance(n, ast.Call)
                      and isinstance(n.func, ast.Attribute)
                      and n.func.attr == "synchronize"]
        self.names: dict[str, "str | None"] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _is_clock(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.clock_starts.setdefault(t.id, []).append(
                            node.lineno)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    self._bind(t, node.value)

    def _bind(self, target, value) -> None:
        if isinstance(target, (ast.Tuple, ast.List)) and target.elts:
            first = target.elts[0]
            if isinstance(first, ast.Name):
                self._set(first.id, self.boundary(value))
            for other in target.elts[1:]:
                if isinstance(other, ast.Name):
                    self._set(other.id, None)
        elif isinstance(target, ast.Name):
            self._set(target.id, self.boundary(value))

    def _set(self, name: str, boundary: "str | None") -> None:
        # a name bound twice to different boundaries (or once to an unknown
        # value) has no single boundary
        if name in self.names and self.names[name] != boundary:
            boundary = None
        self.names[name] = boundary

    def boundary(self, node: ast.AST) -> "str | None":
        if isinstance(node, ast.Name):
            return self.names.get(node.id)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in self.timers:
            return self.timers[node.func.id]
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Call):
            return self.boundary(node.value)      # queued_ms(f)[0]
        if isinstance(node, ast.BinOp):
            span = self._span(node)
            if span is not None:
                return span
            if isinstance(node.right, ast.Constant):  # ms * 1e3, s / n
                return self.boundary(node.left)
        return None

    def _span(self, node: ast.BinOp) -> "str | None":
        """``time.perf_counter() - t0``: a host span."""
        if not (isinstance(node.op, ast.Sub) and _is_clock(node.left)
                and isinstance(node.right, ast.Name)
                and node.right.id in self.clock_starts):
            return None
        # the read of t0 that this span closes: the last one above it
        before = [ln for ln in self.clock_starts[node.right.id]
                  if ln < node.lineno]
        if not before:
            return None
        start = max(before)
        synced = any(start < line <= node.lineno for line in self.syncs)
        return _HOST_SYNC if synced else _HOST


def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """The nodes of ``fn``, not of the functions nested in it (each is a
    scope of its own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


@register
class BenchParity(Rule):
    """Counterpart of the reference's RPR003 bench-parity."""

    rule_id = "RPT003"
    name = "bench-parity"
    description = ("timed comparison whose sides cross different boundaries "
                   "(CUDA events vs host clock, synced vs not)")

    def applies(self, ctx: FileContext) -> bool:
        return _is_bench_file(ctx.path)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        timers = {}
        for fn in ctx.jit.function_nodes():
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                boundary = _timer_boundary(fn)
                if boundary is not None:
                    timers[fn.name] = boundary
        for fn in ctx.jit.function_nodes():
            if isinstance(fn, ast.Lambda):
                continue
            scope = _Scope(fn, timers)
            yield from self._check_scope(ctx, fn, scope)

    def _check_scope(self, ctx, fn, scope) -> Iterable[Finding]:
        for node in _own_nodes(fn):
            pairs = []
            if isinstance(node, ast.BinOp) and isinstance(
                    node.op, (ast.Div, ast.Sub)) and scope._span(node) is None:
                pairs.append(((None, node.left), (None, node.right)))
            elif isinstance(node, ast.Compare) and len(node.comparators) == 1:
                pairs.append(((None, node.left), (None, node.comparators[0])))
            elif isinstance(node, ast.Dict):
                pairs += self._row_pairs(
                    [(k.value, v) for k, v in zip(node.keys, node.values)
                     if isinstance(k, ast.Constant) and isinstance(k.value, str)])
            elif isinstance(node, ast.Call):
                pairs += self._row_pairs(
                    [(kw.arg, kw.value) for kw in node.keywords if kw.arg])
            for (ka, a), (kb, b) in pairs:
                ba, bb = scope.boundary(a), scope.boundary(b)
                if ba is None or bb is None or ba == bb:
                    continue
                sa = f"`{ka}`" if ka else f"`{ast.unparse(a)}`"
                sb = f"`{kb}`" if kb else f"`{ast.unparse(b)}`"
                yield ctx.finding(
                    self, b,
                    f"{sb} is timed with {bb} and compared with {sa}, timed "
                    f"with {ba}: the two sides cross different boundaries — "
                    "time both with the same timer")

    @staticmethod
    def _row_pairs(items):
        groups: dict[str, list] = {}
        for key, value in items:
            m = _ROW_KEY.match(key)
            if m:
                groups.setdefault(m.group("prefix"), []).append((key, value))
        pairs = []
        for members in groups.values():
            for other in members[1:]:
                pairs.append((members[0], other))
        return pairs
