"""RPT005 x64-discipline: the DP's float64 contract in the port (the
port's answer to the reference's RPR005).

The reference's bug class: the DP prices in float64 to stay bit-identical
to the numpy sweep, and jax silently downcast to float32 outside
``enable_x64``.  The port has no ``enable_x64``; its contract (ROADMAP's
ground rules) has three parts, and each can break without an error, only
with plans that drift off the numpy oracle on tie-breaks:

- **nvcc flags.**  Every CUDA source that prices costs is built with
  ``--fmad=false``, so nvcc contracts no multiply-add into an FMA.  A
  module-level ``*NVCC*FLAGS*`` must hold ``--fmad=false`` (and no
  ``--fmad=true`` or fast-math flag), and every command list that runs
  nvcc (its first element ``_nvcc()`` or ``"nvcc"``) must splat such flags or
  hold ``--fmad=false`` itself.
- **The plain DP versions** (``*_plain`` functions under ``kernels/`` that
  compute in float64, and the same-module functions they call) keep the
  numpy forms' operation association: no fused ``addcmul`` / ``addcdiv``
  and no ``torch.compile`` (which may fuse and reassociate).
- **No silent float32 under ``kernels/``.**  A tensor built from Python
  floats (``torch.tensor(0.5)``, ``torch.full(shape, float("inf"))``,
  ``torch.arange(0.0, ...)``, any ``linspace`` / ``logspace``) without an
  explicit ``dtype=`` takes torch's float32 default, the port's form of
  ``jnp`` without x64.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.core import FileContext, Finding, Rule, register
from repro_torch.analysis.jitinfo import dotted

_FMAD_OFF = "--fmad=false"
_FORBIDDEN_FLAGS = ("--fmad=true", "-fmad=true", "--use_fast_math",
                    "-use_fast_math")
_FUSED = {"addcmul", "addcmul_", "addcdiv", "addcdiv_"}
_FLOAT_BUILDERS = {"tensor", "as_tensor", "full", "scalar_tensor", "arange"}
_ALWAYS_FLOAT = {"linspace", "logspace"}
_FLOAT_NAMES = {"inf", "nan", "pi", "e"}        # math.inf, math.pi, ...


def _is_kernels_file(path: str) -> bool:
    return "kernels" in path.replace("\\", "/").split("/")[:-1]


def _is_flags_name(name: str) -> bool:
    upper = name.upper()
    return "NVCC" in upper and "FLAGS" in upper


def _constants(node: ast.AST) -> "list[str]":
    return [n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def _runs_nvcc(elt: ast.AST) -> bool:
    if isinstance(elt, ast.Call):
        name = dotted(elt.func).split(".")[-1]
        return "nvcc" in name.lower()
    return (isinstance(elt, ast.Constant) and isinstance(elt.value, str)
            and (elt.value == "nvcc" or elt.value.endswith("/nvcc")))


def _has_float_literal(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, float):
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id == "float":
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in _FLOAT_NAMES \
                and dotted(sub.value) == "math":
            return True
    return False


def _mentions_float64(fn: ast.AST) -> bool:
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Attribute) and sub.attr in ("float64", "double"):
            return True
        if isinstance(sub, ast.Constant) and sub.value == "float64":
            return True
    return False


@register
class X64Discipline(Rule):
    """Counterpart of the reference's RPR005 x64-discipline."""

    rule_id = "RPT005"
    name = "x64-discipline"
    description = ("the DP's float64 contract: --fmad=false on every nvcc "
                   "path, no fused addcmul/addcdiv or torch.compile in the "
                   "plain DP versions, no float tensor without a dtype in "
                   "kernels")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        yield from self._check_flags(ctx)
        if _is_kernels_file(ctx.path):
            yield from self._check_plain_dp(ctx)
            yield from self._check_float_builders(ctx)

    # -- nvcc flags -----------------------------------------------------------

    def _check_flags(self, ctx) -> Iterable[Finding]:
        flag_names = set()
        for stmt in ctx.tree.body:
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                if isinstance(t, ast.Name) and _is_flags_name(t.id) \
                        and stmt.value is not None:
                    flag_names.add(t.id)
                    yield from self._check_flag_set(ctx, stmt.value, t.id)
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.List, ast.Tuple)) and node.elts \
                    and _runs_nvcc(node.elts[0]):
                yield from self._check_command(ctx, node, flag_names)

    def _check_flag_set(self, ctx, value, name) -> Iterable[Finding]:
        sets = (list(value.values) if isinstance(value, ast.Dict)
                else [value])
        for flags in sets:
            consts = _constants(flags)
            bad = [c for c in consts if c in _FORBIDDEN_FLAGS]
            if bad or _FMAD_OFF not in consts:
                why = (f"holds `{bad[0]}`" if bad
                       else f"lacks `{_FMAD_OFF}`")
                yield ctx.finding(
                    self, flags,
                    f"nvcc flag set `{name}` {why}: nvcc then contracts "
                    "multiply-adds into FMAs and the DP kernels' costs stop "
                    "matching the host DP bit for bit")

    def _check_command(self, ctx, cmd, flag_names) -> Iterable[Finding]:
        consts = _constants(cmd)
        bad = [c for c in consts if c in _FORBIDDEN_FLAGS]
        splats = {dotted(e.value).split(".")[-1] for e in cmd.elts
                  if isinstance(e, ast.Starred)}
        flagged = bool(splats & flag_names) or any(
            _is_flags_name(s) for s in splats if s)
        if bad or not (flagged or _FMAD_OFF in consts):
            why = (f"passes `{bad[0]}`" if bad else
                   f"passes neither `{_FMAD_OFF}` nor an NVCC flag set")
            yield ctx.finding(
                self, cmd,
                f"nvcc command {why}: every CUDA source is built with "
                f"`{_FMAD_OFF}` so the DP kernels price bit for bit as the "
                "host DP")

    # -- the plain DP versions -------------------------------------------------

    def _check_plain_dp(self, ctx) -> Iterable[Finding]:
        defs: dict[str, list] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)
        roots = [fn for fns in defs.values() for fn in fns
                 if fn.name.endswith("_plain") and _mentions_float64(fn)]
        scope = {id(fn): fn for fn in roots}
        todo = list(roots)
        while todo:
            fn = todo.pop()
            for call in ast.walk(fn):
                if isinstance(call, ast.Call) and isinstance(call.func, ast.Name):
                    for callee in defs.get(call.func.id, []):
                        if id(callee) not in scope:
                            scope[id(callee)] = callee
                            todo.append(callee)
        seen: set[int] = set()
        for fn in sorted(scope.values(), key=lambda f: f.lineno):
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call) or id(call) in seen:
                    continue
                seen.add(id(call))
                name = dotted(call.func).split(".")[-1] or (
                    call.func.attr if isinstance(call.func, ast.Attribute)
                    else "")
                if name in _FUSED or dotted(call.func) == "torch.compile":
                    what = ("`torch.compile`" if name == "compile"
                            else f"fused `{name}`")
                    yield ctx.finding(
                        self, call,
                        f"{what} in the float64 plain DP path (`{fn.name}`): "
                        "it changes the operation association of the numpy "
                        "forms, and plans drift off the oracle on tie-breaks "
                        "— write the multiply and the add apart")

    # -- float tensors without a dtype -----------------------------------------

    def _check_float_builders(self, ctx) -> Iterable[Finding]:
        for call in ast.walk(ctx.tree):
            if not isinstance(call, ast.Call):
                continue
            text = dotted(call.func)
            if not text.startswith("torch."):
                continue
            name = text.split(".")[-1]
            if any(kw.arg == "dtype" for kw in call.keywords):
                continue
            if name in _ALWAYS_FLOAT or (
                    name in _FLOAT_BUILDERS
                    and any(_has_float_literal(a) for a in call.args)):
                yield ctx.finding(
                    self, call,
                    f"`{text}` builds a float tensor without `dtype=`: torch's "
                    "float32 default silently drops float64 precision (the "
                    "port's form of jnp without x64) — name the dtype")
