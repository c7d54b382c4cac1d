"""Rule registry, file contexts and the analysis runner.

A copy of ``repro.analysis.core`` with its imports rewritten: the same
``Finding``, registry, runner, RPR100/RPR900 findings and fingerprints
(byte-identical, so the two analyzers' findings compare field for field).
The port keeps a registry of its own, so both analyzers can live in one
process.  Dependency-free (``ast`` + stdlib only), and it never imports
torch: rules reason about capture *syntactically* (see ``jitinfo``), so a
broken kernel module cannot take the analyzer down with it.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
from collections import Counter
from typing import Callable, Iterable, Iterator

from repro_torch.analysis.jitinfo import JitInfo
from repro_torch.analysis.suppress import Suppression, parse_suppressions


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: a rule firing at a source location."""

    rule: str
    path: str                       # posix path relative to the analysis root
    line: int                       # 1-based
    col: int                        # 0-based
    message: str
    fingerprint: str = ""           # stable id; filled in by the runner

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FileContext:
    """Everything a rule needs about one source file, computed once."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self._jit: JitInfo | None = None
        self._suppressions: dict[int, Suppression] | None = None
        self._parents: dict[int, ast.AST] | None = None

    @property
    def jit(self) -> JitInfo:
        if self._jit is None:
            self._jit = JitInfo(self.tree)
        return self._jit

    @property
    def suppressions(self) -> dict[int, Suppression]:
        if self._suppressions is None:
            self._suppressions = parse_suppressions(self.source)
        return self._suppressions

    def parent(self, node: ast.AST) -> "ast.AST | None":
        if self._parents is None:
            self._parents = {}
            for outer in ast.walk(self.tree):
                for child in ast.iter_child_nodes(outer):
                    self._parents[id(child)] = outer
        return self._parents.get(id(node))

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, rule: "Rule", node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule.rule_id, path=self.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0), message=message)


class Rule:
    """Base class: one bug class, one ``check`` pass over a file."""

    rule_id = "RPR000"
    name = "abstract-rule"
    description = ""

    def applies(self, ctx: FileContext) -> bool:
        return True

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register(cls: "type[Rule]") -> "type[Rule]":
    inst = cls()
    if inst.rule_id in _REGISTRY:
        raise ValueError(f"duplicate rule id {inst.rule_id}")
    _REGISTRY[inst.rule_id] = inst
    return cls


def all_rules() -> dict[str, Rule]:
    # import for side effect: rule modules self-register on first use
    from repro_torch.analysis import rules as _rules  # noqa: F401

    return dict(sorted(_REGISTRY.items()))


def get_rule(rule_id: str) -> Rule:
    return all_rules()[rule_id]


# --------------------------------------------------------------------------
# Runner
# --------------------------------------------------------------------------

@dataclasses.dataclass
class AnalysisResult:
    findings: list[Finding]            # active (not suppressed)
    suppressed: list[Finding]          # silenced by a valid inline suppression
    files: int = 0

    @property
    def by_rule(self) -> "Counter[str]":
        return Counter(f.rule for f in self.findings)


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__" and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def _relpath(path: str, root: str) -> str:
    try:
        rel = os.path.relpath(path, root)
    except ValueError:          # different drive (windows) — keep as-is
        rel = path
    return rel.replace(os.sep, "/")


def _fingerprints(findings: list[Finding], ctxs: dict[str, FileContext]) -> list[Finding]:
    """Stable ids: hash of (rule, path, normalized line text, occurrence
    index among identical triples).  Line *numbers* are deliberately not
    hashed, so unrelated edits above a grandfathered finding do not churn
    the baseline; editing the finding's own line does invalidate it."""
    seen: Counter[tuple] = Counter()
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        ctx = ctxs.get(f.path)
        text = ctx.line_text(f.line).strip() if ctx else ""
        key = (f.rule, f.path, text)
        occ = seen[key]
        seen[key] += 1
        digest = hashlib.sha256(
            "|".join((f.rule, f.path, text, str(occ))).encode()).hexdigest()[:16]
        out.append(dataclasses.replace(f, fingerprint=digest))
    return out


def analyze_paths(paths: Iterable[str], *, root: str = ".",
                  rules: "Iterable[str] | None" = None,
                  file_filter: "Callable[[str], bool] | None" = None) -> AnalysisResult:
    """Run every (selected) rule over every ``.py`` file under ``paths``.

    ``root`` anchors the relative paths baked into finding fingerprints —
    CI and the e2e tests must agree on it (the repo root).
    """
    registry = all_rules()
    if rules is not None:
        registry = {r: registry[r] for r in rules}
    active: list[Finding] = []
    suppressed: list[Finding] = []
    ctxs: dict[str, FileContext] = {}
    n_files = 0
    for path in iter_py_files(paths):
        if file_filter is not None and not file_filter(path):
            continue
        n_files += 1
        rel = _relpath(path, root)
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as exc:
            active.append(Finding(rule="RPR900", path=rel,
                                  line=exc.lineno or 1, col=(exc.offset or 1) - 1,
                                  message=f"syntax error: {exc.msg}"))
            continue
        ctx = FileContext(rel, source, tree)
        ctxs[rel] = ctx
        raw: list[Finding] = []
        for rule in registry.values():
            if rule.applies(ctx):
                raw.extend(rule.check(ctx))
        # malformed suppression comments are findings themselves (RPR100):
        # a reason is mandatory, and a reasonless ignore must not silence
        for sup in sorted(ctx.suppressions.values(),
                          key=lambda s: s.comment_line):
            if not sup.valid:
                raw.append(Finding(rule="RPR100", path=rel,
                                   line=sup.comment_line, col=0,
                                   message=sup.error or "malformed suppression"))
        for f in raw:
            sup = _matching_suppression(ctx, f)
            (suppressed if sup else active).append(f)
    return AnalysisResult(findings=_fingerprints(active, ctxs),
                          suppressed=suppressed, files=n_files)


def _matching_suppression(ctx: FileContext, finding: Finding) -> "Suppression | None":
    """A valid ``# repro: ignore[RULE] -- reason`` silences findings of that
    rule on the line it covers (its own line for trailing comments, the next
    code line for comment-only lines — see ``suppress.parse_suppressions``)."""
    if finding.rule == "RPR100":
        return None                       # malformed suppressions are not silencable
    sup = ctx.suppressions.get(finding.line)
    if sup is not None and sup.valid and finding.rule in sup.rules:
        return sup
    return None
