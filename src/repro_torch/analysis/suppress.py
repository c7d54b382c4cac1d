"""Inline suppression comments.

Syntax (the reason is mandatory — a silence with no recorded justification
is exactly the kind of unreviewable precedent this suite exists to kill):

    x = float(y)  # repro: ignore[RPR001] -- host value by contract, see docstring
    # repro: ignore[RPR002, RPR004] -- compiled callables are immutable;
    # continuation comment lines may elaborate before the code line
    entry = cache.get(sig)

A trailing comment covers its own line; a comment-only line covers the next
non-comment, non-blank line (so a multi-line reason can elaborate in the
comment lines between).  Malformed suppressions (no rule list, empty
reason) never silence anything — the runner turns them into ``RPR100``
findings instead.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize

_PATTERN = re.compile(
    r"#\s*repro:\s*ignore"
    r"(?:\[(?P<rules>[^\]]*)\])?"
    r"(?:\s*(?:--|:)\s*(?P<reason>.*))?\s*$")


@dataclasses.dataclass(frozen=True)
class Suppression:
    rules: tuple[str, ...]
    reason: str
    comment_line: int     # where the ignore comment itself sits
    valid: bool
    error: str = ""


def parse_suppressions(source: str) -> dict[int, Suppression]:
    """Map *covered* line number -> suppression.

    The key is the line a suppression silences: the comment's own line for a
    trailing comment, the next non-comment non-blank line for a comment-only
    line.  ``comment_line`` keeps the comment's location for RPR100 reports.
    """
    out: dict[int, Suppression] = {}
    lines = source.splitlines()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT or "repro:" not in tok.string:
            continue
        m = _PATTERN.search(tok.string)
        if m is None:
            continue
        lineno = tok.start[0]
        own_line = tok.line.strip().startswith("#")
        raw_rules = (m.group("rules") or "").strip()
        reason = (m.group("reason") or "").strip()
        rules = tuple(r.strip().upper() for r in raw_rules.split(",") if r.strip())
        if not rules:
            sup = Suppression((), reason, lineno, valid=False,
                              error="suppression without a rule list: use "
                                    "`# repro: ignore[RPR00x] -- reason`")
        elif not reason:
            sup = Suppression(rules, "", lineno, valid=False,
                              error=f"suppression of [{', '.join(rules)}] "
                                    "without a reason (reason is mandatory)")
        else:
            sup = Suppression(rules, reason, lineno, valid=True)
        target = lineno
        if own_line:
            target = _next_code_line(lines, lineno)
        out[target] = sup
    return out


def _next_code_line(lines: list[str], comment_line: int) -> int:
    """First line after ``comment_line`` that is not blank or a comment."""
    for i in range(comment_line, len(lines)):
        stripped = lines[i].strip()          # lines[i] is 1-based line i+1
        if stripped and not stripped.startswith("#"):
            return i + 1
    return comment_line
