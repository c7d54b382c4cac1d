"""Committed baseline of grandfathered findings.

The baseline is a JSON map ``fingerprint -> entry`` kept at the repo root
(``analysis_baseline_torch.json`` for the port; none is committed, and a
missing file is an empty baseline).  A finding in the baseline does not fail
the build; a finding *not* in it does, and so does a baseline entry whose
finding has disappeared (the fix should retire its baseline line in the
same commit — finding-drift fails loudly in both directions).

Refresh with ``python -m repro_torch.analysis ... --write-baseline`` after
reviewing the diff; hand-edit the ``reason`` fields to record *why* each
grandfathered finding is acceptable.
"""
from __future__ import annotations

import json
from typing import TYPE_CHECKING

if TYPE_CHECKING:                       # pragma: no cover
    from repro_torch.analysis.core import AnalysisResult, Finding

SCHEMA_VERSION = 1


def load_baseline(path: str) -> dict[str, dict]:
    try:
        with open(path, encoding="utf-8") as fh:
            payload = json.load(fh)
    except FileNotFoundError:
        return {}
    if payload.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"{path}: unsupported baseline schema "
                         f"{payload.get('schema')!r} (want {SCHEMA_VERSION})")
    return payload["findings"]


def write_baseline(path: str, result: "AnalysisResult",
                   previous: "dict[str, dict] | None" = None) -> dict[str, dict]:
    """Serialize the current findings as the new baseline, carrying forward
    hand-written reasons from ``previous`` where the fingerprint survives."""
    previous = previous or {}
    entries: dict[str, dict] = {}
    for f in sorted(result.findings, key=lambda f: (f.path, f.line, f.rule)):
        old = previous.get(f.fingerprint, {})
        entries[f.fingerprint] = {
            "rule": f.rule,
            "path": f.path,
            "line": f.line,
            "message": f.message,
            "reason": old.get("reason", "grandfathered (review + justify or fix)"),
        }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"schema": SCHEMA_VERSION, "findings": entries}, fh,
                  indent=1, sort_keys=True)
        fh.write("\n")
    return entries


def diff_baseline(result: "AnalysisResult", baseline: dict[str, dict]
                  ) -> "tuple[list[Finding], list[str]]":
    """Returns ``(new_findings, stale_fingerprints)``."""
    current = {f.fingerprint for f in result.findings}
    new = [f for f in result.findings if f.fingerprint not in baseline]
    stale = sorted(fp for fp in baseline if fp not in current)
    return new, stale
