"""`repro_torch.analysis`: the port's static-analysis suite.

The counterpart of ``repro.analysis``, with its framework (registry,
suppressions, fingerprints, baseline, CLI) copied and its rules in two
kinds:

- carried over as they are, same ids and messages (not about jax):
  - RPR002 cache-aliasing    caches handing out / storing shared mutable state
  - RPR1xx generic hygiene   mutable defaults, broad excepts, library asserts
- torch counterparts of the reference's jax rules, ids of their own:
  - RPT001 trace-host-sync   (RPR001) host syncs inside captured bodies
  - RPT003 bench-parity      (RPR003) timed rivals crossing different
    boundaries
  - RPT004 recompile-hazard  (RPR004) per-call ``torch.compile``, value-keyed
    caches over kernel builds
  - RPT005 x64-discipline    (RPR005) the DP's float64 contract: nvcc
    flags, the plain DP versions, float tensors without a dtype

Run it as ``PYTHONPATH=src python -m repro_torch.analysis`` (default paths
``src/repro_torch chip_smoke.py scripts``).  Suppressions use the
reference's marker, ``# repro: ignore[RPT001] -- reason``; the RPT ids are
distinct so that a suppression aimed at one analyzer never silences the
other's finding.  The baseline file is ``analysis_baseline_torch.json``
(missing == empty).
"""
from repro_torch.analysis.core import (  # noqa: F401
    AnalysisResult,
    FileContext,
    Finding,
    Rule,
    all_rules,
    analyze_paths,
    get_rule,
    register,
)
from repro_torch.analysis.baseline import diff_baseline, load_baseline, write_baseline  # noqa: F401
