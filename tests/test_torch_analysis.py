"""The port's static analyzer (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

Four layers:

1. The carried-over parts (the framework, RPR002 and the hygiene rules
   RPR101-103) mirror ``tests/test_analysis.py`` test for test, and each
   fixture runs through *both* analyzers: findings, fingerprints and
   suppressed findings must be equal field for field.
2. The torch counterparts of the reference's jax rules (RPT001, RPT003,
   RPT004, RPT005): a firing fixture and a clean twin each, the twin in the
   shape of the real port site the rule must not flag
   (``kernels/flash_attention.py``'s launchers, ``launch/roofline.py``'s
   ``lru_cached``, ``kernels/build.py``'s flags), and the real file too.
3. The real tree: the port's analyzer over ``src`` and ``benchmarks`` with
   the shared rules reproduces ``analysis_baseline.json``'s entries exactly
   (read only) and the reference's suppressed findings; over its own
   default paths it has no active finding.
4. Both registries in one process, with no RPT id shared.
"""
from __future__ import annotations

import dataclasses
import json
import textwrap
from pathlib import Path

import pytest

from repro.analysis import analyze_paths as ref_analyze_paths
from repro.analysis.cli import main as ref_cli_main
from repro.analysis.core import all_rules as ref_all_rules
from repro_torch.analysis import (
    analyze_paths,
    diff_baseline,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.cli import DEFAULT_BASELINE, DEFAULT_PATHS
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.core import all_rules
from repro_torch.analysis.jitinfo import JitInfo

REPO_ROOT = Path(__file__).resolve().parent.parent
SHARED = ["RPR002", "RPR101", "RPR102", "RPR103"]
RPT = ["RPT001", "RPT003", "RPT004", "RPT005"]


def _write(tmp_path: Path, relpath: str, code: str) -> None:
    path = tmp_path / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))


def _dicts(findings):
    return [f.to_dict() for f in findings]


def both(tmp_path: Path, relpath: str, code: str, rules=None):
    """Run both analyzers over ``tmp_path`` (after writing ``code``) with the
    shared rules (or ``rules``), assert their results equal field for field
    (fingerprints included), and return the port's."""
    _write(tmp_path, relpath, code)
    return same_on_tree(tmp_path, rules)


def same_on_tree(tmp_path: Path, rules=None):
    rules = SHARED if rules is None else rules
    got = analyze_paths([str(tmp_path)], root=str(tmp_path), rules=rules)
    want = ref_analyze_paths([str(tmp_path)], root=str(tmp_path), rules=rules)
    assert _dicts(got.findings) == _dicts(want.findings)
    assert _dicts(got.suppressed) == _dicts(want.suppressed)
    assert got.files == want.files
    return got


def run_on(tmp_path: Path, relpath: str, code: str, rules=None):
    _write(tmp_path, relpath, code)
    return analyze_paths([str(tmp_path)], root=str(tmp_path), rules=rules)


def rule_lines(result, rule):
    return [(f.path, f.line) for f in result.findings if f.rule == rule]


# --------------------------------------------------------------------------
# RPR002 cache-aliasing (carried over): both analyzers, same findings
# --------------------------------------------------------------------------

def test_rpr002_fires_on_aliasing_get_and_put(tmp_path):
    res = both(tmp_path, "cache.py", """
        class PlanCache:
            def get(self, sig):
                entry = self._entries.get(sig)
                return entry                      # shared mutable entry

            def put(self, sig, plan):
                self._entries[sig] = plan         # caller keeps a reference

        class TileCache:
            def get(self, k):
                return self._tiles[k]             # direct store read
    """, rules=["RPR002"])
    lines = rule_lines(res, "RPR002")
    assert ("cache.py", 5) in lines
    assert ("cache.py", 8) in lines
    assert ("cache.py", 12) in lines


def test_rpr002_clean_and_suppressed_twins(tmp_path):
    res = both(tmp_path, "cache.py", """
        import copy

        class PlanCache:
            def get(self, sig):
                entry = self._entries.get(sig)
                return copy.deepcopy(entry)       # detached at the boundary

            def put(self, sig, plan):
                self._entries[sig] = detach(plan)

        class ProgramCache:
            def get(self, key):
                fn = self._entries.get(key)
                # repro: ignore[RPR002] -- compiled kernels are immutable
                return fn
    """, rules=["RPR002"])
    assert rule_lines(res, "RPR002") == []
    assert len(res.suppressed) == 1


def test_rpr002_detach_completeness_fires_on_missing_variant(tmp_path):
    res = both(tmp_path, "planner.py", """
        class PlanNode:
            pass

        class SubqueryNode(PlanNode):
            pass

        class LeftJoinPlanNode(PlanNode):
            pass

        def _copy_node(node):                     # LeftJoinPlanNode missing
            if isinstance(node, SubqueryNode):
                return SubqueryNode()
            raise AssertionError(node)

        def _rename_node(node, ren):              # handles both variants
            if isinstance(node, SubqueryNode):
                return SubqueryNode()
            if isinstance(node, LeftJoinPlanNode):
                return LeftJoinPlanNode()
            raise AssertionError(node)
    """, rules=["RPR002"])
    findings = [f for f in res.findings if f.rule == "RPR002"]
    assert len(findings) == 1
    assert "_copy_node" in findings[0].message
    assert "LeftJoinPlanNode" in findings[0].message


def test_rpr002_detach_completeness_clean_when_all_variants_handled(tmp_path):
    res = both(tmp_path, "planner.py", """
        class PlanNode:
            pass

        class SubqueryNode(PlanNode):
            pass

        class UnionPlanNode(PlanNode):
            pass

        def _copy_node(node):
            if isinstance(node, SubqueryNode):
                return SubqueryNode()
            if isinstance(node, UnionPlanNode):
                return UnionPlanNode()
            raise AssertionError(node)

        def helper_without_detach_name(node):     # not a detach helper: free
            return node
    """, rules=["RPR002"])
    assert rule_lines(res, "RPR002") == []


# --------------------------------------------------------------------------
# Hygiene rules + suppression mechanics (carried over)
# --------------------------------------------------------------------------

def test_hygiene_rules_fire(tmp_path):
    res = both(tmp_path, "src/lib.py", """
        def f(x, acc=[]):
            acc.append(x)
            return acc

        def g():
            try:
                risky()
            except Exception:
                pass

        def h(n):
            assert n > 0
            return n
    """, rules=["RPR101", "RPR102", "RPR103"])
    assert rule_lines(res, "RPR101") == [("src/lib.py", 2)]
    assert rule_lines(res, "RPR102") == [("src/lib.py", 9)]
    assert rule_lines(res, "RPR103") == [("src/lib.py", 13)]


def test_broad_except_with_reraise_is_clean(tmp_path):
    res = both(tmp_path, "src/lib.py", """
        def g():
            try:
                risky()
            except Exception as exc:
                log(exc)
                raise
    """, rules=["RPR102"])
    assert rule_lines(res, "RPR102") == []


def test_asserts_in_tests_and_benchmarks_are_exempt(tmp_path):
    code = "def t():\n    assert 1 > 0\n"
    res_t = both(tmp_path, "tests/test_x.py", code, rules=["RPR103"])
    assert rule_lines(res_t, "RPR103") == []
    res_b = both(tmp_path, "benchmarks/b.py", code, rules=["RPR103"])
    assert rule_lines(res_b, "RPR103") == []


def test_asserts_in_the_port_package_are_flagged(tmp_path):
    """``src/repro_torch`` is library code for RPR103, in both analyzers."""
    res = both(tmp_path, "src/repro_torch/kernels/k.py",
               "def f(n):\n    assert n\n    return n\n", rules=["RPR103"])
    assert rule_lines(res, "RPR103") == [("src/repro_torch/kernels/k.py", 2)]


def test_reasonless_suppression_is_rpr100_and_does_not_silence(tmp_path):
    res = both(tmp_path, "src/lib.py", """
        def f(x, acc=[]):  # repro: ignore[RPR101]
            return acc
    """)
    rules = {f.rule for f in res.findings}
    assert "RPR100" in rules             # the malformed suppression itself
    assert "RPR101" in rules             # ...which silenced nothing
    assert res.suppressed == []


def test_multiline_reason_suppression_covers_next_code_line(tmp_path):
    res = both(tmp_path, "src/lib.py", """
        def f(x,
              # repro: ignore[RPR101] -- registry shared by design: the dict is
              # the module-level singleton every caller mutates deliberately
              acc={}):
            return acc
    """, rules=["RPR101"])
    assert rule_lines(res, "RPR101") == []
    assert len(res.suppressed) == 1


def test_syntax_error_is_rpr900_in_both(tmp_path):
    res = both(tmp_path, "src/broken.py", "def f(:\n    pass\n")
    assert [f.rule for f in res.findings] == ["RPR900"]


# --------------------------------------------------------------------------
# Fingerprints + baseline workflow (carried over)
# --------------------------------------------------------------------------

def test_fingerprint_stable_under_unrelated_edits(tmp_path):
    code = """
        def f(x, acc=[]):
            return acc
    """
    fp1 = both(tmp_path, "src/a.py", code).findings[0].fingerprint
    shifted = "\n\n# a new header comment\n" + textwrap.dedent(code)
    (tmp_path / "src/a.py").write_text(shifted)
    res2 = same_on_tree(tmp_path)
    assert [f.fingerprint for f in res2.findings] == [fp1]


def test_baseline_roundtrip_new_and_stale(tmp_path):
    res = both(tmp_path, "src/a.py", """
        def f(x, acc=[]):
            return acc
    """)
    bl_path = tmp_path / "baseline.json"
    write_baseline(str(bl_path), res)
    baseline = load_baseline(str(bl_path))
    new, stale = diff_baseline(res, baseline)
    assert new == [] and stale == []
    # a second finding is NEW against the old baseline
    (tmp_path / "src/a.py").write_text(
        "def f(x, acc=[]):\n    return acc\n\ndef g(y, acc2={}):\n    return acc2\n")
    res2 = same_on_tree(tmp_path)
    new2, stale2 = diff_baseline(res2, baseline)
    assert len(new2) == 1 and stale2 == []
    # fixing the original finding leaves a STALE baseline entry
    (tmp_path / "src/a.py").write_text("def f(x, acc=None):\n    return acc\n")
    res3 = same_on_tree(tmp_path)
    new3, stale3 = diff_baseline(res3, baseline)
    assert new3 == [] and len(stale3) == 1


def test_baseline_file_is_byte_identical_to_the_reference_writer(tmp_path):
    from repro.analysis.baseline import write_baseline as ref_write_baseline

    res = both(tmp_path, "src/a.py", "def f(x, acc=[]):\n    return acc\n")
    ref_res = ref_analyze_paths([str(tmp_path)], root=str(tmp_path),
                                rules=SHARED)
    write_baseline(str(tmp_path / "port.json"), res)
    ref_write_baseline(str(tmp_path / "ref.json"), ref_res)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()


def test_write_baseline_carries_reasons_forward(tmp_path):
    res = both(tmp_path, "src/a.py", "def f(x, acc=[]):\n    return acc\n")
    bl_path = tmp_path / "baseline.json"
    entries = write_baseline(str(bl_path), res)
    fp = next(iter(entries))
    baseline = load_baseline(str(bl_path))
    baseline[fp]["reason"] = "reviewed: harmless in this context"
    entries2 = write_baseline(str(bl_path), res, baseline)
    assert entries2[fp]["reason"] == "reviewed: harmless in this context"


def test_missing_baseline_is_empty_and_bad_schema_raises(tmp_path):
    assert load_baseline(str(tmp_path / "absent.json")) == {}
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 99, "findings": {}}))
    with pytest.raises(ValueError):
        load_baseline(str(bad))


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def test_cli_exit_codes_and_json(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.py").write_text("def f(x, acc=[]):\n    return acc\n")
    rc = cli_main([str(src), "--root", str(tmp_path), "--no-baseline",
                   "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    ref_rc = ref_cli_main([str(src), "--root", str(tmp_path), "--no-baseline",
                           "--format", "json", "--rules", ",".join(SHARED)])
    ref_payload = json.loads(capsys.readouterr().out)
    assert rc == ref_rc == 1
    assert payload["new"][0]["rule"] == "RPR101"
    assert payload == ref_payload
    # clean tree exits 0
    (src / "a.py").write_text("def f(x):\n    return x\n")
    assert cli_main([str(src), "--root", str(tmp_path), "--no-baseline"]) == 0
    capsys.readouterr()
    # unknown rule id is a usage error; the reference's jax rules are not
    # the port's
    assert cli_main([str(src), "--rules", "RPR999"]) == 2
    assert cli_main([str(src), "--rules", "RPR001"]) == 2


def test_cli_baseline_gate(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.py").write_text("def f(x, acc=[]):\n    return acc\n")
    bl = tmp_path / "bl.json"
    assert cli_main([str(src), "--root", str(tmp_path), "--baseline", str(bl),
                     "--write-baseline"]) == 0
    assert cli_main([str(src), "--root", str(tmp_path),
                     "--baseline", str(bl)]) == 0
    # fixing the finding without retiring the baseline entry is loud
    (src / "a.py").write_text("def f(x):\n    return x\n")
    assert cli_main([str(src), "--root", str(tmp_path),
                     "--baseline", str(bl)]) == 1
    out = capsys.readouterr().out
    assert "STALE" in out


def test_cli_defaults_name_the_port(tmp_path, capsys):
    assert DEFAULT_PATHS == ("src/repro_torch", "chip_smoke.py", "scripts")
    assert DEFAULT_BASELINE != "analysis_baseline.json"
    assert not (REPO_ROOT / DEFAULT_BASELINE).exists()      # starts clean
    assert cli_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.split()
    assert set(SHARED + RPT) <= set(listed)


def test_every_rule_is_registered():
    ids = set(all_rules())
    assert ids == set(SHARED + RPT)


# --------------------------------------------------------------------------
# RPT001 trace-host-sync (answers RPR001)
# --------------------------------------------------------------------------

def test_rpt001_fires_in_captured_bodies(tmp_path):
    res = run_on(tmp_path, "mod.py", """
        import torch
        from torch.utils.checkpoint import checkpoint

        class ScaleFn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                s = x.abs().max().item()          # sync under autograd
                return x / s

            @staticmethod
            def backward(ctx, g):
                return g * float(g.sum())         # float of a tensor

        def _launch(x, n):
            return x[: int(n)]                    # n is a Tensor (schema)

        op = torch.library.custom_op("ns::cut", _launch, mutates_args=(),
                                     schema="(Tensor x, Tensor n) -> Tensor")

        def _layer(x):
            return helper(x)

        def helper(x):
            return x * len(x.tolist())            # via the call graph

        def forward(x):
            return checkpoint(_layer, x, use_reentrant=False)

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                y.cpu()                           # sync inside a capture
    """, rules=["RPT001"])
    assert rule_lines(res, "RPT001") == [("mod.py", 8), ("mod.py", 13),
                                         ("mod.py", 16), ("mod.py", 25),
                                         ("mod.py", 33)]


def test_rpt001_register_fake_and_decorated_op_bodies_are_traced(tmp_path):
    res = run_on(tmp_path, "mod.py", """
        import torch

        @torch.library.custom_op("ns::f", mutates_args=())
        def f(x: torch.Tensor, k: int) -> torch.Tensor:
            return x[: int(k)] + x.sum().item()   # k is an int: only .item()

        @f.register_fake
        def _(x, k):
            return x.new_empty((int(x[0]),))      # data-dependent: flagged
    """, rules=["RPT001"])
    assert rule_lines(res, "RPT001") == [("mod.py", 6), ("mod.py", 10)]


# the shape of kernels/flash_attention.py's launchers: the operator bodies
# pass host scalars (schema-typed bool/int/float) through int(...)
FLASH_LAUNCH = """
    import torch

    from repro_torch.kernels.build import launch

    _OPTS = "bool causal, int window, float scale"


    def _launch_fwd(q, k, v, causal, window, scale, with_lse: bool):
        B, S, H, hd = q.shape
        KV = k.shape[2]
        out = torch.empty_like(q)
        if out.numel():
            launch("flash_attention", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), B, S, H, KV, hd,
                   int(bool(causal)), int(window), scale)
        return out


    def _launch_bwd(q, k, v, dout, causal: bool, window: int, scale: float):
        B, S, H, hd = q.shape
        dq = torch.empty_like(q)
        launch("flash_attention_bwd", q.data_ptr(), dout.data_ptr(),
               dq.data_ptr(), B, S, H, hd, int(bool(causal)), int(window),
               scale)
        return dq


    def fwd(q, k, v, *, causal: bool = True, window: int = 0,
            scale: "float | None" = None):
        dev, (B, S, H, KV, hd) = _check_args(q, k, v)
        scale = hd ** -0.5 if scale is None else float(scale)
        return torch.ops.ns.fwd(q, k, v, bool(causal), int(window), scale)


    def _check_args(q, k, v):
        B, S, H, hd = q.shape
        return q.device, (B, S, H, k.shape[2], hd)


    _fwd_op = torch.library.custom_op(
        "ns::fwd",
        lambda q, k, v, causal, window, scale: _launch_fwd(
            q, k, v, causal, window, scale, False),
        mutates_args=(), device_types="cuda",
        schema=f"(Tensor q, Tensor k, Tensor v, {_OPTS}) -> Tensor")
    _bwd_op = torch.library.custom_op(
        "ns::bwd", _launch_bwd, mutates_args=(), device_types="cuda",
        schema=f"(Tensor q, Tensor k, Tensor v, Tensor dout, {_OPTS}) -> Tensor")


    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window, scale):
            ctx.save_for_backward(q, k, v)
            ctx.opts = dict(causal=causal, window=window, scale=scale)
            return fwd(q, k, v, causal=causal, window=window, scale=scale)

        @staticmethod
        def backward(ctx, dout):
            q, k, v = ctx.saved_tensors
            n = int(q.shape[0])                   # shape math: static
            return _launch_bwd(q, k, v, dout, **ctx.opts), None, None, n


    @_fwd_op.register_fake
    def _(q, k, v, causal, window, scale):
        return torch.empty_like(q)
"""


def test_rpt001_clean_twin_is_the_flash_launch_shape(tmp_path):
    res = run_on(tmp_path, "kernels/fa.py", FLASH_LAUNCH, rules=["RPT001"])
    assert rule_lines(res, "RPT001") == []
    # ...and not because nothing was traced: the launchers are op bodies
    import ast

    jit = JitInfo(ast.parse(textwrap.dedent(FLASH_LAUNCH)))
    traced = {getattr(f, "name", "<lambda>") for f in jit.traced_functions()}
    assert {"_launch_fwd", "_launch_bwd", "<lambda>", "forward", "backward",
            "fwd", "_check_args", "_"} <= traced


def test_rpt001_a_tensor_window_in_the_schema_is_flagged(tmp_path):
    """The same launcher with ``window`` typed ``Tensor`` in the schema: now
    ``int(window)`` reads a tensor, in both launchers."""
    code = FLASH_LAUNCH.replace(
        '_OPTS = "bool causal, int window, float scale"',
        '_OPTS = "bool causal, Tensor window, float scale"').replace(
        "window: int, scale: float", "window, scale: float")
    res = run_on(tmp_path, "kernels/fa.py", code, rules=["RPT001"])
    lines = [ln for _, ln in rule_lines(res, "RPT001")]
    assert len(lines) == 2
    src = textwrap.dedent(code).splitlines()
    assert all("int(window)" in src[ln - 1] for ln in lines)


def test_rpt001_the_real_flash_and_scan_launchers_are_clean(tmp_path):
    for name in ("flash_attention.py", "ssm_scan.py"):
        path = REPO_ROOT / "src" / "repro_torch" / "kernels" / name
        res = analyze_paths([str(path)], root=str(REPO_ROOT), rules=["RPT001"])
        assert res.findings == [] and res.suppressed == [], name


def test_rpt001_untraced_host_code_and_suppressions(tmp_path):
    res = run_on(tmp_path, "mod.py", """
        import torch

        def host_entry(x):
            return float(x.sum()), x.tolist()     # untraced host code: fine

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                # repro: ignore[RPT001] -- one scalar per call by contract
                return x * x.max().item()

            @staticmethod
            def backward(ctx, g):
                # repro: ignore[RPR001] -- the reference's id: not this rule
                return g * g.max().item()
    """, rules=["RPT001"])
    assert rule_lines(res, "RPT001") == [("mod.py", 16)]
    assert len(res.suppressed) == 1


# --------------------------------------------------------------------------
# RPT003 bench-parity (answers RPR003)
# --------------------------------------------------------------------------

TIMERS = """
    import time
    import torch

    def queued_ms(fn, k=20):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(1000)
        ev[1].record()
        for _ in range(k):
            fn()
        ev[2].record()
        ev[2].synchronize()
        return ev[1].elapsed_time(ev[2]) / k, True

    def cuda_ms(fn):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    def host_ms(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
"""


def test_rpt003_fires_on_rivals_timed_across_boundaries(tmp_path):
    res = run_on(tmp_path, "chip_smoke.py", TIMERS + """
    def row(kernel, plain, library):
        kms, queued = queued_ms(kernel)
        pms = host_ms(plain)                      # host clock vs events
        return {"kernel_ms": kms, "plain_ms": pms,
                "library_ms": cuda_ms(library)}   # per-call vs queued

    def spans(kernel, plain):
        t0 = time.perf_counter()
        kernel()
        torch.cuda.synchronize()
        k_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain()
        p_s = time.perf_counter() - t0            # not closed by a sync
        return k_s / p_s
    """, rules=["RPT003"])
    got = rule_lines(res, "RPT003")
    assert got == [("chip_smoke.py", 33), ("chip_smoke.py", 34),
                   ("chip_smoke.py", 44)]


def test_rpt003_clean_twin_is_the_chip_smoke_row_shape(tmp_path):
    res = run_on(tmp_path, "scripts/bench.py", TIMERS + """
    def row(kernel, plain, library, plan):
        kms, queued = queued_ms(kernel)
        pms, plain_queued = queued_ms(plain, k=3)
        lms = queued_ms(library)[0]
        call = cuda_ms(kernel)                    # another quantity: no rival
        return dict(kernel_ms=kms, plain_ms=pms, library_ms=lms,
                    call_ms=call, bf16_ms=cuda_ms(kernel),
                    bf16_library_ms=cuda_ms(library), speedup=pms / kms,
                    # repro: ignore[RPT003] -- a busy share: device time
                    # over elapsed time by definition
                    busy=kms / cuda_ms(plan))
    """, rules=["RPT003"])
    assert rule_lines(res, "RPT003") == []
    assert len(res.suppressed) == 1


def test_rpt003_applies_only_to_measurement_files(tmp_path):
    code = TIMERS + """
    def row(kernel, plain):
        return {"kernel_ms": queued_ms(kernel)[0], "plain_ms": host_ms(plain)}
    """
    assert rule_lines(run_on(tmp_path, "src/repro_torch/m.py", code,
                             rules=["RPT003"]), "RPT003") == []
    assert len(rule_lines(run_on(tmp_path, "scripts/m.py", code,
                                 rules=["RPT003"]), "RPT003")) == 1


# --------------------------------------------------------------------------
# RPT004 recompile-hazard (answers RPR004)
# --------------------------------------------------------------------------

def test_rpt004_fires_on_loop_compile_immediate_compile_and_cached_builds(
        tmp_path):
    res = run_on(tmp_path, "mod.py", """
        import ctypes
        import functools
        import torch

        def sweep(shapes, f):
            for n in shapes:
                g = torch.compile(f)              # fresh wrapper per pass
                g(n)

        def once(f, x):
            return torch.compile(f)(x)            # build-and-discard

        @functools.lru_cache(maxsize=64)
        def kernel_for(params):
            build_kernels((params.name,))
            return ctypes.CDLL(params.path)

        def _load(path):
            return ctypes.CDLL(path)

        load = functools.lru_cache(None)(_load)
    """, rules=["RPT004"])
    assert rule_lines(res, "RPT004") == [("mod.py", 8), ("mod.py", 12),
                                         ("mod.py", 14), ("mod.py", 22)]


# the shape of launch/roofline.py's lru_cached: DTensor's cache of sharding
# decisions, keyed on structure
ROOFLINE_CACHE = """
    import functools
    import torch


    def lru_cached(fn):
        try:
            from torch.distributed.tensor._sharding_prop import LocalLRUCache
        except ImportError:
            import functools

            return functools.lru_cache(None)(fn)
        return LocalLRUCache(fn)


    compiled = torch.compile(lambda x: x * 2)     # bound once


    def sweep(shapes):
        for n in shapes:
            compiled(n)                           # reused wrapper: fine


    @functools.lru_cache(maxsize=8)
    def parse_config(text):
        return text.split(",")                    # builds nothing: fine
"""


def test_rpt004_clean_twin_is_the_roofline_cache_shape(tmp_path):
    res = run_on(tmp_path, "launch/roofline.py", ROOFLINE_CACHE,
                 rules=["RPT004"])
    assert rule_lines(res, "RPT004") == []
    real = REPO_ROOT / "src" / "repro_torch" / "launch" / "roofline.py"
    assert "def lru_cached(fn):" in real.read_text()
    res = analyze_paths([str(real), str(real.parent / "dryrun.py")],
                        root=str(REPO_ROOT), rules=["RPT004"])
    assert res.findings == []


# --------------------------------------------------------------------------
# RPT005 x64-discipline (answers RPR005)
# --------------------------------------------------------------------------

def test_rpt005_fires_on_flags_fused_ops_and_default_float32(tmp_path):
    res = run_on(tmp_path, "src/repro_torch/kernels/k.py", """
        import subprocess
        import torch

        NVCC_FLAGS = ("-O3", "-shared")           # no --fmad=false
        FAST_NVCC_FLAGS = ("--fmad=false", "--use_fast_math")

        def build(src):
            cmd = [_nvcc(), "-O3", "-o", "k.so", src]   # flags not passed
            subprocess.run(cmd)

        def dp_tile_plain(a, b, c):
            x = a.to(torch.float64)
            return torch.addcmul(x, b, c)         # fused multiply-add

        def dp_sweep_plain(a, b):
            return _step(a.double(), b)

        def _step(a, b):
            return a.addcdiv_(b, b)               # reached from a plain DP

        def pad(n):
            return torch.full((n,), float("inf")), torch.linspace(0, 1, n)
    """, rules=["RPT005"])
    p = "src/repro_torch/kernels/k.py"
    assert rule_lines(res, "RPT005") == [(p, 5), (p, 6), (p, 9), (p, 14),
                                         (p, 20), (p, 23), (p, 23)]


# the shape of kernels/build.py's flags and nvcc command, and of
# kernels/dp_layer.py's plain versions
BUILD_FLAGS = """
    import subprocess
    import torch

    NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                  "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
                  "-Xptxas", "-v")


    def build_kernels(name, out, tmp):
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(name)]
        return subprocess.Popen(cmd)


    def dp_layer_plain(cost_a, cost_b, valid):
        B, R, C = cost_a.shape
        pair = torch.where(valid != 0, cost_a * cost_b + cost_a, float("inf"))
        if R == 0:
            return torch.full((B, C), float("inf"), dtype=torch.float64)
        return pair.amin(dim=1)


    def attention_plain(q, k):
        return torch.addcmul(q, q, k)             # not the float64 DP
"""


def test_rpt005_clean_twin_is_the_build_and_plain_dp_shape(tmp_path):
    res = run_on(tmp_path, "src/repro_torch/kernels/build.py", BUILD_FLAGS,
                 rules=["RPT005"])
    assert rule_lines(res, "RPT005") == []
    kernels = REPO_ROOT / "src" / "repro_torch" / "kernels"
    assert '"--fmad=false"' in (kernels / "build.py").read_text()
    res = analyze_paths([str(kernels)], root=str(REPO_ROOT), rules=["RPT005"])
    assert res.findings == [] and res.files >= 10


def test_rpt005_dtype_rule_applies_only_under_kernels(tmp_path):
    code = "import torch\n\ndef f():\n    return torch.tensor(0.5)\n"
    assert rule_lines(run_on(tmp_path, "src/repro_torch/core/m.py", code,
                             rules=["RPT005"]), "RPT005") == []
    assert rule_lines(run_on(tmp_path, "src/repro_torch/kernels/m.py", code,
                             rules=["RPT005"]), "RPT005") == [
        ("src/repro_torch/kernels/m.py", 4)]


# --------------------------------------------------------------------------
# The real tree
# --------------------------------------------------------------------------

def test_e2e_shared_rules_reproduce_the_committed_baseline_exactly():
    """The port's copies of RPR002 and RPR101-103 over ``src`` and
    ``benchmarks`` (the reference's gate) find exactly the grandfathered
    entries of those rules in ``analysis_baseline.json`` (read only), and
    suppress exactly what the reference suppresses."""
    paths = [str(REPO_ROOT / "src"), str(REPO_ROOT / "benchmarks")]
    got = analyze_paths(paths, root=str(REPO_ROOT), rules=SHARED)
    want = ref_analyze_paths(paths, root=str(REPO_ROOT), rules=SHARED)
    baseline = json.loads((REPO_ROOT / "analysis_baseline.json").read_text())
    expected = {fp for fp, e in baseline["findings"].items()
                if e["rule"] in SHARED}
    assert {f.fingerprint for f in got.findings} == expected
    assert _dicts(got.findings) == _dicts(want.findings)
    assert _dicts(got.suppressed) == _dicts(want.suppressed)
    assert got.files == want.files


def test_e2e_the_port_tree_has_no_active_finding(monkeypatch, capsys):
    """The port's gate: its default paths, every rule, exit 0."""
    monkeypatch.chdir(REPO_ROOT)
    result = analyze_paths(list(DEFAULT_PATHS), root=".")
    new, stale = diff_baseline(result, load_baseline(DEFAULT_BASELINE))
    assert not new, "\n".join(f.render() for f in new)
    assert not stale
    assert result.files > 100
    assert cli_main([]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out


def test_e2e_every_port_suppression_has_a_reason_and_is_used():
    """Each ``# repro: ignore[...]`` in the port's default paths carries a
    reason and silences a finding of its own rule (none is stale)."""
    from repro_torch.analysis.core import iter_py_files
    from repro_torch.analysis.suppress import parse_suppressions

    result = analyze_paths([str(REPO_ROOT / p) for p in DEFAULT_PATHS],
                           root=str(REPO_ROOT))
    used = {(f.path, f.line, f.rule) for f in result.suppressed}
    for path in iter_py_files([str(REPO_ROOT / p) for p in DEFAULT_PATHS]):
        rel = Path(path).resolve().relative_to(REPO_ROOT).as_posix()
        for line, sup in parse_suppressions(Path(path).read_text()).items():
            assert sup.valid and sup.reason, (rel, line)
            port_rules = [r for r in sup.rules if r in all_rules()]
            assert any((rel, line, r) in used for r in port_rules), \
                (rel, line, sup.rules)


# --------------------------------------------------------------------------
# Both registries in one process
# --------------------------------------------------------------------------

def test_both_registries_live_in_one_process():
    port, ref = all_rules(), ref_all_rules()
    assert not set(RPT) & set(ref)
    assert not {"RPR001", "RPR003", "RPR004", "RPR005"} & set(port)
    assert set(port) & set(ref) == set(SHARED)
    for rid in SHARED:       # each registry holds its own instance
        assert port[rid] is not ref[rid]
        assert type(port[rid]).__module__.startswith("repro_torch.analysis")
        assert (port[rid].name, port[rid].description) == \
            (ref[rid].name, ref[rid].description)
    for rid in RPT:
        doc = type(port[rid]).__doc__ or ""
        assert "RPR" + rid[3:] in doc          # names the rule it answers


def test_rpt_suppressions_do_not_cross_talk(tmp_path):
    """``# repro: ignore[RPT001]`` is a valid suppression to the reference
    (no RPR100) that silences nothing there; a reference id silences
    nothing in the port."""
    code = """
        import jax, torch

        @jax.jit
        def step(x):
            return x * float(x[0])  # repro: ignore[RPT001] -- wrong analyzer

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * x.max().item()  # repro: ignore[RPR001] -- wrong analyzer
    """
    _write(tmp_path, "mod.py", code)
    ref = ref_analyze_paths([str(tmp_path)], root=str(tmp_path))
    port = analyze_paths([str(tmp_path)], root=str(tmp_path))
    assert [(f.rule, f.line) for f in ref.findings] == [("RPR001", 6)]
    assert ref.suppressed == []
    assert [(f.rule, f.line) for f in port.findings] == [("RPT001", 11)]
    assert port.suppressed == []


def test_the_isolation_test_scans_the_analyzer():
    import test_torch_isolation as iso

    names = {p.relative_to(REPO_ROOT / "src" / "repro_torch").as_posix()
             for p in iso.PORT_FILES}
    want = {f"analysis/{m}.py" for m in ("__init__", "__main__", "core",
                                         "suppress", "baseline", "cli",
                                         "jitinfo")}
    want |= {f"analysis/rules/{m}.py" for m in (
        "__init__", "hygiene", "cache_aliasing", "trace_host_sync",
        "recompile_hazard", "x64_discipline", "bench_parity")}
    assert want <= names


def test_finding_dataclass_is_the_references_field_for_field():
    from repro.analysis.core import Finding as RefFinding
    from repro_torch.analysis.core import Finding

    assert [f.name for f in dataclasses.fields(Finding)] == \
        [f.name for f in dataclasses.fields(RefFinding)]


def test_rpt001_capture_region_reads_its_functions_host_names(tmp_path):
    res = run_on(tmp_path, "mod.py", """
        import torch

        def capture(g, x, steps: int):
            with torch.cuda.graph(g):
                for i in range(int(steps)):       # a host count: fine
                    x = x * 2
                n = int(x.sum())                  # a tensor: flagged
            return x, n
    """, rules=["RPT001"])
    assert rule_lines(res, "RPT001") == [("mod.py", 8)]


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", REPO_ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_analysis_phase_passes_here_and_fails_on_a_finding(
        tmp_path, capsys):
    """``chip_smoke.py``'s first phase: one JSON line with the counts on the
    real tree; a planted finding (a host sync in an autograd Function)
    fails it before any kernel is built."""
    cs = _chip_smoke()
    state: dict = {}
    cs.phase_analysis(state)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "analysis"
    assert line["findings"] == line["stale"] == line["launches"] == 0
    assert line["files"] == state["analysis"]["files"] > 100
    assert line["suppressed"] == sum(line["suppressed_by_rule"].values())
    _write(tmp_path, "src/repro_torch/kernels/k.py", """
        import torch

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * x.max().item()
    """)
    cs.ROOT = tmp_path
    with pytest.raises(AssertionError, match="1 finding"):
        cs.phase_analysis({})
    assert "RPT001" in capsys.readouterr().err
