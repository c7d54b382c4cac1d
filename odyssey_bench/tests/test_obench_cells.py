"""Each cell, run small on the CPU: every answer equals the reference's and
the result line has the format's keys."""
import pytest

from odyssey_bench.tests.small import CELLS, run_small

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("seed", [2**31 + 77, 3_000_000_019])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_rows_equal_reference(workload, seed):
    out = run_small(workload, seed=seed)
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert {k: v["value"] for k, v in out["checks"].items()} == dict(
        wrong_answers=0, missing=0, overflowed=0)
    assert all(c["limit"] == 0 for c in out["checks"].values())
    assert set(out["metrics"]) >= {"setup_s", "query_p95_ms"}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_line_has_breakdown_and_per_layer_metrics():
    out = run_small("cdls.queries.closed", trace=True)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["metrics"]) >= {"batch_size.tput", "plan_ms_per_query.tput",
                                   "exec_ms_per_query.tput", "shipped_tuples_per_query.tput"}
    # no device ran on the CPU, so its idle share is not read
    assert "device_idle_share.tput" not in out["metrics"]


def test_same_seed_same_inputs_other_seed_renamed():
    import json

    from odyssey_bench.harness import BENCH, make_inputs
    from odyssey_bench.tests.small import overrides

    cfg = json.loads((BENCH / "configs" / "fedbench-ls.json").read_text())
    mix = json.loads((BENCH / "traffic" / "ls-queries.closed.json").read_text())
    for key, val in overrides("ls.queries.closed").items():
        target = mix if key in mix else cfg
        target[key] = {**target[key], **val} if isinstance(val, dict) else val
    a = make_inputs(cfg, mix, 2**31 + 5)
    b = make_inputs(cfg, mix, 2**31 + 5)
    c = make_inputs(cfg, mix, 2**31 + 6)
    assert [q.patterns for q in a[1]] == [q.patterns for q in b[1]]
    assert all((x.s == y.s).all() for x, y in zip(a[0].sources, b[0].sources))
    # another seed: the same sizes under other ids
    assert [len(x.s) for x in a[0].sources] == [len(x.s) for x in c[0].sources]
    assert [q.patterns for q in a[1]] != [q.patterns for q in c[1]]
    assert [q.name for q in a[1]] == [q.name for q in c[1]]
