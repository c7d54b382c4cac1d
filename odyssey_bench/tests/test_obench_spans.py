"""The readers of the program's spans and per-request counters: each
returns a number on a cell run small on the CPU, the executor's four parts
fit in its execution time, a program without the counters gives no reading
and no error, and on a card an idle gap inside a span is named by it."""
import time
from types import SimpleNamespace

import pytest

from odyssey_bench.harness import Observed, _readers, load_benchmark
from odyssey_bench.tests.small import CELLS, overrides, run_small

NEW = ("admit_wait_ms_per_query.tput", "handoff_wait_ms_per_query.tput",
       "scan_ms_per_query.tput", "join_ms_per_query.tput", "readback_ms_per_query.tput",
       "rows_ms_per_query.tput", "readback_mb_per_query.tput", "answer_slot_share.tput",
       "host_syncs_per_query.tput")
PARTS = ("scan_ms_per_query.tput", "join_ms_per_query.tput", "readback_ms_per_query.tput",
         "rows_ms_per_query.tput")


@pytest.mark.parametrize("workload", CELLS)
def test_traced_line_reads_every_new_metric(workload):
    out = run_small(workload, trace=True)
    assert out["correct"] is True
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(got)
    assert all(got[k] >= 0 for k in NEW)
    assert 0 < got["answer_slot_share.tput"] <= 1
    assert got["host_syncs_per_query.tput"] >= 3
    assert got["readback_mb_per_query.tput"] > 0
    assert sum(got[k] for k in PARTS) <= got["exec_ms_per_query.tput"]


def test_parts_fit_each_request():
    """Per request: the four executor parts within its own execution, and
    the stamps in order."""
    import torch

    from odyssey_bench.harness import open_session, window

    torch.set_num_threads(1)
    sess = open_session("ls.queries.closed", 2**31 + 91, device="cpu",
                        overrides=overrides("ls.queries.closed"), log=lambda *a: None)
    try:
        w = window(sess, 1.0, False, grace_s=5.0)
    finally:
        sess.system.close()
    done = [r[0] for r in w["recs"] if r[0].done]
    assert done
    for req in done:
        m = req.metrics
        parts = m.star_ms + m.join_ms + m.readback_ms + m.rows_ms
        assert parts <= (req.t_done - req.t_exec) * 1e3
        assert req.t_submit <= req.t_flushed <= req.t_planned <= req.t_exec <= req.t_done


def test_readers_skip_requests_without_the_fields():
    """A program that lacks the stamps and counters (the fallback engine's
    metrics, or an older program) gives no reading, and no error."""
    bench = load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == CELLS[0])
    readers = {m["name"]: read for m, read in _readers(bench, cell, True)}
    req = SimpleNamespace(done=True, t_submit=0.0, t_planned=0.1, t_done=0.2,
                          metrics=SimpleNamespace(transferred_tuples=3, overflowed=False))
    obs = Observed(seconds=1.0, t_end=1.0, records=[[req, 0.0, 0]], ok=[True], setup_s=1.0,
                   stats={}, trace=None)
    assert all(readers[k](obs) is None for k in NEW)


@pytest.mark.cuda
def test_gap_inside_a_span_is_named_by_it(monkeypatch):
    """On a card: a profiler trace over one ``execute`` whose host rows take
    0.2 s names that idle gap ``odyssey.exec.rows``: the spans share the
    device trace's clock."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from odyssey_bench import trace
    from odyssey_bench.harness import open_session

    sess = open_session("cdls.queries.closed", 2**31 + 5, device="cuda",
                        overrides=overrides("cdls.queries.closed"), log=lambda *a: None)
    try:
        server, engine = sess.system.server, sess.system.engine
        plan = server.optimizer.optimize(sess.queries[0])
        engine.execute(plan)
        query_cls = type(plan.query)
        projection = query_cls.effective_projection

        def slow(self):
            time.sleep(0.2)
            return projection(self)

        monkeypatch.setattr(query_cls, "effective_projection", slow)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.execute(plan)
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        got = trace.summarize(prof, 1.0)
    finally:
        sess.system.close()
    name, seconds = got["idle_gaps"][0]
    assert name == "odyssey.exec.rows" and seconds >= 0.2
