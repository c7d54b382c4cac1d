"""The port's spans and per-request counters (``repro_torch.common.spans``,
``DistMetrics``' counters and timings, ``QueryRequest``'s stamps) on the
CPU: the counters against values computed from the plan and the rows the
read-back kept, rows against the reference's answer, the stamps' order under the
real and the serving tests' simulated clocks, the spans' nesting under a
CPU profiler (each executor span inside the per-request span that carries
the qid), and no profiler range entered while none runs."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core.federation import build_federated_stats as ref_build_stats  # noqa: E402
from repro.core.planner import OdysseyOptimizer as RefOptimizer  # noqa: E402
from repro.engine.local import LocalEngine as RefLocalEngine  # noqa: E402
from repro.rdf import generator as RG  # noqa: E402
from repro_torch.common import spans  # noqa: E402
from repro_torch.core.federation import build_federated_stats  # noqa: E402
from repro_torch.engine.distributed import (NONZERO_COUNT_BYTES, DistMetrics,  # noqa: E402
                                            DistributedEngine, UnsupportedShapeError)
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.rdf import generator as G  # noqa: E402
from repro_torch.serve.query import QueryServeEngine  # noqa: E402
from test_torch_distributed import federation, plan_reads_and_columns  # noqa: E402

MESH = (4, 2)
CAP = 1024
EXEC_SPANS = ("odyssey.exec.star", "odyssey.exec.join", "odyssey.exec.readback",
              "odyssey.exec.rows")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    """The port's federation, queries and statistics, and the reference's
    answer row count per query (its ``LocalEngine`` on its own plan of the
    same query over the same generated federation)."""
    fed, queries = federation(G, "selftest", MESH[0])
    rfed, rqueries = federation(RG, "selftest", MESH[0])
    ropt = RefOptimizer(ref_build_stats(rfed))
    reng = RefLocalEngine(rfed)
    ref_rows = {}
    for rq in rqueries:
        plan = ropt.optimize(rq)
        if not plan.fallback:
            ref_rows[rq.name] = len(next(iter(reng.execute(plan).rows.values())))
    return fed, queries, build_federated_stats(fed), ref_rows


def _engine(fed):
    return DistributedEngine(fed, make_test_mesh(MESH, device="cpu"), cap=CAP,
                             partition_aware=True)


def test_counters_equal_the_plan_and_the_reference(small):
    fed, queries, stats, ref_rows = small
    from repro_torch.core.planner import OdysseyOptimizer

    opt = OdysseyOptimizer(stats, dp_backend="numpy", device="cpu")
    eng = _engine(fed)
    d, m = MESH
    ran = 0
    for q in queries:
        plan = opt.optimize(q)
        if plan.fallback:
            continue
        try:
            res = eng.execute(plan)
        except UnsupportedShapeError:
            continue
        reads, ncols = plan_reads_and_columns(plan.root)
        met = res.metrics
        assert met.host_syncs == reads + 2, q.name
        assert met.readback_slots == d * m * CAP
        # the rows the select kept on the device (int32; DISTINCT comes
        # after, on the host) and the select's count
        kept = eng.execute(dataclasses.replace(
            plan, query=dataclasses.replace(plan.query, distinct=False))).metrics
        assert met.readback_bytes == kept.readback_bytes == \
            4 * ncols * kept.answer_rows + NONZERO_COUNT_BYTES, q.name
        n = len(next(iter(res.rows.values())))
        assert met.answer_rows == n == ref_rows[q.name], q.name
        assert min(met.star_ms, met.join_ms, met.readback_ms, met.rows_ms) >= 0.0
        assert met.star_ms > 0.0 and met.readback_ms > 0.0 and met.rows_ms > 0.0
        ran += 1
    assert ran >= 6


def test_timings_are_left_out_of_equality():
    a, b = DistMetrics(host_syncs=3, star_ms=1.0), DistMetrics(host_syncs=3, star_ms=2.0)
    assert a == b and a != DistMetrics(host_syncs=4)


def test_engine_keeps_no_engine_wide_sync_counter(small):
    assert not hasattr(_engine(small[0]), "host_syncs")


def _served(fed, stats, queries, **kw):
    eng = QueryServeEngine(fed, stats, engine=_engine(fed), dp_backend="numpy",
                           device="cpu", **kw)
    try:
        reqs = [eng.submit(q) for q in queries]
        eng.drain()
    finally:
        eng.close()
    return reqs


def _conjunctive(queries, stats, fed):
    """The queries that run on the SPMD path (no fallback, no cartesian
    join), in order."""
    from repro_torch.core.planner import OdysseyOptimizer

    opt = OdysseyOptimizer(stats, dp_backend="numpy", device="cpu")
    eng = _engine(fed)
    out = []
    for q in queries:
        plan = opt.optimize(q)
        if plan.fallback:
            continue
        try:
            eng.execute(plan)
        except UnsupportedShapeError:
            continue
        out.append(q)
    return out


@pytest.mark.parametrize("pipeline", [False, True])
def test_stamps_in_order(small, pipeline):
    fed, queries, stats, _ = small
    qs = _conjunctive(queries, stats, fed)
    reqs = _served(fed, stats, qs + qs[:3], pipeline=pipeline)
    for r in reqs:
        assert r.done
        assert r.t_submit <= r.t_flushed <= r.t_planned <= r.t_exec <= r.t_done, r.qid
        assert isinstance(r.metrics, DistMetrics)
        parts = r.metrics.star_ms + r.metrics.join_ms + r.metrics.readback_ms \
            + r.metrics.rows_ms
        assert parts <= (r.t_done - r.t_exec) * 1e3


class FakeClock:
    """The serving tests' engine clock: it reads ``t``, moved by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_stamps_exact_under_the_fake_clock(small):
    """A request held to its deadline is flushed, planned and executed at
    the poll that releases it, all read from the engine's clock."""
    fed, queries, stats, _ = small
    q = _conjunctive(queries, stats, fed)[0]
    clk = FakeClock()
    eng = QueryServeEngine(fed, stats, engine=_engine(fed), dp_backend="numpy",
                           device="cpu", clock=clk)
    req = eng.submit(q, deadline=5.0)
    clk.t = 4.9
    assert eng.poll() == [] and req.t_flushed == 0.0
    clk.t = 5.25
    assert eng.poll() == [req]
    assert (req.t_submit, req.t_flushed, req.t_planned, req.t_exec, req.t_done) == \
        (0.0, 5.25, 5.25, 5.25, 5.25)


def test_stamps_exact_under_a_ticking_clock(small):
    """Every read of the clock advances it by one: the stamps name the
    exact reads, and a batch's second request begins where the first was
    done."""
    fed, queries, stats, _ = small
    q1, q2 = _conjunctive(queries, stats, fed)[:2]
    ticks = iter(float(i) for i in range(100))
    eng = QueryServeEngine(fed, stats, engine=_engine(fed), dp_backend="numpy",
                           device="cpu", admission="arrival",
                           clock=lambda: next(ticks))
    r1, r2 = eng.submit(q1), eng.submit(q2)        # reads 0, 1
    assert eng.step() == [r1, r2]                  # flush read 2
    assert not r1.cached and not r2.cached
    assert [(r.t_submit, r.t_flushed, r.t_planned, r.t_exec, r.t_done)
            for r in (r1, r2)] == [(0.0, 3.0, 4.0, 5.0, 6.0), (1.0, 3.0, 4.0, 6.0, 7.0)]
    assert eng.serve_stats.plan_ms == 1e3 and eng.serve_stats.exec_ms == 3e3


def test_spans_nest_under_execute_batch_with_qids(small):
    from torch.profiler import ProfilerActivity, profile

    fed, queries, stats, _ = small
    qs = _conjunctive(queries, stats, fed)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        reqs = _served(fed, stats, qs)
    events = [e for e in prof.events() if e.name.startswith("odyssey.")]
    names = {e.name for e in events}
    assert {"odyssey.serve.plan_batch", "odyssey.serve.execute_batch",
            "odyssey.serve.execute", *EXEC_SPANS} <= names
    qids = {r.qid for r in reqs}
    per_req = [e for e in events if e.name == "odyssey.serve.execute"]
    assert sorted(e.kwinputs["qid"] for e in per_req) == sorted(qids)
    owner = {}
    for e in events:
        if e.name not in EXEC_SPANS:
            continue
        chain, p = [], e.cpu_parent
        while p is not None:
            chain.append(p)
            p = p.cpu_parent
        assert [x.name for x in chain if x.name.startswith("odyssey.")] == \
            ["odyssey.serve.execute", "odyssey.serve.execute_batch"], e.name
        # the request is the qid of the per-request span it nests in
        owner[id(e)] = next(x for x in chain
                            if x.name == "odyssey.serve.execute").kwinputs["qid"]
        assert owner[id(e)] in qids
    # each request's star spans add up to no more than its counter
    for r in reqs:
        star_us = sum(e.time_range.end - e.time_range.start for e in events
                      if e.name == "odyssey.exec.star" and owner[id(e)] == r.qid)
        assert 0 < star_us * 1e-3 <= r.metrics.star_ms * 1.05 + 0.05


class _Counting:
    """Stands in for the profiler's range: counts, then enters the real
    one."""

    calls = 0
    real = spans._RecordFunctionFast

    def __init__(self, *args):
        type(self).calls += 1
        self._r = self.real(*args)

    def __enter__(self):
        return self._r.__enter__()

    def __exit__(self, *exc):
        return self._r.__exit__(*exc)


def test_no_profiler_no_range(small, monkeypatch):
    fed, queries, stats, _ = small
    qs = _conjunctive(queries, stats, fed)[:2]
    monkeypatch.setattr(spans, "_RecordFunctionFast", _Counting)
    _Counting.calls = 0
    assert spans.span("odyssey.exec.star") is spans.span("odyssey.exec.rows", 3)
    reqs = _served(fed, stats, qs, pipeline=True)
    assert all(r.done for r in reqs) and _Counting.calls == 0
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        _served(fed, stats, qs)
    assert _Counting.calls > 0


def test_planner_thread_spans_need_all_threads(small):
    """The planner thread's spans land in a trace only when the profiler
    is asked for every thread (docs/serving_torch.md)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    fed, queries, stats, _ = small
    qs = _conjunctive(queries, stats, fed)[:2]
    found = {}
    for all_threads in (False, True):
        cfg = _ExperimentalConfig(profile_all_threads=True) if all_threads else None
        kw = {"experimental_config": cfg} if cfg is not None else {}
        with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
            _served(fed, stats, qs, pipeline=True)
        found[all_threads] = {e.name for e in prof.events()
                              if e.name.startswith("odyssey.")}
    assert "odyssey.serve.plan_batch" not in found[False]
    assert "odyssey.serve.execute_batch" in found[False]
    assert "odyssey.serve.plan_batch" in found[True]
