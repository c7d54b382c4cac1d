"""The port's query server (``repro_torch.serve.query.QueryServeEngine``,
``repro_torch.serve.scheduler``) and cardinality feedback
(``repro_torch.stats.feedback``) against the reference package's, on the
CPU: the port plans on ``device="cpu"`` (the DP kernels' plain versions),
the reference on its numpy backend.  Admission under a fake clock forms the
same batches, with the same flush reasons and affinity tiers; a served
workload returns, per request, the reference engine's rows and the oracle's
answers in every admission and pipeline mode; a planner thread that dies
surfaces at the next call with no retry; and drift feedback refreshes the
same source into the same statistics."""
import dataclasses
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_batch_planner import to_port  # noqa: E402
from test_torch_stats import assert_same  # noqa: E402

import repro.serve as ref_serve  # noqa: E402
from benchmarks.planner_bench import object_variants, subject_variants  # noqa: E402
from repro.core.batch_planner import AffinityKey as RefKey  # noqa: E402
from repro.core.federation import build_federated_stats as ref_build  # noqa: E402
from repro.engine.pipeline import CardObservation as RefObs  # noqa: E402
from repro.rdf.dataset import Federation as RefFederation  # noqa: E402
from repro.rdf.dataset import Source as RefSource  # noqa: E402
from repro.rdf.dataset import TripleTable as RefTable  # noqa: E402
from repro.rdf.generator import fedbench_like_spec as ref_spec  # noqa: E402
from repro.rdf.generator import generate_federation as ref_gen  # noqa: E402
from repro.rdf.generator import generate_workload as ref_workload  # noqa: E402
from repro.stats.feedback import CardinalityFeedback as RefFeedback  # noqa: E402
import repro_torch.serve as serve  # noqa: E402
from repro_torch.core.batch_planner import (  # noqa: E402
    AFFINITY_TIERS,
    AffinityKey,
    BatchPlanReport,
)
from repro_torch.core.cost import estimation_error  # noqa: E402
from repro_torch.core.decomposition import decompose  # noqa: E402
from repro_torch.core.federation import build_federated_stats  # noqa: E402
from repro_torch.engine.local import LocalEngine, naive_evaluate  # noqa: E402
from repro_torch.engine.pipeline import CardObservation  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.rdf.dataset import Federation, Source, TripleTable  # noqa: E402
from repro_torch.rdf.generator import (  # noqa: E402
    fedbench_like_spec,
    generate_federation,
    generate_workload,
)
from repro_torch.serve import (  # noqa: E402
    AdmissionController,
    ArrivalQueue,
    BackpressureError,
    QueryServeEngine,
    ServeBase,
    ServeStats,
)
from repro_torch.stats.feedback import CardinalityFeedback  # noqa: E402

PORT = SimpleNamespace(AdmissionController=AdmissionController,
                       ArrivalQueue=ArrivalQueue, AffinityKey=AffinityKey,
                       QueryServeEngine=QueryServeEngine)
REF = SimpleNamespace(AdmissionController=ref_serve.AdmissionController,
                      ArrivalQueue=ref_serve.ArrivalQueue, AffinityKey=RefKey,
                      QueryServeEngine=ref_serve.QueryServeEngine)


@pytest.fixture(scope="module")
def both():
    """``(port, reference)``, each ``(fed, gt, stats, workload)`` from the
    same seeds (the reference tests' ``tiny_*`` fixtures)."""
    out = []
    for spec, gen, bld, wl in (
            (fedbench_like_spec, generate_federation, build_federated_stats,
             generate_workload),
            (ref_spec, ref_gen, ref_build, ref_workload)):
        fed, gt = gen(spec(scale=0.06, seed=3))
        out.append((fed, gt, bld(fed),
                    wl(fed, gt, n_star=4, n_hybrid=4, n_path=2, seed=9)))
    return out


def port_engine(fed, stats, **kw):
    return QueryServeEngine(fed, stats, device="cpu", **kw)


class FakeClock:
    """Deterministic engine clock: tests advance ``t`` by hand."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class _Req:
    def __init__(self, qid: int, deadline: float = 100.0):
        self.qid = qid
        self.deadline = deadline


def _key(m, sig, sel=None, pr=None, sh=None):
    return m.AffinityKey(signature=(sig,),
                         selection=None if sel is None else (sel,),
                         pricing=None if pr is None else (pr,),
                         shape=None if sh is None else (sh,))


def _batch(got):
    return None if got is None else ([r.qid for r in got[0]], got[1])


# -- admission: the reference's FakeClock cases, traced in both packages -----

def _deepest_tier(m):
    ac = m.AdmissionController(max_group=8)
    out = [ac.add(_Req(0), _key(m, "a", "s1", "p1", "h1"), 10.0),
           ac.add(_Req(1), _key(m, "a", "s9", "p9", "h9"), 10.0),
           ac.add(_Req(2), _key(m, "b", "s1", "p8", "h8"), 10.0),
           ac.add(_Req(3), _key(m, "c", "s7", "p1", "h7"), 10.0),
           ac.add(_Req(4), _key(m, "d", "s6", "p6", "h1"), 10.0),
           ac.add(_Req(5), _key(m, "e", "s5", "p5", "h5"), 20.0), len(ac)]
    out += [_batch(ac.next_batch(now=0.0, force=True)) for _ in range(3)]
    return out + [len(ac)]


def _deeper_beats_shallower(m):
    ac = m.AdmissionController(max_group=8)
    ac.add(_Req(0), _key(m, "a", "s1", "p1", "h1"), 10.0)
    ac.add(_Req(1), _key(m, "b", "s2", "p2", "h2"), 10.0)
    return [ac.add(_Req(2), _key(m, "b", "s3", "p3", "h1"), 10.0),
            _batch(ac.next_batch(0.0, force=True)),
            _batch(ac.next_batch(0.0, force=True))]


def _full_before_deadline(m):
    ac = m.AdmissionController(max_group=2)
    ac.add(_Req(0), _key(m, "a"), flush_at=1e9)
    out = [ac.ripe(now=0.0)]
    ac.add(_Req(1), _key(m, "a"), flush_at=1e9)
    return out + [ac.ripe(now=0.0), _batch(ac.next_batch(now=0.0))]


def _overflow_keeps_urgency(m):
    ac = m.AdmissionController(max_group=2)
    for qid, dl in enumerate((5.0, 7.0, 9.0)):
        ac.add(_Req(qid, deadline=dl), _key(m, "a"), flush_at=dl)
    return [_batch(ac.next_batch(now=0.0)), ac.next_flush_at(),
            _batch(ac.next_batch(now=8.0)), _batch(ac.next_batch(now=9.5))]


def _arrival_fifo(m):
    aq = m.ArrivalQueue(max_group=2)
    for qid in range(3):
        aq.add(_Req(qid, deadline=50.0), None, flush_at=50.0)
    return [len(aq), _batch(aq.next_batch(now=0.0)),
            _batch(aq.next_batch(now=0.0)), aq.next_flush_at(),
            _batch(aq.next_batch(now=60.0)), aq.next_flush_at()]


SCENARIOS = {
    "deepest_tier": (_deepest_tier, [
        None, "signature", "selection", "pricing", "shape", None, 6,
        ([0, 1, 2, 3, 4], "forced"), ([5], "forced"), None, 0]),
    "deeper_beats_shallower": (_deeper_beats_shallower, [
        "signature", ([0], "forced"), ([1, 2], "forced")]),
    "full_before_deadline": (_full_before_deadline, [
        False, True, ([0, 1], "full")]),
    "overflow_keeps_urgency": (_overflow_keeps_urgency, [
        ([0, 1], "full"), 9.0, None, ([2], "deadline")]),
    "arrival_fifo": (_arrival_fifo, [
        3, ([0, 1], "full"), None, 50.0, ([2], "deadline"), None]),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_admission_traces_equal_reference(case):
    fn, want = SCENARIOS[case]
    assert fn(PORT) == fn(REF) == want
    assert AFFINITY_TIERS == ("signature", "selection", "pricing", "shape")


def _engine_trace(m, fed, stats, wl, case, **kw):
    """One engine-level FakeClock case: the completed qids per poll and the
    flush counters."""
    clk = FakeClock()
    polls = []
    if case == "deadline":
        eng = m.QueryServeEngine(fed, stats, max_batch=64, clock=clk, **kw)
        req = eng.submit(wl[0], deadline=5.0)
        assert req.deadline == 5.0 and req.slo == 5.0
        for t in (0.0, 4.9, 5.1):
            clk.t = t
            polls.append([r.qid for r in eng.poll()])
        assert req.done and req.rows is not None
        tiers = [req.affinity_tier]
    elif case == "earliest_member":
        eng = m.QueryServeEngine(fed, stats, max_batch=64, clock=clk, **kw)
        lazy = eng.submit(wl[0], deadline=50.0)
        urgent = eng.submit(wl[0], deadline=2.0)
        clk.t = 2.5
        polls.append(sorted(r.qid for r in eng.poll()))
        tiers = [lazy.affinity_tier, urgent.affinity_tier]
    else:
        eng = m.QueryServeEngine(fed, stats, max_batch=2, clock=clk, **kw)
        r0 = eng.submit(wl[0], deadline=1e6)
        polls.append([r.qid for r in eng.poll()])
        r1 = eng.submit(wl[0], deadline=1e6)
        polls.append(sorted(r.qid for r in eng.poll()))
        tiers = [r0.affinity_tier, r1.affinity_tier]
    st = eng.serve_stats
    return (polls, tiers, st.n_deadline_flushes, st.n_full_flushes,
            st.n_forced_flushes, st.n_steps, st.n_served)


@pytest.mark.parametrize("case", ["deadline", "earliest_member", "full"])
def test_engine_fake_clock_flushes_equal_reference(both, case):
    (fed, _, stats, wl), (rfed, _, rstats, rwl) = both
    got = _engine_trace(PORT, fed, stats, wl, case, device="cpu")
    want = _engine_trace(REF, rfed, rstats, rwl, case)
    assert got == want
    if case == "deadline":
        assert got[0] == [[], [], [0]] and got[2:5] == (1, 0, 0)
    elif case == "earliest_member":
        assert got[1] == [None, "signature"] and got[5] == 1
    else:
        assert got[0] == [[], [0, 1]] and got[3] == 1


def test_affinity_tiers_on_real_queries_equal_reference(both):
    """Template variants join their group at the same tiers in both
    packages, and one poll flushes one batch per group."""
    (fed, _, stats, _), (rfed, _, rstats, rwl) = both
    rvariants = None
    for q in rwl:
        if len(q.patterns) < 2:
            continue
        ov, sv = object_variants(q, rfed, 1), subject_variants(q, rfed, 1)
        if ov and sv:
            rvariants = [q, q, ov[0], sv[0]]
            break
    assert rvariants
    traces = []
    for m, fd, st, qs, kw in ((PORT, fed, stats, [to_port(q) for q in rvariants],
                               {"device": "cpu"}),
                              (REF, rfed, rstats, rvariants, {})):
        clk = FakeClock()
        eng = m.QueryServeEngine(fd, st, max_batch=64, clock=clk, **kw)
        tiers = [eng.submit(v, deadline=100.0).affinity_tier for v in qs]
        clk.t = 200.0
        done = eng.poll()
        traces.append((tiers, len(done), eng.serve_stats.n_steps))
    assert traces[0] == traces[1]
    tiers = traces[0][0]
    assert tiers[0] is None and tiers[1] == "signature"
    assert any(t in ("selection", "pricing", "shape") for t in tiers[2:])


# -- served workloads: rows equal the reference engine's and the oracle's ----

def _wave(rfed, rwl):
    wave = []
    for q in rwl:
        wave.append(q)
        if len(q.patterns) >= 2:
            wave.extend(object_variants(q, rfed, 2))
    return wave + list(rwl[:3])


def _serve(m, fed, stats, wave, admission, pipeline, **kw):
    eng = m.QueryServeEngine(fed, stats, max_batch=8, admission=admission,
                             pipeline=pipeline, default_slo_ms=1.0, **kw)
    try:
        reqs = [eng.submit(q) for q in wave]
        done = eng.drain()
    finally:
        eng.close()
    assert sorted(r.qid for r in done) == [r.qid for r in reqs]
    return {r.qid: r for r in done}, eng


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("admission", ["affinity", "arrival"])
def test_served_rows_equal_reference_and_oracle(both, admission, pipeline):
    (fed, _, stats, _), (rfed, _, rstats, rwl) = both
    rwave = _wave(rfed, rwl)
    wave = [to_port(q) for q in rwave]
    got, eng = _serve(PORT, fed, stats, wave, admission, pipeline,
                      device="cpu")
    want, _ = _serve(REF, rfed, rstats, rwave, admission, pipeline)
    assert eng.optimizer.device == "cpu"
    assert eng.optimizer.dp_backend == "torch"
    assert isinstance(eng.engine, LocalEngine) and eng.engine.use_pipeline
    oracle = {}
    for qid, r in got.items():
        w = want[qid]
        assert list(r.rows) == list(w.rows), qid
        for v in r.rows:
            assert r.rows[v].dtype == w.rows[v].dtype
            assert r.rows[v].tobytes() == w.rows[v].tobytes(), (qid, v)
        for f in ("transferred_tuples", "requests", "intermediate_rows"):
            assert getattr(r.metrics, f) == getattr(w.metrics, f), (qid, f)
        assert r.stats_epoch == w.stats_epoch
        key = id(r.query)
        if key not in oracle:
            oracle[key] = naive_evaluate(fed, r.query)
        proj = r.query.effective_projection()
        n = len(next(iter(r.rows.values()))) if r.rows else 0
        ans = set(zip(*[r.rows[v].tolist() for v in proj])) if n else set()
        assert ans == oracle[key], r.query.name
    st = eng.serve_stats
    assert st.n_served == len(wave)
    assert st.n_planned == eng.optimizer.plan_cache.misses
    assert (st.n_full_flushes + st.n_deadline_flushes + st.n_forced_flushes
            == st.n_steps >= 1)


def test_poll_step_and_completed_report_each_once(both):
    (fed, _, stats, wl), _ = both
    eng = port_engine(fed, stats, max_batch=2)
    reqs = [eng.submit(q, deadline=0.0) for q in wl[:6]]
    qids = [r.qid for r in eng.step() + eng.poll() + eng.drain()]
    assert sorted(qids) == [r.qid for r in reqs] and len(set(qids)) == 6
    assert eng.poll() == [] and eng.drain() == []
    eng = port_engine(fed, stats, max_batch=4)
    reqs = [eng.submit(q, deadline=0.0) for q in wl]
    assert sorted(r.qid for r in eng.completed()) == [r.qid for r in reqs]
    assert list(eng.completed()) == []


def test_backpressure_reject_and_block(both):
    (fed, _, stats, wl), _ = both
    eng = port_engine(fed, stats, max_batch=8, queue_depth=2,
                      backpressure="reject")
    eng.submit(wl[0])
    eng.submit(wl[1])
    with pytest.raises(BackpressureError, match="watermark"):
        eng.submit(wl[2])
    assert eng.serve_stats.n_rejected == 1 and len(eng.queue) == 2
    eng.drain()
    eng.submit(wl[2])
    assert eng.drain()[0].rows is not None
    with pytest.raises(ValueError, match="pipeline"):
        port_engine(fed, stats, backpressure="block", pipeline=False)
    with port_engine(fed, stats, max_batch=4, queue_depth=1,
                     backpressure="block", pipeline=True,
                     handoff_depth=8) as eng:
        done = []
        for q in wl[:4]:
            eng.submit(q, deadline=0.0)
            done.extend(eng.poll())
        done.extend(eng.drain())
        assert len(done) == 4
        assert eng.serve_stats.n_blocked >= 1
        assert eng.serve_stats.n_rejected == 0


def test_close_step_and_bad_modes(both):
    (fed, _, stats, _), _ = both
    eng = port_engine(fed, stats, pipeline=True)
    worker = eng._worker
    assert worker.is_alive() and worker.name == "query-serve-planner"
    with pytest.raises(RuntimeError, match="poll"):
        eng.step()
    eng.close()
    assert not worker.is_alive() and eng._worker is None
    eng.close()
    with pytest.raises(ValueError, match="admission"):
        port_engine(fed, stats, admission="lifo")
    with pytest.raises(ValueError, match="backpressure"):
        port_engine(fed, stats, backpressure="drop")
    with pytest.raises(ValueError, match="handoff_depth"):
        port_engine(fed, stats, pipeline=True, handoff_depth=0)
    assert isinstance(port_engine(fed, stats), ServeBase)
    assert isinstance(port_engine(fed, stats).serve_stats, ServeStats)
    assert set(serve.__all__) >= {"QueryRequest", "QueryServeEngine",
                                  "AdmissionController", "ArrivalQueue"}


def _wait_for_death(eng):
    deadline = time.monotonic() + 10.0
    while eng._worker_error is None and time.monotonic() < deadline:
        time.sleep(0.005)
    return eng._worker_error


def test_worker_death_surfaces_at_next_call(both):
    (fed, _, stats, wl), _ = both
    eng = port_engine(fed, stats, pipeline=True)
    boom = ValueError("planner exploded")

    def explode(queries):
        raise boom

    eng.optimizer.optimize_batch = explode
    eng.submit(wl[0], deadline=0.0)
    assert _wait_for_death(eng) is boom
    with pytest.raises(RuntimeError, match="planner thread died") as ei:
        eng.poll()
    assert ei.value.__cause__ is boom
    for call in (lambda: eng.submit(wl[0]), eng.drain):
        with pytest.raises(RuntimeError, match="planner thread died"):
            call()
    eng.close()


def test_failed_kernel_launch_in_the_worker_is_not_retried(both, monkeypatch):
    """A server left on the card whose planner thread cannot launch
    ``dp_sweep`` (here every launch is refused, as a failed build or launch
    would be) dies at its first multi-star batch; the error reaches the
    caller at the next call, nothing is served, and nothing is planned again
    on the CPU or through the plain version."""
    (fed, _, stats, wl), _ = both

    def refuse(name, *args):
        raise RuntimeError(f"{name} kernel launch failed: cudaError 700")

    monkeypatch.setattr(build, "launch", refuse)
    multi = next(q for q in wl if len(decompose(q).stars) >= 2)
    eng = QueryServeEngine(fed, stats, pipeline=True)
    assert (eng.optimizer.dp_backend, eng.optimizer.device) == ("torch",
                                                                "cuda")
    eng.submit(multi, deadline=0.0)
    err = _wait_for_death(eng)
    assert err is not None
    with pytest.raises(RuntimeError, match="planner thread died"):
        eng.drain()
    assert eng.serve_stats.n_served == 0 and eng.finished == []
    assert eng.serve_stats.n_planned == 0
    assert eng.optimizer.device == "cuda"
    eng.close()


def test_planning_attribution(both):
    """A plan-cache hit is charged its own rebind, clamped into the batch
    window (the reference's fake-plan case), and with the real planner an
    in-batch duplicate is never charged more than the cold member."""
    (fed, _, stats, wl), _ = both
    ticks = iter(float(i) for i in range(100))
    eng = QueryServeEngine(fed, stats, device="cpu",
                           clock=lambda: next(ticks))
    reqs = [eng.submit(q) for q in wl[:3]]

    class _P:
        def __init__(self, cached, ms):
            self.cached, self.optimization_ms, self.stats_epoch = \
                cached, ms, 0

    plans = [_P(False, 900.0), _P(True, 50.0), _P(True, 5000.0)]
    eng.optimizer.optimize_batch = lambda queries: plans
    eng.optimizer.last_batch_report = BatchPlanReport(
        n_queries=3, cache_hits=2, n_planned=1, n_shapes=1)
    eng._plan_batch(reqs)
    assert reqs[0].t_planned == 4.0 and reqs[2].t_planned == 4.0
    assert reqs[1].t_planned == pytest.approx(3.0 + 50.0 * 1e-3)
    assert reqs[1].plan_ms == 50.0
    assert eng.serve_stats.plan_ms == pytest.approx(1000.0)
    assert eng.serve_stats.plan_cache_hits == 2
    assert eng.serve_stats.n_planned == 1

    eng = port_engine(fed, stats, max_batch=8)
    q = next(q for q in wl if len(q.patterns) >= 2)
    cold, dup = eng.submit(q, deadline=0.0), eng.submit(q, deadline=0.0)
    eng.drain()
    assert not cold.cached and dup.cached
    assert dup.t_planned <= cold.t_planned and dup.plan_ms <= cold.plan_ms


def test_run_until_done_is_a_deprecated_drain(both):
    (fed, _, stats, wl), _ = both
    eng = port_engine(fed, stats, max_batch=1)
    for q in wl:
        eng.submit(q)
    with pytest.warns(DeprecationWarning, match="drain"):
        with pytest.raises(RuntimeError, match="still queued"):
            eng.run_until_done(max_steps=1)
    assert len(eng.queue) == len(wl) - 1
    with pytest.warns(DeprecationWarning, match="drain"):
        assert len(eng.run_until_done()) == len(wl) - 1


# -- cardinality feedback ----------------------------------------------------

def _scan(obs_cls, source, est, obs):
    return obs_cls(kind="scan", source=source, star=0, est=est, obs=obs)


def _result(*observations):
    return SimpleNamespace(card_log=tuple(observations))


def test_feedback_units_equal_reference():
    traces = []
    for fb_cls, obs_cls in ((CardinalityFeedback, CardObservation),
                            (RefFeedback, RefObs)):
        fb = fb_cls(stats=None, fed=None, threshold_x=4.0, min_observations=3)
        fb.observe_result(_result(_scan(obs_cls, "A", 1.0, 7),
                                  _scan(obs_cls, "A", 1.0, 7)))
        t = [fb.dirty_sources()]
        fb.observe_result(_result(_scan(obs_cls, "A", 1.0, 7)))
        for _ in range(5):
            fb.observe_result(_result(_scan(obs_cls, "B", 10.0, 11)))
        t += [fb.dirty_sources(), fb.mean_error("A"), fb.mean_error("B"),
              fb.n_observations]
        fb2 = fb_cls(stats=None, fed=None, threshold_x=2.0, min_observations=1)
        fb2.observe_result(_result(
            obs_cls(kind="scan_bound", source="A", star=0, est=1.0, obs=99),
            obs_cls(kind="scan_merged", source="A", star=None, est=1.0,
                    obs=99),
            obs_cls(kind="join", source=None, star=None, est=4.0, obs=99),
            obs_cls(kind="scan", source="A", star=0, est=None, obs=99)))
        t += [fb2.dirty_sources(), fb2.n_observations]
        with pytest.raises(ValueError, match="threshold_x"):
            fb_cls(stats=None, fed=None, threshold_x=1.0)
        traces.append(t)
    assert traces[0] == traces[1]
    assert traces[0][:2] == [[], ["A"]] and traces[0][2] == pytest.approx(2.0)
    assert traces[0][5:] == [[], 0]
    assert estimation_error(1, 7) == pytest.approx(2.0)


def test_apply_pending_refreshes_the_same_source_into_equal_stats(both):
    (fed, _, stats, _), (rfed, _, rstats, _) = both
    stats, rstats = stats.clone(), rstats.clone()
    name = fed.sources[0].name
    fbs = [CardinalityFeedback(stats, fed, threshold_x=2.0, min_observations=2),
           RefFeedback(rstats, rfed, threshold_x=2.0, min_observations=2)]
    for fb, obs_cls in zip(fbs, (CardObservation, RefObs)):
        fb.observe_result(_result(_scan(obs_cls, name, 1.0, 50),
                                  _scan(obs_cls, name, 1.0, 50)))
        assert fb.dirty_sources() == [name]
    epoch = stats.epoch
    assert [fb.apply_pending() for fb in fbs] == [[name], [name]]
    assert stats.epoch == rstats.epoch == epoch + 1
    assert_same(stats, rstats, "stats")
    for fb, obs_cls in zip(fbs, (CardObservation, RefObs)):
        assert fb.refreshes == [name] and fb.dirty_sources() == []
        assert fb.apply_pending() == []
        fb.observe_result(_result(_scan(obs_cls, "no-such-endpoint", 1.0, 50),
                                  _scan(obs_cls, "no-such-endpoint", 1.0, 50)))
        assert fb.apply_pending() == []
    assert stats.epoch == epoch + 1


def _truncated(table_cls, table, frac, seed):
    rng = np.random.default_rng(seed)
    keep = np.sort(rng.choice(len(table), size=max(1, int(len(table) * frac)),
                              replace=False))
    return table_cls.from_triples(table.s[keep], table.p[keep], table.o[keep])


def test_serve_feedback_refreshes_drifted_source_like_reference():
    """Statistics built from a stale (10 %) snapshot of the largest source
    drift against live execution; in both packages the serve loop's
    feedback refreshes exactly that source once, the epoch bumps once, the
    refreshed statistics are equal, and every round's rows are equal."""
    runs = []
    for gen, spec, fed_cls, src_cls, table_cls, bld, wl, fb_cls, m, kw in (
            (generate_federation, fedbench_like_spec, Federation, Source,
             TripleTable, build_federated_stats, generate_workload,
             CardinalityFeedback, PORT, {"device": "cpu"}),
            (ref_gen, ref_spec, RefFederation, RefSource, RefTable, ref_build,
             ref_workload, RefFeedback, REF, {})):
        fed, gt = gen(spec(scale=0.06, seed=3))
        victim = max(fed.sources, key=lambda s: s.table.n_triples).name
        stale = fed_cls([src_cls(s.name, _truncated(table_cls, s.table, 0.1, 7)
                                 if s.name == victim else s.table)
                         for s in fed.sources], fed.dictionary)
        stats = bld(stale)
        fb = fb_cls(stats, fed, threshold_x=4.0, min_observations=3)
        eng = m.QueryServeEngine(fed, stats, feedback=fb, **kw)
        queries = wl(fed, gt, n_star=8, n_hybrid=6, n_path=0, seed=21)
        rounds = []
        for _ in range(4):
            for q in queries:
                eng.submit(q)
            rounds.append(sorted(eng.drain(), key=lambda r: r.qid))
        runs.append((victim, fb, eng, stats, rounds))
    (victim, fb, eng, stats, rounds), (rv, rfb, reng, rstats, rrounds) = runs
    assert victim == rv and fb.refreshes == rfb.refreshes == [victim]
    assert eng.serve_stats.n_stats_refreshes == 1
    assert stats.epoch == rstats.epoch == 1
    assert_same(stats, rstats, "stats")
    assert fb.mean_error(victim) == rfb.mean_error(victim)
    assert eng.optimizer.plan_cache.stale_evictions == \
        reng.optimizer.plan_cache.stale_evictions > 0
    for got, want in zip(rounds, rrounds):
        for r, w in zip(got, want):
            assert r.cached == w.cached and r.stats_epoch == w.stats_epoch
            for v in r.rows:
                assert r.rows[v].tobytes() == w.rows[v].tobytes()


def test_query_request_fields_equal_reference():
    """The reference's fields in its order, and the port's two stamps
    (``t_flushed``, ``t_exec``) in time order among its own."""
    got = [f.name for f in dataclasses.fields(serve.QueryRequest)]
    assert [n for n in got if n not in ("t_flushed", "t_exec")] == \
        [f.name for f in dataclasses.fields(ref_serve.QueryRequest)]
    assert got[got.index("t_submit"):] == ["t_submit", "t_flushed", "t_planned",
                                           "t_exec", "t_done"]


# -- kernel loading from the planner thread -----------------------------------

def test_kernel_library_loads_once_under_two_threads(monkeypatch):
    """``_lib``'s cache path from two threads at once, the build stubbed:
    the library is built and loaded once, and both threads get the same
    entry point."""
    calls = {"build": 0, "load": 0}
    barrier = threading.Barrier(2)

    def slow_build(names=None):
        calls["build"] += 1
        time.sleep(0.05)                   # a window for the other thread
        return list(names)

    class _Entry:
        pass

    class _Lib:
        def __init__(self, path):
            calls["load"] += 1
            self.entry = _Entry()

        def __getattr__(self, symbol):
            return self.entry

    monkeypatch.setattr(build, "build_kernels", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", _Lib)
    monkeypatch.delitem(build._LIBS, "dp_sweep", raising=False)
    got = []

    def load():
        barrier.wait()
        got.append(build._lib("dp_sweep"))

    threads = [threading.Thread(target=load) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == {"build": 1, "load": 1}
    assert len(got) == 2 and got[0] is got[1]
    assert got[0].restype is build.ctypes.c_int


def test_kernel_build_names_its_temporary_file_for_the_thread(monkeypatch,
                                                              tmp_path):
    """Two threads building the same source write different temporary files
    (named for the process and the thread), one build at a time; a failed
    nvcc raises in each caller."""
    outs = []

    class _Proc:
        returncode = 1

        def __init__(self, cmd, **kw):
            outs.append((threading.get_ident(), cmd[cmd.index("-o") + 1]))

        def communicate(self):
            return b"", b"stub: no compiler"

    monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", _Proc)
    errors = []
    both_built = threading.Barrier(2)      # both threads alive at once, so
                                           # their identities differ

    def run():
        try:
            build.build_kernels(("dp_sweep",))
        except RuntimeError as e:
            errors.append(str(e))
        both_built.wait()

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(errors) == 2 and all("nvcc exited 1" in e for e in errors)
    assert len({tmp for _, tmp in outs}) == 2
    for ident, tmp in outs:
        assert tmp.endswith(f".{ident}.tmp") and str(tmp_path) in tmp
