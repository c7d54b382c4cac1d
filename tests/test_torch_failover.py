"""The port's fault tolerance (``repro_torch.ft``: ``RetryPolicy``,
``StragglerMitigator``, ``Heartbeat``, ``FlakySource``, ``FailoverSession``,
``execute_with_failover``) and the pipeline's salvage and fault injection
against the reference package's, on the CPU.  Each test mirrors one of the
reference's own tests (``tests/test_failover.py``, ``tests/test_pipeline.py``
salvage and fault-injection tests, ``tests/test_substrate.py`` fault-tolerance
tests): the same ``FlakySource`` settings drive both packages, and every
``FailoverResult`` field equals the reference's (rows byte-equal, metrics
but the wall clock, ``card_log``, partial, excluded, replans, salvages,
cache hits, epoch, re-routes).  Sessions plan on ``device="cpu"`` (the DP
kernels' plain versions); they default to the card."""
import numpy as np
import pytest

pytest.importorskip("torch")

from test_stats_lifecycle import assert_stats_equal  # noqa: E402
from test_torch_pipeline import same_result  # noqa: E402

from repro.core.federation import build_federated_stats as ref_build  # noqa: E402
from repro.core.planner import OdysseyOptimizer as RefOptimizer  # noqa: E402
from repro.core.planner import _detach_plan as ref_detach  # noqa: E402
from repro.engine.local import LocalEngine as RefEngine  # noqa: E402
from repro.engine.pipeline import VirtualClock as RefClock  # noqa: E402
from repro.engine.pipeline import compile_plan as ref_compile  # noqa: E402
import repro.ft.failover as RF  # noqa: E402
import repro.ft.resilience as RR  # noqa: E402
from repro.rdf.dataset import Federation as RefFederation  # noqa: E402
from repro.rdf.generator import fedbench_like_spec as ref_spec  # noqa: E402
from repro.rdf.generator import generate_extended_workload as ref_ext  # noqa: E402
from repro.rdf.generator import generate_federation as ref_gen  # noqa: E402
from repro.rdf.generator import generate_workload as ref_workload  # noqa: E402
import repro_torch.ft as FT  # noqa: E402
import repro_torch.ft.failover as F  # noqa: E402
import repro_torch.ft.resilience as R  # noqa: E402
from repro_torch.core import join_order as jo  # noqa: E402
from repro_torch.core.federation import build_federated_stats  # noqa: E402
from repro_torch.core.planner import OdysseyOptimizer, _detach_plan  # noqa: E402
from repro_torch.engine.local import LocalEngine, naive_evaluate  # noqa: E402
from repro_torch.engine.pipeline import VirtualClock, compile_plan  # noqa: E402
from repro_torch.rdf.dataset import Federation, Source  # noqa: E402
from repro_torch.rdf.generator import (  # noqa: E402
    fedbench_like_spec,
    generate_extended_workload,
    generate_federation,
    generate_workload,
)

FIELDS = ("partial", "excluded", "replans", "salvages", "cache_hit",
          "stats_epoch", "rerouted")


def _build(scale, seed, workload):
    out = []
    for spec, gen, bld, wl, ext in (
            (fedbench_like_spec, generate_federation, build_federated_stats,
             generate_workload, generate_extended_workload),
            (ref_spec, ref_gen, ref_build, ref_workload, ref_ext)):
        fed, gt = gen(spec(scale=scale, seed=seed))
        out.append((fed, gt, bld(fed), workload(fed, gt, wl, ext)))
    return out


@pytest.fixture(scope="module")
def small():
    """``(port, reference)`` on the reference tests' ``small_*`` fixtures:
    ``(fed, gt, stats, workload)``."""
    return _build(0.2, 11, lambda fed, gt, wl, ext: wl(
        fed, gt, n_star=8, n_hybrid=8, n_path=4, seed=5))


@pytest.fixture(scope="module")
def tiny():
    """``(port, reference)`` on the ``tiny_*`` fixtures; the workload adds
    the salvage tests' cross-source hybrids, paths and algebra families."""
    return _build(0.06, 3, lambda fed, gt, wl, ext: (
        wl(fed, gt, n_star=4, n_hybrid=4, n_path=2, seed=9)
        + wl(fed, gt, n_star=0, n_hybrid=6, n_path=6, seed=33)
        + ext(fed, gt, seed=17)))


def _result_set(rel, proj):
    n = len(next(iter(rel.values()))) if rel else 0
    return set(zip(*[rel[v].tolist() for v in proj])) if n else set()


def _flaky(both, kw=lambda name: {}):
    """The two federations wrapped in each package's ``FlakySource``, with
    ``kw(name)`` as each source's settings, and the port's federation of
    the survivors (every source but ``DBpedia``)."""
    (fed, *_), (rfed, *_) = both
    flaky = Federation([F.FlakySource(s, **kw(s.name)) for s in fed.sources],
                       fed.dictionary)
    rflaky = RefFederation([RF.FlakySource(s, **kw(s.name))
                            for s in rfed.sources], rfed.dictionary)
    survivors = Federation([s for s in fed.sources if s.name != "DBpedia"],
                           fed.dictionary)
    return flaky, rflaky, survivors


def _dead_dbpedia(name):
    return {"dead": name == "DBpedia"}


def same_failover(got, want, name):
    """Every ``FailoverResult`` field equal to the reference's (the metrics
    but ``wall_ms``)."""
    assert type(got) is F.FailoverResult and type(want) is RF.FailoverResult
    same_result(got, want, name)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), (name, f)


def _queries(both):
    (_, _, _, wl), (_, _, _, rwl) = both
    assert [q.name for q in wl] == [q.name for q in rwl]
    return list(zip(wl, rwl))


# --------------------------------------------------------------------------
# tests/test_failover.py
# --------------------------------------------------------------------------

def test_transient_failure_recovers_complete(small):
    flaky, rflaky, _ = _flaky(small, kw=lambda name: {"fail_times": 1})
    (fed, _, stats, _), (_, _, rstats, _) = small
    (q, rq), = _queries(small)[:1]
    res = F.execute_with_failover(
        flaky, stats, q, R.RetryPolicy(max_attempts=3, base_delay_s=0.0),
        device="cpu")
    ref = RF.execute_with_failover(
        rflaky, rstats, rq, RR.RetryPolicy(max_attempts=3, base_delay_s=0.0))
    same_failover(res, ref, q.name)
    assert not res.partial
    assert _result_set(res.rows, q.effective_projection()) == \
        naive_evaluate(fed, q)


def test_dead_endpoint_salvages_and_flags_partial(small):
    flaky, rflaky, survivors = _flaky(small, kw=_dead_dbpedia)
    (_, _, stats, _), (_, _, rstats, _) = small
    hit = 0
    for q, rq in _queries(small):
        res = F.execute_with_failover(flaky, stats, q, device="cpu")
        same_failover(res, RF.execute_with_failover(rflaky, rstats, rq),
                      q.name)
        assert _result_set(res.rows, q.effective_projection()) == \
            naive_evaluate(survivors, q)
        if res.partial:
            hit += 1
            assert res.excluded == ["DBpedia"]
            assert res.salvages >= 1 and res.replans == 0
    assert hit > 0


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_dead_endpoint_replan_mode_still_replans(small, backend):
    """``salvage=False``: exclude and replan, on the port's CPU sweep and on
    its numpy backend, with one session for the workload (as the reference
    test) and with a fresh session a query, where every query that touches
    the dead endpoint replans; a multi-star replan reaches the device sweep
    only on the former backend."""
    flaky, rflaky, survivors = _flaky(small, kw=_dead_dbpedia)
    (_, _, stats, _), (_, _, rstats, _) = small
    session = F.FailoverSession(flaky, stats, salvage=False,
                                dp_backend=backend, device="cpu")
    rsession = RF.FailoverSession(rflaky, rstats, salvage=False)
    hit = replan_sweeps = 0
    for fresh in (False, True):
        for q, rq in _queries(small):
            if fresh:
                session = F.FailoverSession(flaky, stats, salvage=False,
                                            dp_backend=backend, device="cpu")
                rsession = RF.FailoverSession(rflaky, rstats, salvage=False)
            before = dict(jo.DP_SWEEP_COUNTERS)
            res = session.execute(q)
            swept = sum(jo.DP_SWEEP_COUNTERS[k] - before[k]
                        for k in ("resident", "tiled"))
            same_failover(res, rsession.execute(rq), q.name)
            assert _result_set(res.rows, q.effective_projection()) == \
                naive_evaluate(survivors, q)
            if res.partial and res.replans:
                hit += 1
                assert res.salvages == 0
                # a multi-star query sweeps for its plan and its replan
                replan_sweeps += swept == 2
            if backend == "numpy":
                assert swept == 0
    assert hit > 1
    assert (replan_sweeps > 0) == (backend == "torch")


def test_failover_session_plan_cache_survives_replan(small):
    flaky, rflaky, survivors = _flaky(small, kw=_dead_dbpedia)
    (_, _, stats, _), (_, _, rstats, _) = small
    session = F.FailoverSession(flaky, stats, device="cpu")
    rsession = RF.FailoverSession(rflaky, rstats)
    pairs = _queries(small)
    passes = []
    for _ in range(3):
        got = [session.execute(q) for q, _ in pairs]
        want = [rsession.execute(rq) for _, rq in pairs]
        for (q, _), g, w in zip(pairs, got, want):
            same_failover(g, w, q.name)
        passes.append(got)
    first, second, third = passes
    kill = next(i for i, r in enumerate(first)
                if r.salvages >= 1 or r.replans >= 1)
    assert all(r.partial and r.excluded == ["DBpedia"] for r in first[kill:])
    epoch = session.stats.epoch
    assert epoch >= 1 and epoch == rsession.stats.epoch
    assert all(r.cache_hit and r.replans == 0 for r in second[kill + 1:])
    assert all(not r.cache_hit for r in second[:kill + 1])
    assert all(r.stats_epoch == epoch for r in second)
    assert all(r.cache_hit and r.replans == 0 for r in third)
    assert [s.sid for s in flaky.sources] == list(range(len(flaky.sources)))
    for (q, _), r in zip(pairs[kill:], second[kill:]):
        assert _result_set(r.rows, q.effective_projection()) == \
            naive_evaluate(survivors, q)


def test_failover_session_execute_batch(small):
    flaky, rflaky, survivors = _flaky(small, kw=_dead_dbpedia)
    (_, _, stats, wl), (_, _, rstats, rwl) = small
    session = F.FailoverSession(flaky, stats, device="cpu")
    rsession = RF.FailoverSession(rflaky, rstats)
    batches = []
    for _ in range(3):
        got, want = session.execute_batch(wl), rsession.execute_batch(rwl)
        assert len(got) == len(want) == len(wl)
        for q, g, w in zip(wl, got, want):
            same_failover(g, w, q.name)
            assert _result_set(g.rows, q.effective_projection()) == \
                naive_evaluate(survivors, q)
        batches.append(got)
    first, second, third = batches
    assert session.excluded == rsession.excluded == ["DBpedia"]
    assert any(r.replans >= 1 for r in first)
    assert any(r.salvages >= 1 for r in first)
    kill = next(i for i, r in enumerate(first) if r.replans >= 1)
    epoch = session.stats.epoch
    assert {r.stats_epoch for r in second} == {epoch}
    assert all(r.cache_hit and r.replans == 0 for r in second[kill + 1:])
    assert all(not r.cache_hit for r in second[:kill + 1])
    assert all(r.cache_hit and r.replans == 0 for r in third)


def test_failover_session_restore_recovers_completeness(small):
    flaky, rflaky, survivors = _flaky(small, kw=_dead_dbpedia)
    (fed, _, stats, _), (_, _, rstats, _) = small
    session = F.FailoverSession(flaky, stats, device="cpu")
    rsession = RF.FailoverSession(rflaky, rstats)
    q, rq = next((q, rq) for q, rq in _queries(small)
                 if len(naive_evaluate(fed, q))
                 != len(naive_evaluate(survivors, q)))
    res = session.execute(q)
    same_failover(res, rsession.execute(rq), q.name)
    assert res.partial and res.excluded == ["DBpedia"]
    for fl in (flaky, rflaky):
        next(s for s in fl.sources if s.name == "DBpedia").dead = False
    epoch = session.stats.epoch
    sid = session.restore("DBpedia")
    assert sid == rsession.restore("DBpedia") == len(session.fed.sources) - 1
    assert session.stats.epoch == epoch + 1 == rsession.stats.epoch
    assert_stats_equal(session.stats, rsession.stats)
    res2 = session.execute(q)
    same_failover(res2, rsession.execute(rq), q.name)
    assert not res2.partial and not res2.excluded and not res2.cache_hit
    assert _result_set(res2.rows, q.effective_projection()) == \
        naive_evaluate(fed, q)
    order = [s.name for s in session.fed.sources]
    rebuilt = build_federated_stats(Federation(
        [Source(n, fed.by_name(n).table) for n in order], fed.dictionary))
    assert_stats_equal(session.stats, rebuilt)
    with pytest.raises(ValueError, match="not excluded"):
        session.restore("DBpedia")


def test_execute_with_failover_session_and_retry_conflict(small):
    flaky, _, _ = _flaky(small)
    (_, _, stats, wl), _ = small
    session = F.FailoverSession(flaky, stats, device="cpu")
    with pytest.raises(ValueError, match="retry policy"):
        F.execute_with_failover(flaky, stats, wl[0], R.RetryPolicy(),
                                session=session)


# --------------------------------------------------------------------------
# tests/test_pipeline.py: mid-query salvage, re-routes, mid-scan death
# --------------------------------------------------------------------------

def _flaky_by_name(both):
    flaky, rflaky, _ = _flaky(both)
    return (flaky, {s.name: s for s in flaky.sources},
            rflaky, {s.name: s for s in rflaky.sources})


def _plans(both):
    (_, _, stats, wl), (_, _, rstats, rwl) = both
    opt, ref = OdysseyOptimizer(stats, device="cpu"), RefOptimizer(rstats)
    return [(q, opt.optimize(q), ref.optimize(rq)) for q, rq in zip(wl, rwl)]


def _channels(exec_):
    return {ch.name: (ch.physical_scans, ch.physical_tuples, len(ch._scans))
            for ch in exec_.channels.values()}


def test_salvage_never_recomputes_shipped_tuples(tiny):
    """Kill the last-scheduled endpoint mid-query: the port's scan order,
    channel counters before and after the salvage, re-routes and salvaged
    rows equal the reference's, no scan key runs twice, and fully shipped
    survivors do no new physical work."""
    fed = tiny[0][0]
    exercised = strict = 0
    for q, plan, rplan in _plans(tiny):
        flaky, by_name, rflaky, rby_name = _flaky_by_name(tiny)
        exec_ = compile_plan(_detach_plan(plan), flaky, honor_faults=True)
        rexec = ref_compile(ref_detach(rplan), rflaky, honor_faults=True)
        order = [flaky.sources[pos].name for _, pos in exec_.scan_order()]
        assert order == [rflaky.sources[pos].name
                         for _, pos in rexec.scan_order()]
        first_idx: dict = {}
        for i, nm in enumerate(order):
            first_idx.setdefault(nm, i)
        late = [nm for nm, i in first_idx.items() if i > 0]
        if not late:
            continue
        victim = max(late, key=lambda nm: first_idx[nm])
        vi = first_idx[victim]
        completed = {nm for nm in first_idx if nm != victim
                     and all(i < vi for i, n2 in enumerate(order) if n2 == nm)}
        bound_names = {flaky.sources[pos].name for op in exec_.subquery_ops
                       if op.bound for pos in op.slots}
        by_name[victim].dead = rby_name[victim].dead = True
        with pytest.raises(F.EndpointDown):
            exec_.run()
        with pytest.raises(RF.EndpointDown):
            rexec.run()
        done = _channels(exec_)
        assert done == _channels(rexec)
        routed = exec_.drop_source(victim)
        assert routed == rexec.drop_source(victim)
        res = exec_.run()
        same_result(res, rexec.run(), q.name)
        assert exec_.salvages == rexec.salvages == 1
        assert exec_.rerouted == rexec.rerouted
        assert _channels(exec_) == _channels(rexec)
        exercised += 1
        for ch in exec_.channels.values():
            assert ch.physical_scans == len(ch._scans)
            if (ch.name in completed and ch.name in done
                    and ch.name not in routed and ch.name not in bound_names):
                assert (ch.physical_scans, ch.physical_tuples) == \
                    done[ch.name][:2]
                strict += 1
        survivors = Federation([s for s in fed.sources if s.name != victim],
                               fed.dictionary)
        assert _result_set(res.rows, q.effective_projection()) == \
            naive_evaluate(survivors, q)
    assert exercised >= 2 and strict >= 1


def test_salvage_reroutes_to_alternate_relevant_source(tiny):
    """An alternate relevant source registered on the selection takes the
    dead endpoint's star: the port routes to the same sources as the
    reference, and its re-routed run equals the reference's and the
    recursive evaluation of the re-pointed plan."""
    fed = tiny[0][0]
    exercised = 0
    for q, plan0, rplan0 in _plans(tiny)[:10]:
        plan, rplan = _detach_plan(plan0), ref_detach(rplan0)
        leaf = next((n for n in plan.subqueries() if len(n.stars) == 1), None)
        if leaf is None:
            continue
        keep = leaf.sources[0]
        if any(keep in n.sources for n in plan.subqueries() if n is not leaf):
            continue
        rleaf = next(n for n in rplan.subqueries() if n.stars == leaf.stars)
        alts = None
        for pl, lf in ((plan, leaf), (rplan, rleaf)):
            sel_star = pl.selection.star_sources[lf.stars[0]]
            sel_star.append(next(i for i in range(len(fed.sources))
                                 if i not in sel_star))
            alts = sorted(a for a in sel_star if a != keep)
            lf.sources = [keep]
            lf.est_source_cards = (lf.est_source_cards or [0.0])[:1]
        flaky, by_name, rflaky, rby_name = _flaky_by_name(tiny)
        exec_ = compile_plan(plan, flaky, honor_faults=True)
        rexec = ref_compile(rplan, rflaky, honor_faults=True)
        victim = fed.sources[keep].name
        by_name[victim].dead = rby_name[victim].dead = True
        with pytest.raises(F.EndpointDown):
            exec_.run()
        with pytest.raises(RF.EndpointDown):
            rexec.run()
        routed = exec_.drop_source(victim)
        assert routed == rexec.drop_source(victim)
        assert set(routed) == {fed.sources[a].name for a in alts}
        assert exec_.rerouted == rexec.rerouted == [(victim, nm)
                                                    for nm in routed]
        res = exec_.run()
        same_result(res, rexec.run(), q.name)
        ref_plan = _detach_plan(plan)
        next(n for n in ref_plan.subqueries()
             if n.stars == leaf.stars).sources = list(alts)
        rec = LocalEngine(flaky, use_pipeline=False).execute(ref_plan)
        assert set(rec.rows) == set(res.rows)
        for v in res.rows:
            assert np.array_equal(res.rows[v], rec.rows[v]), v
        assert (res.metrics.transferred_tuples, res.metrics.requests) == \
            (rec.metrics.transferred_tuples, rec.metrics.requests)
        exercised += 1
    assert exercised >= 1


def test_mid_scan_death_after_n_tuples(tiny):
    """``die_after_tuples=0`` on the first scheduled endpoint: the death is
    sticky and mid-stream in both packages, with equal tuples served, and
    the salvaged rows equal the reference's and the survivors' oracle."""
    fed = tiny[0][0]
    exercised = 0
    for q, plan, rplan in _plans(tiny)[:10]:
        flaky, by_name, rflaky, rby_name = _flaky_by_name(tiny)
        probe = compile_plan(plan, flaky, honor_faults=True)
        victim = flaky.sources[probe.scan_order()[0][1]].name
        by_name[victim].die_after_tuples = 0
        rby_name[victim].die_after_tuples = 0
        exec_ = compile_plan(_detach_plan(plan), flaky, honor_faults=True)
        rexec = ref_compile(ref_detach(rplan), rflaky, honor_faults=True)
        died = []
        for ex, exc in ((exec_, F.EndpointDown), (rexec, RF.EndpointDown)):
            try:
                ex.run()
            except exc:
                died.append(True)
            else:
                died.append(False)
        assert died[0] == died[1]
        if not died[0]:
            continue
        assert by_name[victim].dead and rby_name[victim].dead
        assert by_name[victim].tuples_served == \
            rby_name[victim].tuples_served > 0
        exec_.drop_source(victim)
        rexec.drop_source(victim)
        res = exec_.run()
        same_result(res, rexec.run(), q.name)
        survivors = Federation([s for s in fed.sources if s.name != victim],
                               fed.dictionary)
        assert _result_set(res.rows, q.effective_projection()) == \
            naive_evaluate(survivors, q)
        exercised += 1
    assert exercised >= 2


def test_virtual_clock_charges_flaky_latency(tiny):
    """``FlakySource.latency_s`` is charged per physical scan on the virtual
    clock: the port's total equals the reference's and the closed form."""
    (fed, *_), (rfed, *_) = tiny
    lat = {s.name: 0.01 * (i + 1) for i, s in enumerate(fed.sources)}
    flaky = Federation([F.FlakySource(s, latency_s=lat[s.name])
                        for s in fed.sources], fed.dictionary)
    rflaky = RefFederation([RF.FlakySource(s, latency_s=lat[s.name])
                            for s in rfed.sources], rfed.dictionary)
    for q, plan, rplan in _plans(tiny)[:6]:
        clock, rclock = VirtualClock(), RefClock()
        ex = compile_plan(plan, flaky, honor_faults=True, clock=clock)
        rex = ref_compile(rplan, rflaky, honor_faults=True, clock=rclock)
        same_result(ex.run(), rex.run(), q.name)
        assert clock.t == rclock.t == pytest.approx(
            sum(ch.physical_scans * lat[ch.name]
                for ch in ex.channels.values()))


def test_failover_engine_checks_on_the_recursive_path(tiny):
    """``FailoverEngine`` honours faults per scan on the pipeline and per
    subquery on the recursive path, as the reference's does."""
    rfed = tiny[1][0]
    flaky, by_name, rflaky, rby_name = _flaky_by_name(tiny)
    q, plan, rplan = _plans(tiny)[0]
    victim = flaky.sources[plan.subqueries()[0].sources[0]].name
    assert F.FailoverEngine.honor_faults and RF.FailoverEngine.honor_faults
    by_name[victim].dead = rby_name[victim].dead = True
    for eng, p, exc in ((F.FailoverEngine(flaky), plan, F.EndpointDown),
                        (RF.FailoverEngine(rflaky), rplan, RF.EndpointDown)):
        for run in (eng.execute, eng.execute_recursive):
            with pytest.raises(exc, match=victim):
                run(p)
    by_name[victim].dead = rby_name[victim].dead = False
    same_result(F.FailoverEngine(flaky).execute_recursive(plan),
                RF.FailoverEngine(rflaky).execute_recursive(rplan), q.name)
    same_result(F.FailoverEngine(flaky).execute(plan),
                RefEngine(rfed).execute(rplan), q.name)


# --------------------------------------------------------------------------
# tests/test_substrate.py: retry, straggler backups, heartbeats
# --------------------------------------------------------------------------

def _flaky_fn(fail_first):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fail_first:
            raise RuntimeError("endpoint down")
        return 42
    return fn, calls


@pytest.mark.parametrize("max_attempts,fail_first", [(4, 2), (2, 2), (3, 0)])
def test_retry_policy_equals_reference(max_attempts, fail_first):
    """Same outcome, same calls, same ``on_retry`` attempts and the same
    injected sleeps (exponential backoff) as the reference's policy."""
    outs = []
    for mod in (R, RR):
        slept, retried = [], []
        fn, calls = _flaky_fn(fail_first)
        pol = mod.RetryPolicy(max_attempts=max_attempts, base_delay_s=0.5,
                              backoff=3.0, sleep=slept.append)
        try:
            out = pol.run(fn, on_retry=lambda a, e: retried.append(a))
        except RuntimeError as exc:
            out = (type(exc).__name__, str(exc),
                   type(exc.__cause__).__name__)
        outs.append((out, calls["n"], slept, retried))
    assert outs[0] == outs[1]
    if fail_first >= max_attempts:
        assert outs[0][0][1].startswith("retries exhausted")


def test_retry_policy_recovers_and_exhausts():
    fn, _ = _flaky_fn(2)
    assert R.RetryPolicy(max_attempts=4, base_delay_s=0.001).run(fn) == 42
    with pytest.raises(RuntimeError):
        R.RetryPolicy(max_attempts=2, base_delay_s=0.001).run(
            lambda: (_ for _ in ()).throw(RuntimeError("x")))


class _Clock:
    """A fake ``time`` module for ``repro_torch.ft.resilience``: each
    ``fn`` the mitigator runs advances it by its scripted latency."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    monotonic = perf_counter

    def take(self, dt, value):
        def fn():
            self.t += dt
            return value
        return fn


def test_straggler_backup_issued(monkeypatch):
    """Three fast dispatches set the EWMA; a fourth past ``factor`` times it
    issues exactly one backup and returns the backup's answer (the
    reference's test, on a scripted clock instead of sleeps)."""
    clock = _Clock()
    monkeypatch.setattr(R, "time", clock)
    sm = R.StragglerMitigator(factor=2.0, min_samples=2)
    for _ in range(3):
        assert sm.run_with_backup("ep", clock.take(0.001, 1), lambda: 2) == 1
    out = sm.run_with_backup("ep", clock.take(0.08, 1), lambda: 2)
    assert out == 2 and sm.backups_issued == 1
    assert sm.run_with_backup("other", clock.take(1.0, 3), lambda: 4) == 3


def test_straggler_ewma_equals_reference():
    sm, rsm = R.StragglerMitigator(), RR.StragglerMitigator()
    for i, lat in enumerate([0.1, 0.3, 0.2, 0.05, 0.4]):
        for m in (sm, rsm):
            m.observe("ep", lat)
        assert sm.deadline_s("ep") == rsm.deadline_s("ep"), i
    assert sm._ewma == rsm._ewma and sm._count == rsm._count


def test_heartbeat_detects_dead(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(R, "time", clock)
    hb = R.Heartbeat(timeout_s=0.0)
    hb.beat("n1")
    clock.t += 0.01
    assert hb.dead() == ["n1"]
    live = R.Heartbeat(timeout_s=60.0)
    live.beat("n2")
    clock.t += 59.0
    assert live.dead() == []
    clock.t += 2.0
    assert live.dead() == ["n2"]
    assert set(FT.__all__) == {"RetryPolicy", "StragglerMitigator",
                               "Heartbeat"}
