"""The port's planning loop as a whole against the reference package, on a
tiny FedBench-like federation: statistics, decomposition, source selection,
cardinality estimation, the join-order DP (torch backend on the CPU, i.e. the
kernels' plain versions) and the recursive ``LocalEngine``.  Plans are equal
node for node, rows and NTT/request counts equal the reference engine's, and
answers equal ``naive_evaluate``."""
import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_stats import assert_same  # noqa: E402

from repro.core.federation import build_federated_stats as ref_build  # noqa: E402
from repro.core.planner import OdysseyOptimizer as RefOptimizer  # noqa: E402
from repro.engine.local import LocalEngine as RefEngine  # noqa: E402
from repro.rdf.generator import fedbench_like_spec as ref_spec  # noqa: E402
from repro.rdf.generator import generate_extended_workload as ref_ext  # noqa: E402
from repro.rdf.generator import generate_federation as ref_gen  # noqa: E402
from repro.rdf.generator import generate_workload as ref_workload  # noqa: E402
from repro_torch.core import join_order as jo  # noqa: E402
from repro_torch.core.federation import build_federated_stats  # noqa: E402
from repro_torch.core.planner import OdysseyOptimizer  # noqa: E402
from repro_torch.engine.local import LocalEngine, naive_evaluate  # noqa: E402
from repro_torch.rdf.generator import (  # noqa: E402
    fedbench_like_spec,
    generate_extended_workload,
    generate_federation,
    generate_workload,
)

PLAN_FIELDS = ("root", "graph", "selection", "fallback", "stats_epoch",
               "well_designed")


@pytest.fixture(scope="module")
def both():
    """``(port, reference)``, each ``(fed, stats, queries)`` from the same
    seeds: the BGP workload plus the OPTIONAL/UNION/FILTER families."""
    out = []
    for spec, gen, build, wl, ext in (
            (fedbench_like_spec, generate_federation, build_federated_stats,
             generate_workload, generate_extended_workload),
            (ref_spec, ref_gen, ref_build, ref_workload, ref_ext)):
        fed, gt = gen(spec(scale=0.06, seed=3))
        queries = wl(fed, gt, seed=5) + ext(fed, gt, seed=17)
        out.append((fed, build(fed), queries))
    return out


def _answers(rel, q):
    proj = q.effective_projection()
    n = len(next(iter(rel.values()))) if rel else 0
    return set(zip(*[rel[v].tolist() for v in proj])) if n else set()


def _same_plan(got, want, name):
    for f in PLAN_FIELDS:
        assert_same(getattr(got, f), getattr(want, f), f"{name}.{f}")


def test_plans_rows_and_ntt_equal_reference(both):
    (fed, stats, queries), (rfed, rstats, rqueries) = both
    assert len(queries) == len(rqueries) > 20
    opt = OdysseyOptimizer(stats, device="cpu")
    opt_np = OdysseyOptimizer(stats, dp_backend="numpy")
    ref = RefOptimizer(rstats)
    eng, ref_eng = LocalEngine(fed), RefEngine(rfed)
    before = dict(jo.DP_SWEEP_COUNTERS)
    nonempty = 0
    for q, rq in zip(queries, rqueries):
        assert q.name == rq.name
        plan, want = opt.optimize(q), ref.optimize(rq)
        _same_plan(plan, want, q.name)
        _same_plan(opt_np.optimize(q), want, q.name)
        res, rres = eng.execute(plan), ref_eng.execute(want)
        assert list(res.rows) == list(rres.rows), q.name
        for v in res.rows:
            assert res.rows[v].dtype == rres.rows[v].dtype
            np.testing.assert_array_equal(res.rows[v], rres.rows[v],
                                          err_msg=f"{q.name}.{v}")
        for m in ("transferred_tuples", "requests", "intermediate_rows",
                  "overflowed"):
            assert getattr(res.metrics, m) == getattr(rres.metrics, m), \
                (q.name, m)
        got = _answers(res.rows, q)
        assert got == naive_evaluate(fed, q), q.name
        nonempty += bool(got)
    assert nonempty > len(queries) // 2
    assert jo.DP_SWEEP_COUNTERS["resident"] > before["resident"]


def test_plan_cache_follows_the_statistics_epoch(both):
    """Cache hits until the statistics change; after ``remove_source`` the
    port replans, and its plans equal the reference's under the same change."""
    (_, stats, queries), (_, rstats, rqueries) = both
    stats, rstats = stats.clone(), rstats.clone()
    opt = OdysseyOptimizer(stats, device="cpu")
    ref = RefOptimizer(rstats)
    q, rq = queries[0], rqueries[0]
    first = opt.optimize(q)
    again = opt.optimize(q)
    assert not first.cached and again.cached
    _same_plan(again, ref.optimize(rq), q.name)
    sid = first.subqueries()[0].sources[0]
    stats.remove_source(sid)
    rstats.remove_source(sid)
    assert stats.epoch == rstats.epoch > first.stats_epoch
    assert_same(stats.fed_cp, rstats.fed_cp, "fed_cp")
    assert not opt.optimize(q).cached
    for q, rq in zip(queries[:8], rqueries[:8]):
        plan = opt.optimize(q)
        assert plan.stats_epoch == stats.epoch
        _same_plan(plan, ref.optimize(rq), q.name)
