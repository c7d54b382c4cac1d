"""The port's operator pipeline (``repro_torch.engine.pipeline``, behind
``LocalEngine.execute``) against the reference package's pipeline and the
port's own recursive evaluator, on the CPU: the BGP workload and the
OPTIONAL/UNION/FILTER families, planned on ``device="cpu"``, under the three
scan policies.  Rows are byte-equal (same order and dtype), and
``ExecutionMetrics`` and ``card_log`` equal the reference's; the virtual
clock charges each physical scan its endpoint's latency, as the
reference's does."""
import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_batch_planner import to_port  # noqa: E402
from test_torch_stats import assert_same  # noqa: E402

from repro.core.federation import build_federated_stats as ref_build  # noqa: E402
from repro.core.planner import OdysseyOptimizer as RefOptimizer  # noqa: E402
from repro.engine.local import LocalEngine as RefEngine  # noqa: E402
from repro.engine.pipeline import VirtualClock as RefClock  # noqa: E402
from repro.engine.pipeline import compile_plan as ref_compile  # noqa: E402
from repro.ft.failover import FlakySource  # noqa: E402
from repro.query.algebra import certain_variables as ref_certain  # noqa: E402
from repro.query.algebra import from_algebra as ref_from_algebra  # noqa: E402
from repro.rdf.dataset import Federation as RefFederation  # noqa: E402
from repro.rdf.generator import fedbench_like_spec as ref_spec  # noqa: E402
from repro.rdf.generator import generate_extended_workload as ref_ext  # noqa: E402
from repro.rdf.generator import generate_federation as ref_gen  # noqa: E402
from repro.rdf.generator import generate_workload as ref_workload  # noqa: E402
import repro_torch.engine as E  # noqa: E402
from repro_torch.core.federation import build_federated_stats  # noqa: E402
from repro_torch.core.planner import OdysseyOptimizer  # noqa: E402
from repro_torch.engine.local import LocalEngine, naive_evaluate  # noqa: E402
from repro_torch.engine.pipeline import VirtualClock, compile_plan  # noqa: E402
from repro_torch.rdf.dataset import Federation  # noqa: E402
from repro_torch.rdf.generator import (  # noqa: E402
    fedbench_like_spec,
    generate_extended_workload,
    generate_federation,
    generate_workload,
)

METRICS = ("transferred_tuples", "requests", "intermediate_rows",
           "overflowed")
POLICIES = ("static", "adaptive", "random")


@pytest.fixture(scope="module")
def both():
    """``(port, reference)``, each ``(fed, gt, stats, queries, plans)`` from
    the same seeds: the BGP workload plus the OPTIONAL/UNION/FILTER
    families, planned by the port on the CPU and by the reference's numpy
    backend."""
    out = []
    for spec, gen, bld, wl, ext, opt in (
            (fedbench_like_spec, generate_federation, build_federated_stats,
             generate_workload, generate_extended_workload,
             lambda s: OdysseyOptimizer(s, device="cpu")),
            (ref_spec, ref_gen, ref_build, ref_workload, ref_ext,
             RefOptimizer)):
        fed, gt = gen(spec(scale=0.06, seed=3))
        stats = bld(fed)
        queries = wl(fed, gt, seed=5) + ext(fed, gt, seed=17)
        o = opt(stats)
        out.append((fed, gt, stats, queries, [o.optimize(q) for q in queries]))
    return out


def same_result(got, want, name):
    """Rows byte-equal (columns, order, dtype), metrics and ``card_log``
    equal."""
    assert list(got.rows) == list(want.rows), name
    for v in got.rows:
        assert got.rows[v].dtype == want.rows[v].dtype, (name, v)
        assert got.rows[v].tobytes() == want.rows[v].tobytes(), (name, v)
    for m in METRICS:
        assert getattr(got.metrics, m) == getattr(want.metrics, m), (name, m)
    assert_same(list(got.card_log), list(want.card_log), f"{name}.card_log")


def _rng(policy, i):
    return np.random.default_rng(100 + i) if policy == "random" else None


@pytest.mark.parametrize("policy", POLICIES)
def test_pipeline_equals_reference_pipeline(both, policy):
    (fed, _, _, queries, plans), (rfed, _, _, rqueries, rplans) = both
    assert len(queries) > 20
    for i, (q, plan, rplan) in enumerate(zip(queries, plans, rplans)):
        ex = compile_plan(plan, fed, policy=policy, rng=_rng(policy, i))
        rex = ref_compile(rplan, rfed, policy=policy, rng=_rng(policy, i))
        assert [(op.node.stars, pos) for op, pos in ex.scan_order()] == \
            [(op.node.stars, pos) for op, pos in rex.scan_order()], q.name
        ex = compile_plan(plan, fed, policy=policy, rng=_rng(policy, i))
        rex = ref_compile(rplan, rfed, policy=policy, rng=_rng(policy, i))
        res, rres = ex.run(), rex.run()
        same_result(res, rres, q.name)
        assert res.stats_epoch == rres.stats_epoch
        assert ex.physical_scans == rex.physical_scans, q.name
        assert ex.physical_tuples == rex.physical_tuples, q.name


@pytest.mark.parametrize("policy", POLICIES)
def test_pipeline_equals_recursive_and_oracle(both, policy):
    """The pipeline under each policy returns the recursive evaluator's rows
    and metrics; the recursive path logs no cardinality samples, the
    pipeline one per dispatch and operator; answers equal the oracle's."""
    (fed, _, _, queries, plans), _ = both
    eng = LocalEngine(fed, scan_policy=policy)
    rec = LocalEngine(fed, use_pipeline=False)
    nonempty = 0
    for i, (q, plan) in enumerate(zip(queries, plans)):
        got = (eng.execute(plan) if policy != "random" else
               compile_plan(plan, fed, policy="random",
                            rng=_rng(policy, i)).run())
        want = rec.execute(plan)
        assert want.card_log == () and len(got.card_log) >= 1
        assert list(got.rows) == list(want.rows), q.name
        for v in got.rows:
            assert got.rows[v].tobytes() == want.rows[v].tobytes(), (q.name, v)
        for m in METRICS:
            assert getattr(got.metrics, m) == getattr(want.metrics, m)
        scans = [ob for ob in got.card_log if ob.kind.startswith("scan")]
        assert sum(ob.obs for ob in scans) == got.metrics.transferred_tuples
        assert len(scans) == got.metrics.requests
        proj = q.effective_projection()
        n = len(next(iter(got.rows.values()))) if got.rows else 0
        ans = set(zip(*[got.rows[v].tolist() for v in proj])) if n else set()
        assert ans == naive_evaluate(fed, q), q.name
        nonempty += bool(ans)
    assert nonempty > len(queries) // 2


def test_local_engine_defaults_and_reference_engine(both):
    """``LocalEngine`` has the reference's constructor and runs the pipeline
    by default; its results equal the reference engine's, ``card_log``
    included."""
    (fed, _, _, queries, plans), (rfed, _, _, _, rplans) = both
    eng, reng = LocalEngine(fed), RefEngine(rfed)
    assert eng.use_pipeline and eng.scan_policy == "static"
    assert eng.clock is None and LocalEngine.honor_faults is False
    for q, plan, rplan in zip(queries, plans, rplans):
        same_result(eng.execute(plan), reng.execute(rplan), q.name)
    with pytest.raises(ValueError, match="policy"):
        compile_plan(plans[0], fed, policy="fastest")
    assert set(E.__all__) >= {"CardObservation", "PipelineExecution",
                              "SourceChannel", "VirtualClock", "compile_plan"}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_group_trees_equal_reference(both, seed):
    """Seeded random group trees (the reference pipeline tests' space), built
    on the reference side and rebuilt from the port's classes: the port's
    pipeline equals the reference's pipeline and the port's recursive
    evaluator."""
    from test_algebra import _random_tree, _star_leaves

    (fed, _, stats, _, _), (rfed, rgt, rstats, _, _) = both
    rng = np.random.default_rng(300 + seed)
    leaves = _star_leaves(rfed, rgt, rng)
    opt, ref = OdysseyOptimizer(stats, device="cpu"), RefOptimizer(rstats)
    eng, reng = LocalEngine(fed), RefEngine(rfed)
    for i in range(5):
        root = _random_tree(rng, leaves, depth=int(rng.integers(1, 4)))
        rq = ref_from_algebra(root, distinct=bool(rng.random() < 0.5),
                              projection=sorted(ref_certain(root)))
        q = to_port(rq)
        plan = opt.optimize(q)
        res = eng.execute(plan)
        same_result(res, reng.execute(ref.optimize(rq)), f"tree{seed}.{i}")
        rec = eng.execute_recursive(plan)
        for v in res.rows:
            assert res.rows[v].tobytes() == rec.rows[v].tobytes()


class _Slow:
    """A source with a simulated latency: what ``SourceChannel`` reads of the
    reference's ``FlakySource`` (``name``, ``table``, ``latency_s``)."""

    def __init__(self, src, latency_s):
        self.name, self.table, self.latency_s = src.name, src.table, latency_s


@pytest.mark.parametrize("policy", POLICIES)
def test_virtual_clock_charges_each_physical_scan(both, policy):
    """Each physical scan advances the virtual clock by its endpoint's
    latency, memo hits are free, and the total and the per-channel scan
    counts equal the reference's under the same plan and policy."""
    (fed, _, _, queries, plans), (rfed, _, _, _, rplans) = both
    lat = {s.name: 0.01 * (i + 1) for i, s in enumerate(fed.sources)}
    slow = Federation([_Slow(s, lat[s.name]) for s in fed.sources],
                      fed.dictionary)
    rslow = RefFederation([FlakySource(s, latency_s=lat[s.name])
                           for s in rfed.sources], rfed.dictionary)
    for i, (q, plan, rplan) in enumerate(zip(queries[:10], plans, rplans)):
        clock, rclock = VirtualClock(), RefClock()
        ex = compile_plan(plan, slow, honor_faults=True, clock=clock,
                          policy=policy, rng=_rng(policy, i))
        rex = ref_compile(rplan, rslow, honor_faults=True, clock=rclock,
                          policy=policy, rng=_rng(policy, i))
        same_result(ex.run(), rex.run(), q.name)
        want = sum(ch.physical_scans * lat[ch.name]
                   for ch in ex.channels.values())
        assert clock.t == pytest.approx(want)
        assert clock.t == rclock.t, q.name
        assert {ch.name: (ch.physical_scans, ch.physical_tuples,
                          ch.cache_hits) for ch in ex.channels.values()} == \
            {ch.name: (ch.physical_scans, ch.physical_tuples, ch.cache_hits)
             for ch in rex.channels.values()}, q.name
        # a second run replays the shipped parts: no new physical scan
        t1 = clock.t
        same_result(ex.run(), rex.run(), q.name)
        assert clock.t == t1
