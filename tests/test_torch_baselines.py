"""The port's comparison baselines (``repro_torch.baselines``: FedX cold and
warm, HiBISCuS, DP-VOID, SPLENDID and the two hybrids) and VoID statistics
(``repro_torch.stats.void``) against the reference package's, on the CPU.
Both federations are built from the same seeds; per query the plans are
equal node for node (exact floats), with equal ``n_selected_sources`` and
``n_subqueries``; the executed rows are byte-equal with equal NTT and
requests, and the ASK-probe counts are equal, as the reference's own
``tests/test_baselines_ask.py`` counts them.  Odyssey and FedX-Odyssey plan
on the card by default, so here they plan with ``device="cpu"`` (the DP
kernels' plain versions) or the numpy backend."""
import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_batch_planner import PLAN_FIELDS, to_port  # noqa: E402
from test_torch_pipeline import same_result  # noqa: E402
from test_torch_stats import assert_same  # noqa: E402

import repro.baselines as RB  # noqa: E402
import repro.baselines.hybrids as RH  # noqa: E402
from repro.core.federation import build_federated_stats as ref_build  # noqa: E402
from repro.core.planner import OdysseyOptimizer as RefOptimizer  # noqa: E402
from repro.engine.local import LocalEngine as RefEngine  # noqa: E402
from repro.query.algebra import BGPQuery as RefBGP  # noqa: E402
from repro.query.algebra import TriplePattern as RefTP  # noqa: E402
from repro.query.algebra import Var as RefVar  # noqa: E402
from repro.rdf.generator import fedbench_like_spec as ref_spec  # noqa: E402
from repro.rdf.generator import generate_federation as ref_gen  # noqa: E402
from repro.rdf.generator import generate_workload as ref_workload  # noqa: E402
from repro.stats.void import compute_void as ref_void  # noqa: E402
import repro_torch.baselines as B  # noqa: E402
import repro_torch.baselines.hybrids as H  # noqa: E402
from repro_torch.core import join_order as jo  # noqa: E402
from repro_torch.core.federation import build_federated_stats  # noqa: E402
from repro_torch.core.planner import OdysseyOptimizer  # noqa: E402
from repro_torch.engine.local import LocalEngine, naive_evaluate  # noqa: E402
from repro_torch.rdf.generator import (  # noqa: E402
    fedbench_like_spec,
    generate_federation,
    generate_workload,
)
from repro_torch.stats import VoidStats, compute_void  # noqa: E402

ENGINES = ("Odyssey", "FedX-Cold", "FedX-Warm", "HiBISCuS", "DP-VOID",
           "SPLENDID", "Odyssey-FedX", "FedX-Odyssey[numpy]",
           "FedX-Odyssey[torch]")


def make_port(name, fed, stats):
    """The port's engine ``name`` as ``benchmarks/common.py``'s
    ``make_optimizers`` builds it, planning on the CPU."""
    return {
        "Odyssey": lambda: OdysseyOptimizer(stats, plan_cache_size=0,
                                            device="cpu"),
        "FedX-Cold": lambda: B.FedXOptimizer(fed, warm=False),
        "FedX-Warm": lambda: B.FedXOptimizer(fed, warm=True),
        "HiBISCuS": lambda: B.HibiscusOptimizer(fed),
        "DP-VOID": lambda: B.VoidDPOptimizer(fed),
        "SPLENDID": lambda: B.VoidDPOptimizer(fed, use_ask=True),
        "Odyssey-FedX": lambda: H.OdysseyFedX(stats),
        "FedX-Odyssey[numpy]": lambda: H.FedXOdyssey(stats, fed,
                                                     dp_backend="numpy"),
        "FedX-Odyssey[torch]": lambda: H.FedXOdyssey(stats, fed,
                                                     device="cpu"),
    }[name]()


def make_ref(name, fed, stats):
    return {
        "Odyssey": lambda: RefOptimizer(stats, plan_cache_size=0),
        "FedX-Cold": lambda: RB.FedXOptimizer(fed, warm=False),
        "FedX-Warm": lambda: RB.FedXOptimizer(fed, warm=True),
        "HiBISCuS": lambda: RB.HibiscusOptimizer(fed),
        "DP-VOID": lambda: RB.VoidDPOptimizer(fed),
        "SPLENDID": lambda: RB.VoidDPOptimizer(fed, use_ask=True),
        "Odyssey-FedX": lambda: RH.OdysseyFedX(stats),
        "FedX-Odyssey[numpy]": lambda: RH.FedXOdyssey(stats, fed),
        "FedX-Odyssey[torch]": lambda: RH.FedXOdyssey(stats, fed),
    }[name]()


@pytest.fixture(scope="module")
def both():
    """``(port, reference)``, each ``(fed, gt, stats, queries)`` from the
    same seeds: the reference tests' ``tiny_*`` workload plus cross-source
    hybrids and paths."""
    out = []
    for spec, gen, bld, wl in (
            (fedbench_like_spec, generate_federation, build_federated_stats,
             generate_workload),
            (ref_spec, ref_gen, ref_build, ref_workload)):
        fed, gt = gen(spec(scale=0.06, seed=3))
        queries = (wl(fed, gt, n_star=4, n_hybrid=4, n_path=2, seed=9)
                   + wl(fed, gt, n_star=0, n_hybrid=4, n_path=4, seed=33))
        out.append((fed, gt, bld(fed), queries))
    return out


def same_plan(got, want, name):
    for f in PLAN_FIELDS:
        assert_same(getattr(got, f), getattr(want, f), f"{name}.{f}")
    assert got.n_selected_sources == want.n_selected_sources, name
    assert got.n_subqueries == want.n_subqueries, name


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_plans_and_executes_as_the_reference(both, engine):
    """Every engine: plans equal the reference's node for node, rows
    byte-equal with equal NTT and requests, answers equal the oracle, and
    the ASK count equals the reference's after the workload."""
    (fed, _, stats, queries), (rfed, _, rstats, rqueries) = both
    opt, ref = make_port(engine, fed, stats), make_ref(engine, rfed, rstats)
    eng, reng = LocalEngine(fed), RefEngine(rfed)
    before = dict(jo.DP_SWEEP_COUNTERS)
    for q, rq in zip(queries, rqueries):
        assert to_port(rq) == q
        plan, rplan = opt.optimize(q), ref.optimize(rq)
        same_plan(plan, rplan, f"{engine}:{q.name}")
        res = eng.execute(plan)
        same_result(res, reng.execute(rplan), f"{engine}:{q.name}")
        proj = q.effective_projection()
        n = len(next(iter(res.rows.values()))) if res.rows else 0
        got = set(zip(*[res.rows[v].tolist() for v in proj])) if n else set()
        assert got == naive_evaluate(fed, q), f"{engine}:{q.name}"
    assert getattr(opt, "ask_count", None) == getattr(ref, "ask_count", None)
    swept = sum(jo.DP_SWEEP_COUNTERS[k] - before[k]
                for k in ("resident", "tiled"))
    # only the two DP engines on the torch backend reach the device sweep
    assert (swept > 0) == (engine in ("Odyssey", "FedX-Odyssey[torch]"))


def _query_with_duplicate_signature(queries, TP, V, BGP):
    """``tests/test_baselines_ask.py``'s query: a workload query plus a
    pattern sharing an ASK signature with one of its own."""
    q = next(q for q in queries
             if any(isinstance(tp.s, V) and isinstance(tp.o, V)
                    for tp in q.patterns))
    tp = next(tp for tp in q.patterns
              if isinstance(tp.s, V) and isinstance(tp.o, V))
    dup = TP(V("dup_s"), tp.p, V("dup_o"))
    assert dup.constants() == tp.constants()
    return BGP(q.patterns + [dup], distinct=q.distinct, name="dupq")


@pytest.mark.parametrize("engine,warm", [("FedX", False), ("FedX", True),
                                         ("HiBISCuS", False),
                                         ("HiBISCuS", True)])
def test_ask_counts_equal_reference(both, engine, warm):
    """Cold mode probes each signature once per selection, warm mode never
    re-probes (``tests/test_baselines_ask.py``): the port's counts after one
    and after two ``optimize`` calls equal the reference's and the closed
    form, and the plans stay equal."""
    from repro_torch.query.algebra import BGPQuery, TriplePattern, Var

    (fed, _, _, queries), (rfed, _, _, rqueries) = both
    cls = {"FedX": (B.FedXOptimizer, RB.FedXOptimizer),
           "HiBISCuS": (B.HibiscusOptimizer, RB.HibiscusOptimizer)}[engine]
    opt, ref = cls[0](fed, warm=warm), cls[1](rfed, warm=warm)
    q = _query_with_duplicate_signature(queries, TriplePattern, Var, BGPQuery)
    rq = _query_with_duplicate_signature(rqueries, RefTP, RefVar, RefBGP)
    per_call = len({tp.constants() for tp in q.patterns}) * len(fed.sources)
    assert per_call < len(q.patterns) * len(fed.sources)
    counts = []
    for _ in range(2):
        same_plan(opt.optimize(q), ref.optimize(rq), f"{engine}:dupq")
        assert opt.ask_count == ref.ask_count
        counts.append(opt.ask_count)
    assert counts == [per_call, per_call if warm else 2 * per_call]


def test_warm_cache_isolated_from_caller_mutation(both):
    (fed, _, _, queries), _ = both
    opt = B.FedXOptimizer(fed, warm=True)
    tp = queries[0].patterns[0]
    first = opt._sources_for(tp)
    first.append(10_000)
    assert 10_000 not in opt._sources_for(tp)
    assert opt.ask_count == len(fed.sources)


def test_hibiscus_authority_sets_equal_reference(both):
    (fed, _, _, _), (rfed, _, _, _) = both
    opt, ref = B.HibiscusOptimizer(fed), RB.HibiscusOptimizer(rfed)
    assert opt.subj_auth == ref.subj_auth
    assert opt.obj_auth == ref.obj_auth


def test_void_stats_equal_reference(both):
    """``compute_void`` per source: every array equal in dtype and value,
    ``estimate_pattern`` exact on every bound/unbound combination over the
    source's predicates, a missing predicate and no predicate."""
    (fed, _, _, _), (rfed, _, _, _) = both
    rng = np.random.default_rng(0)
    for src, rsrc in zip(fed.sources, rfed.sources):
        v, rv = compute_void(src.table), ref_void(rsrc.table)
        assert isinstance(v, VoidStats)
        assert_same(v, rv, src.name)
        assert v.nbytes() == rv.nbytes()
        s0, o0 = int(src.table.s[0]), int(src.table.o[0])
        preds = [int(p) for p in v.preds] + [None, int(v.preds.max()) + 1]
        for p in preds:
            for s in (None, s0):
                for o in (None, o0):
                    got, want = v.estimate_pattern(s, p, o), \
                        rv.estimate_pattern(s, p, o)
                    assert type(got) is type(want) and got == want
            if p is not None:
                assert v.pred_stat(p) == rv.pred_stat(p)
                assert v.has_pred(p) == rv.has_pred(p)
                assert v.triples_with_pred(p) == rv.triples_with_pred(p)
        p = int(rng.choice(v.preds))
        assert v.triples_with_pred(p) == int((src.table.p == p).sum())
