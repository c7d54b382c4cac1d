"""The port's batched planning (``repro_torch.core.batch_planner`` behind
``OdysseyOptimizer.optimize_batch``) against the reference package's, on the
CPU: both federations are built from the same seeds, the port plans on
``device="cpu"`` (the DP kernels' plain versions) and the reference on its
numpy backend.  Per query the plans are equal node for node (exact floats)
to the reference batch's and to the port's own ``optimize`` loop, the
``BatchPlanReport`` counts equal the reference's, and a batch planned with
``device="cpu"`` never reaches CUDA."""
import dataclasses

import pytest

pytest.importorskip("torch")

from test_torch_stats import assert_same  # noqa: E402

import repro.core.batch_planner as ref_bp  # noqa: E402
from benchmarks.planner_bench import object_variants, subject_variants  # noqa: E402
from repro.core.federation import build_federated_stats as ref_build  # noqa: E402
from repro.core.planner import OdysseyOptimizer as RefOptimizer  # noqa: E402
from repro.rdf.generator import fedbench_like_spec as ref_spec  # noqa: E402
from repro.rdf.generator import generate_federation as ref_gen  # noqa: E402
from repro.rdf.generator import generate_workload as ref_workload  # noqa: E402
import repro_torch.core.batch_planner as bp  # noqa: E402
from repro_torch.core import join_order as jo  # noqa: E402
from repro_torch.core.decomposition import decompose  # noqa: E402
from repro_torch.core.federation import build_federated_stats  # noqa: E402
from repro_torch.core.planner import OdysseyOptimizer  # noqa: E402
from repro_torch.engine.local import LocalEngine, naive_evaluate  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.query import algebra as A  # noqa: E402
from repro_torch.rdf.generator import (  # noqa: E402
    fedbench_like_spec,
    generate_federation,
    generate_workload,
)

PLAN_FIELDS = ("root", "graph", "selection", "fallback", "stats_epoch",
               "well_designed")
REPORT_COUNTS = ("n_queries", "cache_hits", "duplicates", "n_planned",
                 "n_shapes", "n_priced", "n_selections", "stats_epoch")


def to_port(x):
    """A reference query (or any of its algebra values) rebuilt from the
    port's classes of the same names, field by field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = getattr(A, type(x).__name__)
        return cls(**{f.name: to_port(getattr(x, f.name))
                      for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    return x


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


def mixed_batch(rfed, rworkload, size=64):
    """The reference tests' ``_mixed_batch`` (object- and subject-constant
    instances of the workload, exact duplicates), as reference queries."""
    base = list(rworkload)
    for q in rworkload:
        if len(q.patterns) >= 2:
            base.extend(object_variants(q, rfed, 6))
            base.extend(subject_variants(q, rfed, 4))
    base.extend(rworkload[:4])
    batch = list(base)
    while len(batch) < size:
        batch.append(base[len(batch) % len(base)])
    return batch[:size]


def same_plan(got, want, name):
    for f in PLAN_FIELDS:
        assert_same(getattr(got, f), getattr(want, f), f"{name}.{f}")
    assert got.cached == want.cached, name


def same_report(got, want, exact_dp=True):
    for f in REPORT_COUNTS + (("dp_resident", "dp_tiled") if exact_dp else ()):
        assert getattr(got, f) == getattr(want, f), f


def test_to_port_rebuilds_the_query(both):
    (_, _, _, wl), (_, _, _, rwl) = both
    for q, rq in zip(wl, rwl):
        pq = to_port(rq)
        assert type(pq) is A.BGPQuery
        assert pq == q


def test_optimize_batch_equals_reference_and_loop_mixed_shapes(both):
    (fed, _, stats, _), (rfed, _, rstats, rwl) = both
    rbatch = mixed_batch(rfed, rwl, size=64)
    batch = [to_port(q) for q in rbatch]
    shapes = {bp.shape_key(decompose(q), q.distinct) for q in batch}
    prices = {bp.pricing_key(decompose(q), q.distinct) for q in batch}
    assert len(shapes) >= 4 and len(prices) > len(shapes)

    ref = RefOptimizer(rstats)
    opt = OdysseyOptimizer(stats, device="cpu")
    loop = OdysseyOptimizer(stats, device="cpu")
    before = dict(jo.DP_SWEEP_COUNTERS)
    want = ref.optimize_batch(rbatch)
    got = opt.optimize_batch(batch)
    assert jo.DP_SWEEP_COUNTERS["resident"] > before["resident"]
    plans_l = [loop.optimize(q) for q in batch]
    for q, g, w, pl in zip(batch, got, want, plans_l):
        same_plan(g, w, q.name)
        same_plan(g, pl, q.name)
    # the plain DP ran resident on the CPU, where the reference's numpy
    # backend counts no device sweep: every other count is the reference's
    rep, rrep = opt.last_batch_report, ref.last_batch_report
    same_report(rep, rrep, exact_dp=False)
    assert rep.dp_resident + rep.dp_tiled >= 1 and rrep.dp_resident == 0
    assert rep.n_planned + rep.duplicates + rep.cache_hits == len(batch)
    assert rep.n_shapes < rep.n_planned and rep.n_priced < rep.n_planned
    assert opt.plan_cache.hits == loop.plan_cache.hits == ref.plan_cache.hits
    assert len(opt.plan_cache) == len(loop.plan_cache) == len(ref.plan_cache)

    # the port's numpy backend: the report equals the reference's, DP counts
    # included
    opt_np = OdysseyOptimizer(stats, dp_backend="numpy")
    for q, g, w in zip(batch, opt_np.optimize_batch(batch), want):
        same_plan(g, w, q.name)
    same_report(opt_np.last_batch_report, rrep)

    # executed results agree bytewise with the loop's and the oracle's
    eng = LocalEngine(fed)
    seen = set()
    for q, g, pl in zip(batch, got, plans_l):
        key = bp.shape_key(decompose(q), q.distinct)
        if key in seen:
            continue
        seen.add(key)
        rg, rl = eng.execute(g).rows, eng.execute(pl).rows
        for v in q.effective_projection():
            assert rg[v].tobytes() == rl[v].tobytes()
        proj = q.effective_projection()
        n = len(next(iter(rg.values()))) if rg else 0
        ans = set(zip(*[rg[v].tolist() for v in proj])) if n else set()
        assert ans == naive_evaluate(fed, q), q.name


def test_second_batch_is_all_cache_hits(both):
    (_, _, stats, wl), (_, _, rstats, rwl) = both
    opt, ref = OdysseyOptimizer(stats, device="cpu"), RefOptimizer(rstats)
    first, rfirst = opt.optimize_batch(wl), ref.optimize_batch(rwl)
    assert any(not p.cached for p in first)
    second, rsecond = opt.optimize_batch(wl), ref.optimize_batch(rwl)
    assert all(p.cached for p in second)
    assert opt.last_batch_report.n_planned == 0
    same_report(opt.last_batch_report, ref.last_batch_report)
    for q, a, b, ra, rb in zip(wl, first, second, rfirst, rsecond):
        same_plan(a, ra, q.name)
        same_plan(b, rb, q.name)
        for f in PLAN_FIELDS:
            assert_same(getattr(a, f), getattr(b, f), q.name)


def test_cache_off_duplicates_marked_cached(both):
    (_, _, stats, wl), (_, _, rstats, rwl) = both
    opt = OdysseyOptimizer(stats, plan_cache_size=0, device="cpu")
    ref = RefOptimizer(rstats, plan_cache_size=0)
    assert opt.plan_cache is None
    plans = opt.optimize_batch([wl[0]] * 3)
    want = ref.optimize_batch([rwl[0]] * 3)
    assert [p.cached for p in plans] == [False, True, True]
    assert all(p.optimization_ms >= 0.0 for p in plans)
    assert opt.last_batch_report.duplicates == 2
    same_report(opt.last_batch_report, ref.last_batch_report, exact_dp=False)
    for p, w in zip(plans, want):
        same_plan(p, w, wl[0].name)


@pytest.mark.parametrize("mutation", ["refresh", "remove"])
def test_epoch_snapshot_across_a_mid_batch_mutation(both, monkeypatch,
                                                    mutation):
    """A statistics mutation landing mid-batch (after the epoch snapshot: a
    ``refresh_source`` after the shared source selection, a
    ``remove_source`` just before it) does not split the batch across
    epochs, in either package, and both emit the same plans; afterwards a
    member replans under the new epoch, equal again."""
    (fed, _, stats, wl), (rfed, _, rstats, rwl) = both
    stats, rstats = stats.clone(), rstats.clone()
    opt, ref = OdysseyOptimizer(stats, device="cpu"), RefOptimizer(rstats)
    epoch0 = stats.epoch
    assert rstats.epoch == epoch0

    def mutating(mod, st, fd):
        real = mod.select_sources_batch
        fired = {"n": 0}

        def select_then_mutate(graphs, s, memo=None):
            if fired["n"] == 0 and mutation == "remove":
                fired["n"] = 1
                st.remove_source(0)
            out = real(graphs, s, memo=memo)
            if fired["n"] == 0:
                fired["n"] = 1
                st.refresh_source(0, fd.sources[0].table)
            return out
        return real, fired, select_then_mutate

    real, fired, fn = mutating(bp, stats, fed)
    rreal, rfired, rfn = mutating(ref_bp, rstats, rfed)
    monkeypatch.setattr(bp, "select_sources_batch", fn)
    monkeypatch.setattr(ref_bp, "select_sources_batch", rfn)
    batch = [q for q in wl if len(q.patterns) >= 2]
    rbatch = [q for q in rwl if len(q.patterns) >= 2]
    plans, want = opt.optimize_batch(batch), ref.optimize_batch(rbatch)
    assert fired["n"] == rfired["n"] == 1
    assert stats.epoch == rstats.epoch == epoch0 + 1
    assert {p.stats_epoch for p in plans} == {epoch0}
    for q, p, w in zip(batch, plans, want):
        same_plan(p, w, q.name)
    monkeypatch.setattr(bp, "select_sources_batch", real)
    monkeypatch.setattr(ref_bp, "select_sources_batch", rreal)
    replan, rreplan = opt.optimize(batch[0]), ref.optimize(rbatch[0])
    assert not replan.cached and replan.stats_epoch == epoch0 + 1
    same_plan(replan, rreplan, batch[0].name)


def test_remove_source_between_selection_and_sweep_raises_in_both(
        both, monkeypatch):
    """The epoch snapshot is not a statistics snapshot: a ``remove_source``
    landing between the shared selection and the DP sweep renumbers the
    sources the selection holds, and the reference's batch raises
    ``IndexError``.  The port copies that behaviour."""
    (_, _, stats, wl), (_, _, rstats, rwl) = both
    for mod, st, opt, batch in (
            (bp, stats.clone(), OdysseyOptimizer, wl),
            (ref_bp, rstats.clone(), RefOptimizer, rwl)):
        real = mod.select_sources_batch

        def select_then_remove(graphs, s, memo=None, real=real, st=st):
            out = real(graphs, s, memo=memo)
            st.remove_source(0)
            return out

        monkeypatch.setattr(mod, "select_sources_batch", select_then_remove)
        kw = {"device": "cpu"} if mod is bp else {}
        with pytest.raises(IndexError):
            opt(st, **kw).optimize_batch([q for q in batch
                                          if len(q.patterns) >= 2])


def test_plan_affinity_equals_reference(both):
    (fed, _, _, _), (rfed, _, _, rwl) = both
    for rq in mixed_batch(rfed, rwl, size=40):
        got, want = bp.plan_affinity(to_port(rq)), ref_bp.plan_affinity(rq)
        assert type(got).__name__ == "AffinityKey"
        assert list(got.tier_keys()) == list(want.tier_keys()), rq.name
    assert bp.AFFINITY_TIERS == ref_bp.AFFINITY_TIERS
    assert [f.name for f in dataclasses.fields(bp.BatchPlanReport)] == \
        [f.name for f in dataclasses.fields(ref_bp.BatchPlanReport)]


def _no_cuda(monkeypatch):
    """Make every way onto the card raise: the kernel launcher and loader,
    and tensors moved to a CUDA device."""
    import torch

    def refuse(*a, **k):
        raise AssertionError("a CPU batch reached a CUDA entry point")

    monkeypatch.setattr(build, "launch", refuse)
    monkeypatch.setattr(build, "_lib", refuse)
    monkeypatch.setattr(build, "build_kernels", refuse)
    real_to = torch.Tensor.to

    def to(self, *args, **kw):
        dev = kw.get("device", args[0] if args else None)
        if dev is not None and not isinstance(dev, torch.dtype) \
                and torch.device(dev).type == "cuda":
            refuse()
        return real_to(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "to", to)
    return refuse


def test_cpu_batch_never_reaches_cuda(both, monkeypatch):
    """``device="cpu"`` reaches every stacked sweep of the batch: with the
    CUDA entry points patched to raise, the batch plans (resident sweeps on
    the plain version) and equals the numpy backend's; the same batch on an
    optimizer left on the default device tries the card."""
    (_, _, stats, wl), (rfed, _, _, rwl) = both
    batch = [to_port(q) for q in mixed_batch(rfed, rwl, size=32)]
    want = OdysseyOptimizer(stats, dp_backend="numpy").optimize_batch(batch)
    _no_cuda(monkeypatch)
    l0 = dict(build.LAUNCHES)
    opt = OdysseyOptimizer(stats, device="cpu")
    got = opt.optimize_batch(batch)
    assert opt.last_batch_report.dp_resident >= 1
    assert build.LAUNCHES == l0
    for q, g, w in zip(batch, got, want):
        same_plan(g, w, q.name)
    with pytest.raises(AssertionError, match="CUDA entry point"):
        OdysseyOptimizer(stats).optimize_batch(batch)


def test_plan_batch_passes_the_optimizer_device(both, monkeypatch):
    (_, _, stats, wl), _ = both
    seen = []

    class Stop(Exception):
        pass

    def capture(*args, **kw):
        seen.append((kw["dp_backend"], kw["device"]))
        raise Stop

    monkeypatch.setattr(bp, "dp_join_order_batch", capture)
    multi = [q for q in wl if len(q.patterns) >= 2][:1]
    for kw, want in (({}, ("torch", "cuda")),
                     ({"device": "cpu"}, ("torch", "cpu")),
                     ({"dp_backend": "numpy"}, ("numpy", "cuda"))):
        with pytest.raises(Stop):
            OdysseyOptimizer(stats, **kw).optimize_batch(multi)
        assert seen[-1] == want


def test_dp_join_order_batch_matches_single_on_cpu(both):
    """Shape-group sweeps on the plain kernels equal planning each member
    alone on the numpy backend (cost, cardinality, leaf order,
    strategies)."""
    from repro_torch.core.source_selection import (select_sources,
                                                   select_sources_batch)

    def strategies(t, out):
        out.append((t.kind, t.strategy, tuple(sorted(t.stars)), t.cost,
                    t.cardinality))
        if t.left is not None:
            strategies(t.left, out)
            strategies(t.right, out)
        return out

    (_, _, stats, wl), _ = both
    groups = {}
    for q in wl:
        g = decompose(q)
        groups.setdefault((jo.star_graph_topology(g), q.distinct),
                          []).append((q, g))
    checked = 0
    for (_, distinct), members in groups.items():
        graphs = [g for _, g in members]
        sels = select_sources_batch(graphs, stats)
        trees = jo.dp_join_order_batch(graphs, stats, sels, distinct=distinct,
                                       device="cpu")
        for (q, g), tree in zip(members, trees):
            single = jo.dp_join_order(g, stats, select_sources(g, stats),
                                      distinct=distinct, dp_backend="numpy")
            assert strategies(single, []) == strategies(tree, []), q.name
            assert tree.leaf_order() == single.leaf_order(), q.name
            checked += 1
    assert checked == len(wl)
