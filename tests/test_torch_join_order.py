"""Plans of the port's join-order DP (torch backend on the CPU, i.e. the
kernels' plain versions, and the port's numpy backend) against the reference
package's numpy backend and its frozenset oracle ``dp_join_order_ref``:
identical trees (kind, stars, cardinality, cost, sources, strategy)."""
import pytest

pytest.importorskip("torch")

from repro.core import join_order as ref_jo            # noqa: E402
from repro.core.cost import CostModel as RefCostModel  # noqa: E402
from repro.core.source_selection import SourceSelection as RefSelection  # noqa: E402
from repro.rdf.shapes import shaped_planning_inputs as ref_shaped  # noqa: E402
from repro_torch.core import join_order as jo          # noqa: E402
from repro_torch.core.cost import CostModel            # noqa: E402
from repro_torch.core.source_selection import SourceSelection  # noqa: E402
from repro_torch.rdf.shapes import shaped_planning_inputs  # noqa: E402


def assert_same_tree(a, b, path="root"):
    assert (a.kind, a.stars, a.cardinality, a.cost, a.sources,
            a.strategy) == (b.kind, b.stars, b.cardinality, b.cost,
                            b.sources, b.strategy), path
    if a.kind == "join":
        assert_same_tree(a.left, b.left, path + "L")
        assert_same_tree(a.right, b.right, path + "R")


def _vary(sel_cls, sel, b):
    """Member-specific selections: the reference tests' ``_vary_sources``
    trims, plus stars pruned to zero sources (the shaped federations have a
    single source, which those trims never touch)."""
    ss = []
    for i, srcs in enumerate(sel.star_sources):
        keep = list(srcs)
        if len(srcs) > 1 and (i + b) % 3 == 0:
            keep = list(srcs[:1] if b % 2 else srcs[1:])
        elif b and (3 * i + b) % 5 == 0:
            keep = []
        ss.append(keep)
    return sel_cls(star_sources=ss, star_cs=sel.star_cs,
                   edge_pairs=sel.edge_pairs)


@pytest.mark.parametrize("shape", ["chain", "tree", "clique"])
@pytest.mark.parametrize("n", [2, 4, 7, 10])
def test_plans_equal_reference(shape, n):
    g, stats, sel, q = shaped_planning_inputs(shape, n, seed=n)
    rg, rstats, rsel, rq = ref_shaped(shape, n, seed=n)
    want = ref_jo.dp_join_order(rg, rstats, rsel, RefCostModel(), rq.distinct,
                                dp_backend="numpy")
    assert_same_tree(ref_jo.dp_join_order_ref(rg, rstats, rsel, RefCostModel(),
                                              rq.distinct), want)
    before = dict(jo.DP_SWEEP_COUNTERS)
    got = jo.dp_join_order(g, stats, sel, CostModel(), q.distinct,
                           device="cpu")
    assert_same_tree(got, want)
    assert jo.DP_SWEEP_COUNTERS["resident"] == before["resident"] + 1
    assert_same_tree(jo.dp_join_order(g, stats, sel, CostModel(), q.distinct,
                                      dp_backend="numpy"), want)


@pytest.mark.parametrize("shape", ["chain", "tree", "clique"])
def test_weighted_cost_model_plans_equal_reference(shape):
    """Per-source weights exercise the exclusive-group weight lookup."""
    weights = {0: 1.5, 1: 0.8, 2: 2.0}
    for n, seed in ((3, 1), (5, 2), (7, 1)):
        g, stats, sel, q = shaped_planning_inputs(shape, n, seed=seed)
        rg, rstats, rsel, rq = ref_shaped(shape, n, seed=seed)
        want = ref_jo.dp_join_order_ref(
            rg, rstats, rsel, RefCostModel(source_weight=weights), rq.distinct)
        got = jo.dp_join_order(g, stats, sel, CostModel(source_weight=weights),
                               q.distinct, device="cpu")
        assert_same_tree(got, want)


@pytest.mark.parametrize("shape,n", [("tree", 8), ("clique", 7)])
def test_member_batch_plans_equal_reference(shape, n):
    B = 4
    g, stats, sel, q = shaped_planning_inputs(shape, n, seed=3)
    rg, rstats, rsel, rq = ref_shaped(shape, n, seed=3)
    sels = [_vary(SourceSelection, sel, b) for b in range(B)]
    rsels = [_vary(RefSelection, rsel, b) for b in range(B)]
    before = dict(jo.DP_SWEEP_COUNTERS)
    got = jo.dp_join_order_batch([g] * B, stats, sels, CostModel(),
                                 q.distinct, device="cpu")
    assert jo.DP_SWEEP_COUNTERS["resident"] == before["resident"] + 1
    assert len({t.cost for t in got}) > 1          # members really differ
    for b in range(B):
        want = ref_jo.dp_join_order(rg, rstats, rsels[b], RefCostModel(),
                                    rq.distinct, dp_backend="numpy")
        assert_same_tree(got[b], want, f"member{b}")
        assert_same_tree(ref_jo.dp_join_order_ref(
            rg, rstats, rsels[b], RefCostModel(), rq.distinct), want)


@pytest.mark.parametrize("shape,n,B", [("chain", 9, 1), ("clique", 7, 2),
                                       ("tree", 8, 3)])
def test_tiled_path_plans_equal_reference(shape, n, B):
    """A block budget too small for the resident schedule sends the torch
    backend down the tiled path (dense layer tiles through ``dp_layer``)."""
    g, stats, sel, q = shaped_planning_inputs(shape, n, seed=11)
    rg, rstats, rsel, rq = ref_shaped(shape, n, seed=11)
    sels = [_vary(SourceSelection, sel, b) for b in range(B)]
    rsels = [_vary(RefSelection, rsel, b) for b in range(B)]
    before = dict(jo.DP_SWEEP_COUNTERS)
    got = jo.dp_join_order_batch([g] * B, stats, sels, CostModel(),
                                 q.distinct, block_bytes=4096, device="cpu")
    assert jo.DP_SWEEP_COUNTERS["tiled"] > before["tiled"]
    assert jo.DP_SWEEP_COUNTERS["resident"] == before["resident"]
    want = ref_jo.dp_join_order_batch([rg] * B, rstats, rsels, RefCostModel(),
                                      rq.distinct, block_bytes=4096,
                                      dp_backend="numpy")
    for b in range(B):
        assert_same_tree(got[b], want[b], f"member{b}")
        assert_same_tree(ref_jo.dp_join_order_ref(
            rg, rstats, rsels[b], RefCostModel(), rq.distinct), want[b])


def test_budget_decisions_match_reference():
    """Resident-vs-tiled is decided by the same budget arithmetic."""
    for shape, n, B, budget in (("clique", 10, 8, jo.DP_BLOCK_BYTES),
                                ("clique", 9, 4, 1 << 20),
                                ("chain", 12, 2, 1 << 16),
                                ("tree", 11, 6, 1 << 18)):
        g, _, _, _ = shaped_planning_inputs(shape, n, seed=5)
        rg, _, _, _ = ref_shaped(shape, n, seed=5)
        got = jo._resident_fits(jo._dp_schedule(g, budget, B), B, budget)
        want = ref_jo._resident_fits(ref_jo._dp_schedule(rg, budget, B), B,
                                     budget)
        assert got == want, (shape, n, B, budget)


def test_unknown_backend_rejected():
    g, stats, sel, q = shaped_planning_inputs("chain", 3, seed=1)
    with pytest.raises(ValueError):
        jo.dp_join_order(g, stats, sel, dp_backend="jax", device="cpu")


@pytest.fixture(scope="module")
def fed_stars():
    """Stars of the FedBench-like workload with their statistics and source
    selections, in both packages (same seeds)."""
    from repro.core.decomposition import decompose as ref_decompose
    from repro.core.federation import build_federated_stats as ref_build
    from repro.core.source_selection import select_sources as ref_select
    from repro.rdf.generator import fedbench_like_spec as ref_spec
    from repro.rdf.generator import generate_federation as ref_gen
    from repro.rdf.generator import generate_workload as ref_workload
    from repro_torch.core.decomposition import decompose
    from repro_torch.core.federation import build_federated_stats
    from repro_torch.core.source_selection import select_sources
    from repro_torch.rdf.generator import (fedbench_like_spec,
                                           generate_federation,
                                           generate_workload)

    out = []
    for spec, gen, build, wl, dec, select in (
            (fedbench_like_spec, generate_federation, build_federated_stats,
             generate_workload, decompose, select_sources),
            (ref_spec, ref_gen, ref_build, ref_workload, ref_decompose,
             ref_select)):
        fed, gt = gen(spec(scale=0.06, seed=3))
        stats = build(fed)
        items = []
        for q in wl(fed, gt, seed=5):
            g = dec(q)
            items.append((g, select(g, stats), q.distinct))
        out.append((stats, items))
    return out


def test_order_star_patterns_matches_reference(fed_stars):
    """Dropping by position orders every star of the workload (no repeated
    pattern there) exactly as the reference's drop by value."""
    (stats, items), (rstats, ritems) = fed_stars
    seen = 0
    for (g, sel, distinct), (rg, rsel, _) in zip(items, ritems):
        for star, rstar in zip(g.stars, rg.stars):
            got = jo.order_star_patterns(star, stats, sel, distinct)
            want = ref_jo.order_star_patterns(rstar, rstats, rsel, distinct)
            assert [repr(tp) for tp in got] == [repr(tp) for tp in want]
            seen += len(star.bound_preds()) >= 3
    assert seen > 0                     # the greedy drop loop really ran


def test_order_star_patterns_duplicate_pattern(fed_stars):
    """A star that holds the same bound pattern twice orders without
    IndexError and keeps both copies."""
    from repro_torch.core.decomposition import Star
    from repro_torch.query.algebra import Const

    (stats, items), _ = fed_stars
    g, sel, distinct = next(
        it for it in items if any(len(s.bound_preds()) >= 3
                                  for s in it[0].stars))
    star = next(s for s in g.stars if len(s.bound_preds()) >= 3)
    twice = next(tp for tp in star.patterns if isinstance(tp.p, Const))
    dup = Star(star.idx, star.subject, list(star.patterns) + [twice])
    got = jo.order_star_patterns(dup, stats, sel, distinct)
    assert sorted(map(repr, got)) == sorted(map(repr, dup.patterns))
    assert sum(tp == twice for tp in got) == 2
