"""The port's SPMD federation executor (``repro_torch.engine.distributed``)
on ``device="cpu"`` against the reference's ``DistributedEngine``.

The reference needs one XLA device per shard, so it runs in one subprocess
with 18 fake CPU devices (``XLA_FLAGS``), this module serving as its
script: every case below is executed there once and written to an ``.npz``.
Each reference mesh takes the first ``d * m`` devices.  Per case and query
the port must give the reference's rows in the same order and dtype, equal
``DistMetrics`` (overflow included, where a small ``cap`` overflows), the
same skipped plans, and the same plan (its repr).  The port's mesh keeps
every shard on one device, so its collectives are held to hand-built
per-shard expectations too."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
N_FAKE = 18

# (federation, (d, m), cap, partition_aware); "selftest" is dist_selftest's
# federation (its first d sources), "tiny" the fast tier's fedbench fixture
CASES = [(fed, mesh, 4096, aware)
         for fed, mesh in (("selftest", (2, 2)), ("selftest", (4, 2)),
                           ("selftest", (4, 1)), ("tiny", (9, 2)))
         for aware in (False, True)]
# capacities small enough that some plans overflow and some do not
OVERFLOW_CASES = [("selftest", (4, 2), 64, True), ("tiny", (9, 2), 32, False)]


def case_id(case) -> str:
    fed, (d, m), cap, aware = case
    return f"{fed}-{d}x{m}-cap{cap}-{'aware' if aware else 'gather'}"


def federation(G, which: str, d: int):
    """``(fed, queries)`` built with the generator module ``G`` (the
    reference's or the port's) from the same seeds."""
    if which == "tiny":
        fed, gt = G.generate_federation(G.fedbench_like_spec(scale=0.06, seed=3))
        return fed, G.generate_workload(fed, gt, n_star=4, n_hybrid=4, n_path=2,
                                        seed=9)
    spec = G.FederationSpec(sources=[
        G.SourceSpec("A", n_entities=160, n_templates=6, n_local_preds=10),
        G.SourceSpec("B", n_entities=120, n_templates=5, n_local_preds=8,
                     links=[G.LinkSpec("owl:sameAs", "A", 0.5)]),
        G.SourceSpec("C", n_entities=100, n_templates=4, n_local_preds=8,
                     links=[G.LinkSpec("c:ref", "B", 0.4),
                            G.LinkSpec("c:self", "C", 0.3)]),
        G.SourceSpec("D", n_entities=80, n_templates=4, n_local_preds=8,
                     links=[G.LinkSpec("owl:sameAs", "A", 0.4)]),
    ][:d], seed=21)
    fed, gt = G.generate_federation(spec)
    return fed, G.generate_workload(fed, gt, n_star=6, n_hybrid=4, n_path=2, seed=9)


def run_case(queries, opt, engine, unsupported) -> "tuple[dict, dict]":
    """Per query: its plan's repr and either the skip reason or the
    metrics; and the rows, keyed ``query/var``."""
    meta, rows = {}, {}
    for q in queries:
        plan = opt.optimize(q)
        entry = meta[q.name] = {"plan": repr(plan.root)}
        if plan.fallback:
            entry["skip"] = "fallback"
            continue
        try:
            res = engine.execute(plan)
        except unsupported:
            entry["skip"] = "unsupported"
            continue
        m = res.metrics
        entry["metrics"] = [m.transferred_tuples, m.collective_bytes, m.overflowed]
        entry["vars"] = list(res.rows)
        for v, col in res.rows.items():
            rows[f"{q.name}/{v}"] = col
    return meta, rows


def reference_main(out: str) -> None:
    """The subprocess: every case through the reference's engine."""
    from repro.core.federation import build_federated_stats
    from repro.core.planner import OdysseyOptimizer
    from repro.engine.distributed import DistributedEngine
    from repro.launch.mesh import make_test_mesh
    from repro.rdf import generator as G

    feds: dict = {}
    arrays, meta = {}, {}
    for case in CASES + OVERFLOW_CASES:
        which, (d, m), cap, aware = case
        if (which, d) not in feds:
            fed, queries = federation(G, which, d)
            feds[which, d] = fed, queries, OdysseyOptimizer(build_federated_stats(fed))
        fed, queries, opt = feds[which, d]
        eng = DistributedEngine(fed, make_test_mesh((d, m)), cap=cap,
                                partition_aware=aware)
        key = case_id(case)
        meta[key], rows = run_case(queries, opt, eng, AssertionError)
        meta[key]["__table_cap"] = eng.table_cap
        arrays.update({f"{key}|{k}": v for k, v in rows.items()})
        arrays[f"{key}|__tables"] = np.asarray(eng.tables)
        arrays[f"{key}|__trow"] = np.asarray(eng.trow)
    np.savez(out, __meta=np.array(json.dumps(meta)), **arrays)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("spmd_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_FAKE}",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        return json.loads(str(z["__meta"])), {k: z[k] for k in z.files if k != "__meta"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: PyTorch's thread pool costs more than it gives when
    the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_feds():
    from repro_torch.core.federation import build_federated_stats
    from repro_torch.core.planner import OdysseyOptimizer
    from repro_torch.rdf import generator as G

    cache: dict = {}

    def get(which, d):
        if (which, d) not in cache:
            fed, queries = federation(G, which, d)
            cache[which, d] = fed, queries, OdysseyOptimizer(
                build_federated_stats(fed), dp_backend="numpy", device="cpu")
        return cache[which, d]
    return get


def _run_port(port_feds, case):
    from repro_torch.engine.distributed import DistributedEngine, UnsupportedShapeError
    from repro_torch.launch.mesh import make_test_mesh

    which, (d, m), cap, aware = case
    fed, queries, opt = port_feds(which, d)
    eng = DistributedEngine(fed, make_test_mesh((d, m), device="cpu"), cap=cap,
                            partition_aware=aware)
    return eng, run_case(queries, opt, eng, UnsupportedShapeError)


def _same_as_reference(reference, key, eng, meta, rows) -> None:
    ref_meta, ref_arrays = reference
    want = dict(ref_meta[key])
    assert want.pop("__table_cap") == eng.table_cap
    np.testing.assert_array_equal(eng.tables.numpy(), ref_arrays[f"{key}|__tables"])
    np.testing.assert_array_equal(eng.trow.numpy(), ref_arrays[f"{key}|__trow"])
    assert eng.tables.dtype == torch.int32
    assert meta == want
    prefix = f"{key}|"
    want_rows = {k[len(prefix):]: v for k, v in ref_arrays.items()
                 if k.startswith(prefix) and "|__" not in k}
    assert rows.keys() == want_rows.keys()
    for k, col in rows.items():
        assert col.dtype == want_rows[k].dtype, k
        np.testing.assert_array_equal(col, want_rows[k], err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_engine_equals_reference(reference, port_feds, case):
    eng, (meta, rows) = _run_port(port_feds, case)
    _same_as_reference(reference, case_id(case), eng, meta, rows)
    ran = [e for e in meta.values() if "metrics" in e]
    assert ran and not any(e["metrics"][2] for e in ran)
    if case[0] == "selftest":
        assert len(ran) == 12
    assert any(e["metrics"][0] > 0 for e in ran)          # rows crossed the mesh


@pytest.mark.parametrize("case", OVERFLOW_CASES, ids=case_id)
def test_small_cap_overflows_where_the_reference_does(reference, port_feds, case):
    eng, (meta, rows) = _run_port(port_feds, case)
    _same_as_reference(reference, case_id(case), eng, meta, rows)
    flags = [e["metrics"][2] for e in meta.values() if "metrics" in e]
    assert any(flags) and not all(flags)


def plan_reads_and_columns(node) -> "tuple[int, int]":
    """(stars + joins, columns) of a conjunctive plan subtree: one read per
    star and per join, one column per star's subject and per pattern with a
    bound predicate."""
    from repro_torch.core.decomposition import decompose
    from repro_torch.core.planner import JoinPlanNode, SubqueryNode
    from repro_torch.query.algebra import BGPQuery, Var

    if isinstance(node, SubqueryNode):
        stars = decompose(BGPQuery(list(node.patterns))).stars if len(node.stars) > 1 \
            else [node]
        cols = sum(1 + sum(not isinstance(tp.p, Var) for tp in s.patterns) for s in stars)
        return 2 * len(stars) - 1, cols
    assert isinstance(node, JoinPlanNode)
    (lr, lc), (rr, rc) = (plan_reads_and_columns(node.left),
                          plan_reads_and_columns(node.right))
    return lr + rr + 1, lc + rc


def host_path_rows(data, valid, columns, extra_eq, query) -> dict:
    """The read-back as the engine took it before selecting on the device:
    both collected tensors copied whole, ``data[valid]`` in numpy, the
    secondary join keys filtered over the surviving rows, then projection
    and DISTINCT."""
    ncols = len(columns)
    rows = data.cpu().numpy().reshape(-1, ncols)[valid.cpu().numpy().reshape(-1)]
    for (i, j) in extra_eq:
        rows = rows[rows[:, i] == rows[:, j]]
    proj = query.effective_projection()
    out = {v: rows[:, columns.index(v)] for v in proj}
    if query.distinct and len(rows):
        stacked = np.stack([out[v] for v in proj], axis=1)
        _, idx = np.unique(stacked, axis=0, return_index=True)
        out = {v: out[v][np.sort(idx)] for v in proj}
    return out


def _same_rows(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for v in want:
        assert got[v].dtype == want[v].dtype == np.int32, v
        assert got[v].shape == want[v].shape, v
        assert got[v].tobytes() == want[v].tobytes(), v


class _Recorder:
    """Wraps an engine's ``_eval_node`` and ``_collect_fn``: the root
    relation of the last plan and copies of its collected tensors."""

    def __init__(self, eng):
        self.rels, self.collected = [], None
        eval_node, collect_fn = eng._eval_node, eng._collect_fn

        def eval_rec(node, metrics):
            rel = eval_node(node, metrics)
            self.rels.append(rel)           # the root returns last
            return rel

        def collect_rec(ncols):
            collect = collect_fn(ncols)

            def run(rel, valid):
                data, v = collect(rel, valid)
                self.collected = data.clone(), v.clone()
                return data, v
            return run

        eng._eval_node, eng._collect_fn = eval_rec, collect_rec


@pytest.mark.parametrize("case", [CASES[3], CASES[6]] + OVERFLOW_CASES, ids=case_id)
def test_readback_selects_the_host_paths_rows(port_feds, case):
    """Per plan, ``execute``'s rows equal, in order, dtype and bytes, what
    the host path gives from the same collected tensors, and the read-back
    counts the selected rows' bytes and the select's count: two reads."""
    import dataclasses

    from repro_torch.engine.distributed import (NONZERO_COUNT_BYTES, DistributedEngine,
                                                UnsupportedShapeError)
    from repro_torch.launch.mesh import make_test_mesh

    which, (d, m), cap, aware = case
    fed, queries, opt = port_feds(which, d)
    eng = DistributedEngine(fed, make_test_mesh((d, m), device="cpu"), cap=cap,
                            partition_aware=aware)
    rec = _Recorder(eng)
    ran = overflowed = distinct = 0
    for q in queries:
        plan = opt.optimize(q)
        if plan.fallback:
            continue
        rec.rels.clear()
        try:
            res = eng.execute(plan)
        except UnsupportedShapeError:
            continue
        rel = rec.rels[-1]
        want = host_path_rows(*rec.collected, rel.columns, rel.extra_eq, plan.query)
        _same_rows(res.rows, want)
        # the rows the select kept, before DISTINCT
        kept = host_path_rows(*rec.collected, rel.columns, rel.extra_eq,
                              dataclasses.replace(plan.query, distinct=False))
        n_kept = len(next(iter(kept.values())))
        met = res.metrics
        assert met.readback_bytes == 4 * len(rel.columns) * n_kept + NONZERO_COUNT_BYTES
        assert met.readback_slots == d * m * cap
        assert met.host_syncs == plan_reads_and_columns(plan.root)[0] + 2
        ran += 1
        overflowed += met.overflowed
        distinct += plan.query.distinct and met.answer_rows < n_kept
    assert ran >= 6
    if case in OVERFLOW_CASES:
        assert overflowed
    else:
        assert distinct               # DISTINCT dropped rows somewhere


def _built_plan(columns, projection, distinct):
    """A one-leaf conjunctive plan over ``columns`` (its patterns only
    name the variables; ``execute`` reads the query's projection and
    DISTINCT flag)."""
    from repro_torch.core.planner import PhysicalPlan, SubqueryNode
    from repro_torch.query.algebra import BGPQuery, Const, TriplePattern, Var

    pats = [TriplePattern(Var(columns[0]), Const(1), Var(c)) for c in columns[1:]]
    q = BGPQuery(pats, distinct=distinct, projection=projection, name="built")
    return PhysicalPlan(root=SubqueryNode(stars=[0], patterns=pats, sources=[0]),
                        query=q, graph=None, selection=None)


# (name, value range, share of valid slots, secondary keys, projection,
# DISTINCT); four columns a-d on a (2, 3) mesh, 16 slots a shard
BUILT = [("empty", 5, 0.0, [], ["a", "c"], False),
         ("empty-distinct-eq", 5, 0.0, [(0, 2)], ["b"], True),
         ("full", 1000, 1.0, [], [], False),
         ("one-key", 3, 0.5, [(0, 2)], ["d", "a"], False),
         ("two-keys", 2, 0.7, [(0, 2), (1, 3)], [], False),
         ("keys-distinct", 2, 0.6, [(1, 3)], ["a", "b"], True),
         ("distinct", 2, 0.8, [], ["c", "a"], True),
         ("no-key-matches", 4, 0.5, [(0, 1)], ["a"], False)]


@pytest.mark.parametrize("name,hi,share,extra_eq,proj,distinct", BUILT,
                         ids=[b[0] for b in BUILT])
def test_readback_select_on_built_relations(name, hi, share, extra_eq, proj,
                                            distinct):
    """``execute`` over a ``DistRelation`` built by hand (an engine with no
    tables, its plan evaluation stubbed): an empty result, secondary join
    keys, DISTINCT, and a relation stored out of order in memory, each
    against the host path."""
    from repro_torch.engine.distributed import (NONZERO_COUNT_BYTES, DistRelation,
                                                DistributedEngine)
    from repro_torch.launch.mesh import make_test_mesh

    d, m, cap, columns = 2, 3, 16, ["a", "b", "c", "d"]
    rng = np.random.default_rng(len(name))
    # stored column-major, as an operator's column selection leaves it
    data = torch.from_numpy(
        rng.integers(0, hi, (4, d, m, cap)).astype(np.int32)).permute(1, 2, 3, 0)
    valid = torch.from_numpy(rng.random((d, m, cap)) < share)
    if name == "no-key-matches":
        data[..., 1] = data[..., 0] + 1
    rel = DistRelation(data, valid, torch.zeros(d, m, dtype=torch.bool), columns,
                       extra_eq=extra_eq)
    eng = DistributedEngine(None, make_test_mesh((d, m), device="cpu"), cap=cap,
                            table_cap=8)
    eng._eval_node = lambda node, metrics: rel
    plan = _built_plan(columns, proj, distinct)
    res = eng.execute(plan)
    _same_rows(res.rows, host_path_rows(data, valid, columns, extra_eq, plan.query))
    keep = valid.reshape(-1).numpy().copy()
    flat = data.reshape(-1, 4).numpy()
    for i, j in extra_eq:
        keep &= flat[:, i] == flat[:, j]
    n_kept = int(keep.sum())
    assert (n_kept == 0) == name.startswith(("empty", "no-key"))
    met = res.metrics
    assert met.readback_bytes == 16 * n_kept + NONZERO_COUNT_BYTES
    assert (met.host_syncs, met.readback_slots) == (2, d * m * cap)
    assert met.answer_rows == len(next(iter(res.rows.values())))
    # the rows are the host's own: no view of the relation's storage
    for col in res.rows.values():
        assert not np.shares_memory(col, data.numpy())


def test_algebra_plans_fall_back_to_the_local_engine(port_feds):
    """An OPTIONAL plan degrades to ``LocalEngine`` with a warning and
    ``fallback="local:algebra"``, rows equal the host engine's."""
    from repro_torch.engine.distributed import AlgebraFallbackWarning, DistributedEngine
    from repro_torch.engine.local import LocalEngine
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.rdf.generator import (fedbench_like_spec, generate_extended_workload,
                                           generate_federation)

    fed, gt = generate_federation(fedbench_like_spec(scale=0.06, seed=3))
    _, _, opt = port_feds("tiny", 9)
    eng = DistributedEngine(fed, make_test_mesh((9, 1), device="cpu"))
    qs = generate_extended_workload(fed, gt, n_optional=2, n_union=1,
                                    n_filtered=1, seed=17)
    for q in qs:
        plan = opt.optimize(q)
        with pytest.warns(AlgebraFallbackWarning):
            res = eng.execute(plan)
        want = LocalEngine(fed).execute(plan)
        assert res.fallback == "local:algebra"
        assert list(res.rows) == list(want.rows)
        for v in want.rows:
            assert res.rows[v].tobytes() == want.rows[v].tobytes()


def test_bare_engine_rejects_algebra_plans(port_feds):
    """``_eval_node`` raises before any tensor is touched (the reference's
    ``tests/test_algebra.py`` pins the same contract)."""
    from repro_torch.engine.distributed import DistMetrics, DistributedEngine
    from repro_torch.rdf.generator import (fedbench_like_spec, generate_extended_workload,
                                           generate_federation)

    fed, gt = generate_federation(fedbench_like_spec(scale=0.06, seed=3))
    q = generate_extended_workload(fed, gt, n_optional=1, n_union=0,
                                   n_filtered=0, seed=17)[0]
    plan = port_feds("tiny", 9)[2].optimize(q)
    eng = object.__new__(DistributedEngine)
    with pytest.raises(NotImplementedError, match="conjunctive"):
        eng._eval_node(plan.root, DistMetrics())


def test_unsupported_shapes_raise_one_error(port_feds):
    """More sources than data shards, and a cartesian join, raise
    ``UnsupportedShapeError`` (the reference asserts)."""
    from repro_torch.engine.distributed import (DistMetrics, DistributedEngine,
                                                UnsupportedShapeError)
    from repro_torch.launch.mesh import make_test_mesh

    fed, queries, opt = port_feds("selftest", 4)
    with pytest.raises(UnsupportedShapeError, match="one endpoint per data shard"):
        DistributedEngine(fed, make_test_mesh((2, 2), device="cpu"))
    eng = DistributedEngine(fed, make_test_mesh((4, 2), device="cpu"), cap=64)
    plan = opt.optimize(queries[0])
    rel = eng._eval_node(plan.root, DistMetrics())
    with pytest.raises(UnsupportedShapeError, match="cartesian"):
        eng._join(rel, rel, [], DistMetrics())


@pytest.mark.parametrize("argv", [["4", "2"], ["2", "2", "--no-partition-aware"],
                                  ["9", "4"]])
def test_dist_selftest_passes_on_the_cpu(argv, capsys):
    from repro_torch.launch import dist_selftest

    assert dist_selftest.main(argv + ["--device", "cpu"]) == 0
    assert "12/12 queries OK" in capsys.readouterr().out


# --------------------------------------------------------------------------
# the mesh and its collectives
# --------------------------------------------------------------------------

def test_meshes_keep_the_reference_shapes():
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    prod = make_production_mesh(device="cpu")
    assert prod.shape == {"data": 16, "model": 16}
    assert prod.axis_names == ("data", "model")
    pod = make_production_mesh(multi_pod=True, device="cpu")
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert pod.axis_names == ("pod", "data", "model")
    mesh = make_test_mesh(device="cpu")
    assert (mesh.shape, mesh.device) == ({"data": 2, "model": 2}, "cpu")


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_test_mesh, make_production_mesh):
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            make()


def test_collectives_equal_per_shard_definitions():
    """Each collective against its per-shard definition, written out with
    loops over the shards."""
    from repro_torch.launch.mesh import make_test_mesh

    d, m, cap, C = 3, 4, 5, 2
    mesh = make_test_mesh((d, m), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, (d, m, cap, C)).astype(np.int32)

    # all_to_all over model: shard j gets block j of every shard i, by i
    send = rng.integers(0, 100, (d, m, m, cap, C)).astype(np.int32)
    recv = mesh.all_to_all(torch.from_numpy(send), "model").numpy()
    for dd in range(d):
        for j in range(m):
            want = np.concatenate([send[dd, i, j][None] for i in range(m)])
            np.testing.assert_array_equal(recv[dd, j], want)

    # tiled all_gather over model, then data: data-major, model-minor
    full = mesh.all_gather(torch.from_numpy(x), ("model", "data")).numpy()
    assert full.shape == (1, 1, d * m * cap, C)
    want = np.concatenate([np.concatenate([x[dd, mm] for mm in range(m)])
                           for dd in range(d)])
    np.testing.assert_array_equal(full[0, 0], want)

    # over data only: shard (., mm) gets its model column of every source
    part = mesh.all_gather(torch.from_numpy(x), ("data",)).numpy()
    assert part.shape == (1, m, d * cap, C)
    for mm in range(m):
        np.testing.assert_array_equal(
            part[0, mm], np.concatenate([x[dd, mm] for dd in range(d)]))

    # psum over both axes, int32, and each shard's model index
    s = mesh.psum(torch.from_numpy(x[..., 0, 0]), ("model", "data"))
    assert s.dtype == torch.int32 and s.shape == (1, 1)
    assert int(s) == int(x[..., 0, 0].sum())
    idx = mesh.axis_index("model")
    assert idx.shape == (1, m) and idx.flatten().tolist() == list(range(m))


if __name__ == "__main__":
    reference_main(sys.argv[1])
