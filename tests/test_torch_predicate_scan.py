"""The SPMD executor's star scans over each pattern's predicate rows
(``operators.PredicateIndex``, ``operators.scan_rows``) against the full
scan (``operators.scan_pattern`` over every slot of every shard): the same
relation element for element, overflow included, and the same rows and
``DistMetrics`` from the engine on the small federations that
``tests/test_torch_distributed.py`` holds to the reference."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine import operators as ops  # noqa: E402

N_PRED = 5
P0 = 10                 # predicates P0 .. P0 + N_PRED - 1; P0 + 4 only on data shard 1


def random_shards(seed: int, d: int = 3, m: int = 2, n: int = 50):
    """``(table, trow)`` of ``d x m`` shards of ``n`` slots: subjects and
    objects from a few values, so bound ones match several rows; predicates
    repeat, and the last one lives on data shard 1 only; about a fifth of
    the slots invalid, anywhere in a shard."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 4, (d, m, n, 3)).astype(np.int32)
    table[..., 1] = rng.integers(P0, P0 + N_PRED - 1, (d, m, n))
    table[1, :, ::3, 1] = P0 + N_PRED - 1
    trow = rng.random((d, m, n)) < 0.8
    return table, trow


ALL, NOT_1, ONLY_0 = "all", "not-1", "only-0"
# (name, pattern, selected data shards, cap)
SCANS = [("predicate", (-1, P0, -1), ALL, 64),
         ("subject", (2, P0 + 1, -1), ALL, 64),
         ("object", (-1, P0 + 2, 3), ALL, 64),
         ("subject-object", (1, P0, 0), ALL, 64),
         ("overflow", (-1, P0 + 1, -1), ALL, 4),
         ("overflow-some", (-1, P0 + 1, -1), ALL, 9),
         ("overflow-bound", (-1, P0 + 3, 1), ALL, 1),
         ("unselected", (-1, P0 + 2, -1), NOT_1, 64),
         ("missing-in-some", (-1, P0 + 4, -1), ALL, 64),
         ("missing-in-some-overflow", (0, P0 + 4, -1), ALL, 3),
         ("held-by-no-selected", (-1, P0 + 4, -1), ONLY_0, 64),
         ("held-by-none", (-1, P0 + 9, -1), ALL, 64),
         ("no-match", (99, P0, -1), ALL, 64)]


def selected(which: str, d: int, m: int) -> np.ndarray:
    on = np.ones((d, m), bool)
    if which == NOT_1:
        on[1] = False
    elif which == ONLY_0:
        on[1:] = False
    return on


def both_scans(table, trow, pattern, on, cap, device):
    """(ranged relation, its slots, full-scan relation) on ``device``."""
    t = torch.from_numpy(table).to(device)
    index = ops.PredicateIndex(table[..., 1], trow, device)
    got, slots = index.scan(t, pattern, on, cap, (0, 2))
    mask = torch.from_numpy(trow & on[..., None]).to(device)
    want = ops.scan_pattern(t, mask, list(pattern), cap, (0, 2))
    return got, slots, want


def assert_same_relation(got, want) -> None:
    for g, w, what in zip(got, want, ("data", "valid", "overflow")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.equal(g.cpu(), w.cpu()), what


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,pattern,which,cap", SCANS, ids=[s[0] for s in SCANS])
def test_ranged_scan_equals_full_scan(name, pattern, which, cap, seed):
    table, trow = random_shards(seed)
    d, m, n = trow.shape
    on = selected(which, d, m)
    got, slots, want = both_scans(table, trow, pattern, on, cap, "cpu")
    assert_same_relation(got, want)
    # the slots compared: every shard padded to the largest selected count
    counts = ((table[..., 1] == pattern[1]) & trow & on[..., None]).sum(-1)
    width = int(counts.max())
    assert slots == (d * m * (1 << (width - 1).bit_length()) if width else 0)
    assert slots < d * m * n
    if name.startswith("overflow"):
        assert bool(want[2].any())
    if name.startswith(("held-by", "no-match")):
        assert not bool(want[1].any())


def test_index_orders_each_shards_rows_by_predicate_then_position():
    table, trow = random_shards(5, n=40)
    index = ops.PredicateIndex(table[..., 1], trow, "cpu")
    order = index.order.numpy()
    assert order.dtype == np.int32 and order.shape == trow.shape
    for (dd, mm), ok in np.ndenumerate(trow.any(-1)):
        pos = np.flatnonzero(trow[dd, mm])
        want = sorted(pos, key=lambda i: (table[dd, mm, i, 1], i))
        np.testing.assert_array_equal(order[dd, mm, :len(pos)], want)
        for p, (start, count) in ((p, r[:, dd, mm]) for p, r in index.ranges.items()):
            rows = order[dd, mm, start:start + count]
            assert (table[dd, mm, rows, 1] == p).all()
            assert count == int((table[dd, mm, pos, 1] == p).sum())
    assert set(index.ranges) == set(np.unique(table[..., 1][trow]).tolist())
    assert (index.ranges[P0 + N_PRED - 1][1][[0, 2]] == 0).all()


# --------------------------------------------------------------------------
# the engine: rows and metrics as with the full scan
# --------------------------------------------------------------------------

class FullScan:
    """Stands in for an engine's ``pred_index``: the full scan, every slot
    of every shard, counted as ``d * m * table_cap`` slots a pattern."""

    def __init__(self, trow: torch.Tensor):
        self.trow = trow

    def scan(self, table, pattern, on, cap, out_cols):
        on = torch.from_numpy(on).to(table.device).unsqueeze(-1)
        return (ops.scan_pattern(table, self.trow & on, list(pattern), cap, out_cols),
                self.trow.numel())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: PyTorch's thread pool costs more than it gives when
    the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_feds():
    from test_torch_distributed import federation

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


def _engine_cases():
    from test_torch_distributed import CASES, OVERFLOW_CASES, case_id
    return [pytest.param(c, id=case_id(c)) for c in CASES + OVERFLOW_CASES]


@pytest.mark.parametrize("case", _engine_cases())
def test_engine_rows_and_metrics_equal_the_full_scans(small_feds, case):
    """Per plan, the rows (order, dtype, bytes) and every ``DistMetrics``
    count but ``scan_slots`` equal an engine whose stars scan every slot;
    ``scan_slots`` is below that engine's ``d * m * table_cap`` a pattern."""
    from repro_torch.engine.distributed import DistributedEngine, UnsupportedShapeError
    from repro_torch.launch.mesh import make_test_mesh

    which, (d, m), cap, aware = case
    fed, queries, opt = small_feds(which, d)
    eng, full = (DistributedEngine(fed, make_test_mesh((d, m), device="cpu"), cap=cap,
                                   partition_aware=aware) for _ in range(2))
    full.pred_index = FullScan(full.trow)
    ran = overflowed = 0
    for q in queries:
        plan = opt.optimize(q)
        if plan.fallback:
            continue
        try:
            got = eng.execute(plan)
        except UnsupportedShapeError:
            continue
        want = full.execute(plan)
        assert list(got.rows) == list(want.rows), q.name
        for v in want.rows:
            assert got.rows[v].dtype == want.rows[v].dtype, (q.name, v)
            assert got.rows[v].tobytes() == want.rows[v].tobytes(), (q.name, v)
        assert got.metrics == dataclasses.replace(want.metrics,
                                                  scan_slots=got.metrics.scan_slots), q.name
        assert 0 < want.metrics.scan_slots and want.metrics.scan_slots % (d * m * eng.table_cap) == 0
        assert got.metrics.scan_slots < want.metrics.scan_slots, q.name
        ran += 1
        overflowed += got.metrics.overflowed
    assert ran >= 6
    assert bool(overflowed) == (cap < 4096)
