"""The CUDA kernels against their plain PyTorch versions on the card, and
plans of the card's DP against the port's numpy backend.  Every test here is
marked ``cuda`` and skips where no card is present; run them on a machine
with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports only the port, so the machine with the card needs no jax."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import join_order as jo        # noqa: E402
from repro_torch.core.cost import CostModel          # noqa: E402
from repro_torch.core.source_selection import SourceSelection  # noqa: E402
from repro_torch.kernels import dp_layer as K        # noqa: E402
from repro_torch.rdf.shapes import shaped_planning_inputs  # noqa: E402

pytestmark = pytest.mark.cuda
PARAMS = [(1.0, 1.0, 5.0, 20), (2.0, 0.5, 7.0, 10)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _sweep_inputs(n, conn_masks, B, seed, n_excl):
    """The seed recipe of the reference's
    ``test_dp_sweep_resident_matches_scalar_ref``: small integers force
    exact cost ties; some singletons have no source; some connected subsets
    carry an exclusive-leaf seed."""
    size = 1 << n
    rng = np.random.default_rng(seed)
    card = rng.integers(1, 5, (B, size)).astype(np.float64)
    cost0 = np.full((B, size), np.inf)
    n_src0 = np.zeros((B, size))
    src_w0 = np.ones((B, size))
    for i in range(n):
        m = 1 << i
        cost0[:, m] = rng.integers(1, 6, B)
        n_src0[:, m] = rng.integers(0, 3, B)
        src_w0[:, m] = rng.choice([1.0, 1.5], B)
    excl_cost = np.full((B, size), np.inf)
    excl_w = np.ones((B, size))
    pick = rng.choice(conn_masks, min(n_excl, len(conn_masks)), replace=False)
    excl_cost[:, pick] = rng.integers(1, 8, (B, len(pick)))
    excl_w[:, pick] = rng.choice([1.0, 2.0], (B, len(pick)))
    return card, excl_cost, excl_w, cost0, n_src0, src_w0


@pytest.mark.parametrize("shape,n,B", [("tree", 8, 4), ("clique", 9, 2),
                                       ("chain", 11, 3)])
def test_dp_sweep_kernel_equals_plain(dev, shape, n, B):
    g, _, _, _ = shaped_planning_inputs(shape, n, seed=n)
    sched = jo._dp_schedule(g, jo.DP_BLOCK_BYTES, B)
    conn = sched.layer_cols[sched.layer_cols < (1 << n)]
    t = [torch.from_numpy(x).to(dev)
         for x in _sweep_inputs(n, conn, B, seed=n + B, n_excl=15)]
    idx = sched.device_arrays(dev)
    for params in PARAMS:
        before = K.LAUNCHES["dp_sweep"]
        got = K.dp_sweep(params, *idx, *t)
        assert K.LAUNCHES["dp_sweep"] == before + n - 1
        want = K.dp_sweep_plain(params, *idx, *t)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.device.type == dev.type and a.dtype == b.dtype
            assert torch.equal(a, b)
        assert bool((got[1] != 0).any())


@pytest.mark.parametrize("B,R,C", [(1, 2, 3), (4, 130, 7), (2, 3000, 1),
                                   (3, 40, 300)])
def test_dp_layer_kernel_equals_plain(dev, B, R, C):
    rng = np.random.default_rng(B * 1000 + R + C)
    shp = (B, R, C)
    cost_a = rng.uniform(1, 100, shp)
    cost_b = rng.uniform(1, 100, shp)
    cost_a[:, ::3, :] = 5.0                            # exact ties across rows
    cost_b[:, ::3, :] = 5.0
    valid = rng.random((R, C)) < 0.6
    if C > 1:
        valid[:, -1] = False                           # an all-invalid column
    tile = [torch.from_numpy(x).to(dev) for x in (
        cost_a, cost_b, rng.uniform(0, 50, shp),
        rng.integers(1, 4, shp).astype(np.float64), rng.uniform(0.5, 2, shp),
        (rng.random(shp) < 0.5).astype(np.int8), valid.astype(np.int8),
        rng.uniform(0, 80, (B, C)))]
    for params in PARAMS:
        before = K.LAUNCHES["dp_layer"]
        got = K.dp_layer(*tile, params)
        assert K.LAUNCHES["dp_layer"] == before + 1
        want = K.dp_layer_plain(*tile, params)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_wrappers_reject_mixed_devices(dev):
    B, R, C = 2, 5, 3
    good = ([torch.zeros((B, R, C), dtype=torch.float64, device=dev)] * 5
            + [torch.zeros((B, R, C), dtype=torch.int8, device=dev),
               torch.zeros((R, C), dtype=torch.int8, device=dev),
               torch.zeros((B, C), dtype=torch.float64, device=dev)])
    mixed = list(good)
    mixed[6] = mixed[6].cpu()
    with pytest.raises(ValueError):
        K.dp_layer(*mixed, PARAMS[0])


def _vary(sel, b):
    ss = []
    for i, srcs in enumerate(sel.star_sources):
        keep = list(srcs)
        if b and (3 * i + b) % 5 == 0:
            keep = []
        ss.append(keep)
    return SourceSelection(star_sources=ss, star_cs=sel.star_cs,
                           edge_pairs=sel.edge_pairs)


def _same_tree(a, b):
    assert (a.kind, a.stars, a.cardinality, a.cost, a.sources,
            a.strategy) == (b.kind, b.stars, b.cardinality, b.cost,
                            b.sources, b.strategy)
    if a.kind == "join":
        _same_tree(a.left, b.left)
        _same_tree(a.right, b.right)


@pytest.mark.parametrize("shape,n,B,block_bytes,mode", [
    ("clique", 9, 4, None, "resident"), ("tree", 10, 2, None, "resident"),
    ("chain", 9, 3, 4096, "tiled"), ("clique", 7, 2, 4096, "tiled")])
def test_card_plans_equal_numpy(dev, shape, n, B, block_bytes, mode):
    g, stats, sel, q = shaped_planning_inputs(shape, n, seed=7)
    sels = [_vary(sel, b) for b in range(B)]
    before = dict(jo.DP_SWEEP_COUNTERS)
    got = jo.dp_join_order_batch([g] * B, stats, sels, CostModel(),
                                 q.distinct, block_bytes=block_bytes,
                                 device=str(dev))
    assert jo.DP_SWEEP_COUNTERS[mode] > before[mode]
    want = jo.dp_join_order_batch([g] * B, stats, sels, CostModel(),
                                  q.distinct, block_bytes=block_bytes,
                                  dp_backend="numpy")
    for a, b in zip(got, want):
        _same_tree(a, b)
