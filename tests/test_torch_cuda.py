"""The CUDA kernels against their plain PyTorch versions on the card, and
plans of the card's DP against the port's numpy backend.  Every test here is
marked ``cuda`` and skips where no card is present; run them on a machine
with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports only the port, so the machine with the card needs no jax."""
import hashlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import join_order as jo        # noqa: E402
from repro_torch.core.cost import CostModel          # noqa: E402
from repro_torch.core.source_selection import SourceSelection  # noqa: E402
from repro_torch.kernels import build               # noqa: E402
from repro_torch.kernels import dp_layer as K        # noqa: E402
from repro_torch.kernels import join_count as JC     # noqa: E402
from repro_torch.kernels import ops                  # noqa: E402
from repro_torch.kernels import seg_bitmap as SB     # noqa: E402
from repro_torch.kernels import sorted_intersect as SI  # noqa: E402
from repro_torch.kernels import summary_probe as SP  # noqa: E402
from repro_torch.core.characteristic_sets import compute_characteristic_sets_torch  # noqa: E402
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


@pytest.mark.parametrize("shape,n,B,dead", [
    ("tree", 8, 4, None), ("clique", 9, 2, None), ("chain", 11, 3, None),
    ("clique", 14, 1, None),    # top column: 16,382 pairs, 64 items
    ("clique", 10, 64, None),   # (item, member) units over one grid pass
    ("clique", 12, 2, 3)])      # columns (split ones too) with no finite pair
def test_dp_sweep_kernel_equals_plain(dev, shape, n, B, dead):
    """One cooperative launch per sweep, equal to the plain version.  With
    ``dead``, that star's leaf costs ``inf`` and has no source (no bind join
    reaches it) in every member, and no subset holding it has an exclusive
    seed, so no column holding it has a finite pair."""
    g, _, _, _ = shaped_planning_inputs(shape, n, seed=n)
    sched = jo._dp_schedule(g, jo.DP_BLOCK_BYTES, B)
    assert jo._resident_fits(sched, B, jo.DP_BLOCK_BYTES)
    size = 1 << n
    conn = sched.layer_cols[sched.layer_cols < size]
    card, excl_cost, excl_w, cost0, n_src0, src_w0 = _sweep_inputs(
        n, conn, B, seed=n + B, n_excl=15)
    if dead is not None:
        excl_cost[:, (np.arange(size) >> dead) & 1 == 1] = np.inf
        cost0[:, 1 << dead] = np.inf
        n_src0[:, 1 << dead] = 0.0
        dead_cols = torch.from_numpy(conn[(conn >> dead) & 1 == 1]).to(dev)
    t = [torch.from_numpy(x).to(dev)
         for x in (card, excl_cost, excl_w, cost0, n_src0, src_w0)]
    idx = sched.device_arrays(dev)
    for params in PARAMS:
        before = build.LAUNCHES["dp_sweep"]
        got = K.dp_sweep(params, *idx, *t, **sched.device_work(dev))
        assert build.LAUNCHES["dp_sweep"] == before + 1
        want = K.dp_sweep_plain(params, *idx, *t)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.device.type == dev.type and a.dtype == b.dtype
            assert torch.equal(a, b)
        assert bool((got[1] != 0).any())
        if dead is not None:        # strat 0: no pair won, no seed
            assert bool((got[1][:, dead_cols.long()] == 0).all())
            assert bool(torch.isinf(got[0][:, dead_cols.long()]).all())


@pytest.mark.parametrize("B,R,C", [(1, 2, 3), (4, 130, 7), (2, 3000, 1),
                                   (3, 40, 300),
                                   (4, 419430, 1),     # chain20's tall tile
                                   (8, 1022, 205),     # tree16's widest
                                   (3, 1, 5), (2, 0, 4)])
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
        before = build.LAUNCHES["dp_layer"]
        got = K.dp_layer(*tile, params)
        assert build.LAUNCHES["dp_layer"] == before + 1
        want = K.dp_layer_plain(*tile, params)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("B,R,C", [(4, 20000, 1), (3, 1000, 40)])
def test_dp_layer_kernel_first_minimum_across_chunks(dev, B, R, C):
    """The first strict minimum lies in a later row chunk, equal costs
    repeat in the chunks after it, an earlier equal row is invalid; member 1
    is valid but all ``inf`` (``cost_a = inf``); with several columns,
    column 1 is ``inf`` except in its last row."""
    shp = (B, R, C)
    rng = np.random.default_rng(R + C)
    cost_a = np.full(shp, 50.0)
    cost_b = np.full(shp, 50.0)
    chunk = K._chunk_rows(B, R, C, K.sm_count(dev))
    first = R // 4 + 17
    assert first // chunk >= 1                     # not in the first chunk
    ties = [first, first + 300, first + 3 * chunk + 5, R - 1]
    early = R // 8
    for r in ties + [early]:
        cost_a[:, r, :] = cost_b[:, r, :] = 1.0
    valid = np.ones((R, C), bool)
    valid[early] = False
    if C > 1:
        cost_a[:, :, 1] = np.inf
        cost_a[:, -1, 1] = 2.0
    cost_a[1] = np.inf
    bind = np.broadcast_to(rng.random((B, 1, C)) < 0.5, shp)
    tile = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        cost_a, cost_b, np.full(shp, 10.0), np.ones(shp), np.ones(shp),
        bind.astype(np.int8), valid.astype(np.int8),
        rng.uniform(0, 80, (B, C)))]
    for params in PARAMS:
        got = K.dp_layer(*tile, params)
        want = K.dp_layer_plain(*tile, params)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        best, row, is_bind = (t.cpu().numpy() for t in got)
        assert (row[0, 0], row[2, 0]) == (first, first)
        assert np.isinf(best[1]).all() and (row[1] == 2**31 - 1).all()
        assert (is_bind[1] == 0).all()
        if C > 1:
            assert (row[[0, 2], 1] == R - 1).all()


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


def _i32(dev, *xs):
    return [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
            for x in xs]


def _counted(name, fn, *args):
    before = build.LAUNCHES[name]
    out = fn(*args)
    return out, build.LAUNCHES[name] - before


@pytest.mark.parametrize("na,nb,hi", [(1, 1, 4), (300, 517, 900),
                                      (227_110, 400_000, 4_000_000),
                                      (0, 5, 10), (5, 0, 10)])
def test_sorted_intersect_and_join_count_kernels_equal_plain(dev, na, nb, hi):
    rng = np.random.default_rng(na + nb)
    a = rng.permutation(rng.choice(hi, na, replace=False)) - hi // 10
    b = np.sort(rng.integers(0, hi, nb)) - hi // 10     # duplicate keys
    aw, bw = rng.integers(-50, 2**20, na), rng.integers(-50, 2**20, nb)
    ta, taw, tb, tbw = _i32(dev, a, aw, b, bw)
    got, n = _counted("sorted_intersect", SI.sorted_intersect, ta, taw, tb, tbw)
    assert n == (1 if na and nb else 0)
    want = SI.sorted_intersect_plain(ta, taw, tb, tbw)
    got_c, n = _counted("join_count", JC.join_count, ta, tb, tbw)
    assert n == (1 if na else 0)
    want_c = JC.join_count_plain(ta, tb, tbw)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and torch.equal(got, want)
    assert torch.equal(got_c, want_c)


def _segment_lists(case: str, rng):
    """The list pairs ``(a, aw, b, bw)`` of one segmented case; ``b`` sorted
    ascending, ``a`` in any order."""
    def pair(na, nb, hi, sort_a=True, w=2**20):
        a = rng.integers(-hi // 10, hi, na)
        b = np.sort(rng.integers(-hi // 10, hi, nb))         # duplicate keys
        return (np.sort(a) if sort_a else a, rng.integers(-50, w, na), b,
                rng.integers(-50, w, nb))

    if case == "one_segment":
        return [pair(5000, 7000, 20_000)]
    if case == "many_short":
        return [pair(int(rng.integers(1, 300)), int(rng.integers(1, 300)), 900)
                for _ in range(500)]
    if case == "longer_than_tile":
        return [pair(3 * SI.TILE + 17, 4000, 9000), pair(SI.TILE, 50, 200),
                pair(SI.TILE + 1, SI.TILE + 1, 3000)]
    if case == "big_among_short":          # the longest exact check at scale 100
        lists = [pair(int(rng.integers(1, 3000)), int(rng.integers(1, 3000)),
                      40_000) for _ in range(1000)]
        lists.insert(500, pair(86_609, 158_241, 4_000_000))
        return lists
    if case == "window_over_budget":       # unsorted probes over a long build
        return [pair(2000, 4 * SI.SMEM_KEYS, 100_000, sort_a=False),
                pair(20_000, 4 * SI.SMEM_KEYS, 100_000)]
    if case == "unsorted_duplicates":
        return [(np.repeat(rng.permutation(400) - 100, 3),
                 rng.integers(-9, 9, 1200), np.sort(rng.integers(-60, 300, 700)),
                 rng.integers(-9, 9, 700)) for _ in range(5)]
    if case == "wrapping":
        return [(np.zeros(1000), np.full(1000, 2**30 + 7), np.zeros(999),
                 np.full(999, 2**29 + 3)), pair(300, 517, 900, w=2**31 - 1)]
    if case == "empty_segments":
        return [([], [], [1, 2], [1, 1]), pair(40, 30, 60), ([3, 1], [1, 1], [], []),
                ([], [], [], []), pair(1, 1, 2)]
    if case == "no_segments":
        return []
    raise KeyError(case)


def _pack(lists, rng):
    """The list pairs as segments of base arrays, with unrelated ids between
    them: the base tensors on the host and the int64 bounds."""
    bases, bounds = [[], [], [], []], [[], [], [], []]
    for case in lists:
        for side in (0, 1):
            gap = int(rng.integers(0, 5))
            pos = sum(len(x) for x in bases[2 * side])
            for c in (0, 1):
                bases[2 * side + c] += [rng.integers(-9, 9, gap),
                                        np.asarray(case[2 * side + c], np.int64)]
            bounds[2 * side] += [pos + gap]
            bounds[2 * side + 1] += [len(case[2 * side])]
    base = [np.concatenate(x) if x else np.zeros(0) for x in bases]
    return base, [np.asarray(x, np.int64) for x in bounds]


def _staged_windows(a, a_off, a_len, b, b_off, b_len):
    """Per tile, whether its build window fits ``SMEM_KEYS`` (the kernel's
    shared-memory branch) or not (its global-memory branch)."""
    seg, start = SI.tile_list(a_len, (a_len > 0) & (b_len > 0))
    fits = []
    for k, s0 in zip(seg, start):
        keys = a[a_off[k] + s0:a_off[k] + min(a_len[k], s0 + SI.TILE)]
        bk = b[b_off[k]:b_off[k] + b_len[k]]
        wn = (np.searchsorted(bk, keys.max(), "right")
              - np.searchsorted(bk, keys.min(), "left"))
        fits.append(wn <= SI.SMEM_KEYS)
    return np.asarray(fits, bool)


SEGMENT_CASES = ["one_segment", "many_short", "longer_than_tile",
                 "big_among_short", "window_over_budget", "unsorted_duplicates",
                 "wrapping", "empty_segments", "no_segments"]


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segmented_kernels_equal_plain(dev, case):
    rng = np.random.default_rng(sum(map(ord, case)))
    (a, aw, b, bw), (a_off, a_len, b_off, b_len) = _pack(
        _segment_lists(case, rng), rng)
    fits = _staged_windows(a, a_off, a_len, b, b_off, b_len)
    if case == "window_over_budget":       # both branches of the kernel
        assert fits.any() and not fits.all()
    ta, taw, tb, tbw = _i32(dev, a, aw, b, bw)
    bounds = (a_off, a_len, b_off, b_len)
    got, n = _counted("sorted_intersect", SI.sorted_intersect_segments, ta,
                      taw, a_off, a_len, tb, tbw, b_off, b_len)
    assert n == (1 if len(fits) else 0)
    want = SI.sorted_intersect_segments_plain(ta, taw, a_off, a_len, tb, tbw,
                                              b_off, b_len)
    got_c, n = _counted("join_count", JC.join_count_segments, ta, a_off, a_len,
                        tb, tbw, b_off, b_len)
    assert n == (1 if a_len.any() else 0)
    want_c = JC.join_count_segments_plain(ta, a_off, a_len, tb, tbw, b_off,
                                          b_len)
    got_o = ops.intersect_counts(a, aw, *bounds[:2], b, bw, *bounds[2:])
    got_m = ops.match_counts_segments(a, a_off, a_len, b, bw, b_off, b_len)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == (len(a_off),)
    assert torch.equal(got, want) and torch.equal(got_o, want)
    assert got_c.shape == (int(a_len.sum()),)
    assert torch.equal(got_c, want_c) and torch.equal(got_m, want_c)


@pytest.mark.parametrize("n,n_seg", [(1, 1), (1000, 37), (3_600_000, 400_000),
                                     (0, 3), (10, 0)])
def test_seg_bitmap_kernel_equals_plain(dev, n, n_seg):
    rng = np.random.default_rng(n + n_seg)
    seg = np.sort(rng.integers(-1, n_seg + 2, n))      # -1 rows and rows past the plane
    bucket = rng.integers(-1, 129, n)
    ts, tk = _i32(dev, seg, bucket)
    got, launched = _counted("seg_bitmap", SB.seg_bitmap, ts, tk, n_seg)
    assert launched == (1 if n and n_seg else 0)
    want = SB.seg_bitmap_plain(ts, tk, n_seg)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)


def _seg_layout(case):
    """Rows of one ``seg_bitmap`` layout and the path the kernel must take:
    segment order with padding between the rows (the statistics path's
    layout), one segment over several of the kernel's tiles, runs of
    missing segments at the start, middle and end, rows past the plane and
    buckets outside ``[0, 128)`` among ordered rows, no row in the plane,
    one step back across two tiles, gaps of many missing ids, a long run
    of padding, and rows in no order."""
    rng = np.random.default_rng(len(case))
    if case == "interspersed_pads":
        seg = np.sort(rng.integers(0, 3000, 20_000))
        seg[rng.random(20_000) < 0.3] = -1
        return seg, rng.integers(0, 128, 20_000), 3000, "ordered"
    if case == "long_segment":
        seg = np.sort(np.concatenate([rng.integers(0, 40, 3000),
                                      np.full(5000, 17)]))
        seg[rng.random(8000) < 0.2] = -1
        return seg, rng.integers(0, 128, 8000), 40, "ordered"
    if case == "gaps":                 # present: [700, 1500) and [3000, 3500)
        seg = np.sort(np.concatenate([rng.integers(700, 1500, 6000),
                                      rng.integers(3000, 3500, 4000)]))
        seg[rng.random(10_000) < 0.3] = -1
        return seg, rng.integers(0, 128, 10_000), 5000, "ordered"
    if case == "out_of_plane":
        seg = np.sort(rng.integers(0, 2000, 12_000))
        seg[rng.random(12_000) < 0.1] = -1
        far = rng.random(12_000) < 0.05
        seg[far] = rng.integers(2000, 2**31 - 1, int(far.sum()))
        return seg, rng.integers(-3, 131, 12_000), 2000, "ordered"
    if case == "pads_only":
        return np.full(3000, -1), rng.integers(0, 128, 3000), 70, "unordered"
    if case == "one_step_back":        # ordered but across two tiles
        seg = np.sort(rng.integers(0, 3000, 20_000))
        seg[SB.TILE_ROWS * 7] = seg[SB.TILE_ROWS * 7 - 1] - 1
        return seg, rng.integers(0, 128, 20_000), 3000, "unordered"
    if case == "sparse":               # gaps of 50,000 and more missing ids
        seg = np.sort(np.concatenate([rng.integers(0, 100, 3000),
                                      rng.integers(50_000, 50_100, 3000),
                                      rng.integers(200_000, 200_050, 3000)]))
        seg[rng.random(9000) < 0.3] = -1
        return seg, rng.integers(0, 128, 9000), 300_000, "ordered"
    if case == "long_pad_run":         # 5,000 pads between two segments
        seg = np.sort(rng.integers(0, 300, 8000))
        seg[1000:6000] = -1
        return seg, rng.integers(0, 128, 8000), 300, "ordered"
    if case == "unordered":
        return (rng.integers(-1, 3000, 20_000), rng.integers(0, 128, 20_000),
                3000, "unordered")
    raise KeyError(case)


@pytest.mark.parametrize("case", ["interspersed_pads", "long_segment", "gaps",
                                  "out_of_plane", "pads_only", "one_step_back",
                                  "sparse", "long_pad_run", "unordered"])
def test_seg_bitmap_kernel_layouts(dev, case):
    seg, bucket, n_seg, path = _seg_layout(case)
    ts, tk = _i32(dev, seg, bucket)
    before = build.LAUNCHES["seg_bitmap"]
    got, took = SB.seg_bitmap_path(ts, tk, n_seg)
    assert build.LAUNCHES["seg_bitmap"] - before == 1
    assert took == path
    assert torch.equal(got, SB.seg_bitmap_plain(ts, tk, n_seg))


@pytest.mark.parametrize("w", [1, 3, 5, 512])
@pytest.mark.parametrize("na,nb,form", [(8, 40, "warp"), (300, 200, "warp"),
                                        (400, 400, "tiled")])
def test_summary_probe_kernel_forms(dev, na, nb, form, w):
    assert SP.form(na, nb, K.sm_count(dev)) == form
    rng = np.random.default_rng(na + nb + w)
    ta, tb = _i32(dev, rng.integers(-2**31, 2**31, (na, w)),
                  rng.integers(-2**31, 2**31, (nb, w)))
    got, launched = _counted("summary_probe", SP.summary_probe, ta, tb)
    assert launched == 1
    assert torch.equal(got, SP.summary_probe_plain(ta, tb))


@pytest.mark.parametrize("w", [3, 5, 512])
@pytest.mark.parametrize("na,nb", [(8, 40), (400, 400)])
@pytest.mark.parametrize("sa,sb", [(1, 0), (1, 1), (2, 3)])
def test_summary_probe_kernel_rows_off_16_bytes(dev, na, nb, w, sa, sb):
    """Row blocks that start ``sa`` and ``sb`` words into a buffer: no row,
    or not both rows of a pair, on a 16-byte boundary."""
    rng = np.random.default_rng(na * w + sa + 7 * sb)
    bufa, bufb = _i32(dev, rng.integers(-2**31, 2**31, na * w + sa),
                      rng.integers(-2**31, 2**31, nb * w + sb))
    ta, tb = bufa[sa:].view(na, w), bufb[sb:].view(nb, w)
    assert ta.data_ptr() % 16 and ta.is_contiguous()
    got = SP.summary_probe(ta, tb)
    assert torch.equal(got, SP.summary_probe_plain(ta, tb))


@pytest.mark.parametrize("na,nb,w", [(1, 1, 1), (33, 65, 31), (7, 40, 512),
                                     (300, 200, 512), (0, 3, 8), (4, 3, 0)])
def test_summary_probe_kernel_equals_plain(dev, na, nb, w):
    rng = np.random.default_rng(na * nb + w)
    ta, tb = _i32(dev, rng.integers(-2**31, 2**31, (na, w)),
                  rng.integers(-2**31, 2**31, (nb, w)))
    got, launched = _counted("summary_probe", SP.summary_probe, ta, tb)
    assert launched == (1 if na and nb and w else 0)
    want = SP.summary_probe_plain(ta, tb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_stats_ops_default_to_the_card_and_equal_the_cpu(dev):
    rng = np.random.default_rng(3)
    a, b = np.sort(rng.integers(0, 500, 400)), np.sort(rng.integers(0, 500, 300))
    aw, bw = rng.integers(1, 9, 400), rng.integers(1, 9, 300)
    before = dict(build.LAUNCHES)
    assert ops.intersect_count(a, aw, b, bw) == ops.intersect_count(
        a, aw, b, bw, device="cpu")
    np.testing.assert_array_equal(ops.match_counts(a, b, bw),
                                  ops.match_counts(a, b, bw, device="cpu"))
    seg, bkt = np.sort(rng.integers(-1, 50, 900)), rng.integers(0, 128, 900)
    np.testing.assert_array_equal(ops.predicate_bitmaps(seg, bkt, 50),
                                  ops.predicate_bitmaps(seg, bkt, 50, device="cpu"))
    sa = rng.integers(0, 2**63, (9, 256), dtype=np.uint64)
    sb = rng.integers(0, 2**63, (11, 256), dtype=np.uint64)
    np.testing.assert_array_equal(ops.signature_overlap(sa, sb),
                                  ops.signature_overlap(sa, sb, device="cpu"))
    for k in ("sorted_intersect", "join_count", "seg_bitmap", "summary_probe"):
        assert build.LAUNCHES[k] == before[k] + 1


def test_device_cs_on_the_card_equals_cpu(dev):
    rng = np.random.default_rng(5)
    s = rng.integers(0, 5000, 200_000).astype(np.int32)
    p = rng.integers(0, 300, 200_000).astype(np.int32)
    got = compute_characteristic_sets_torch(s, p)
    want = compute_characteristic_sets_torch(s, p, device="cpu")
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)


def test_federated_cps_ops_on_the_card_equal_cpu(dev):
    from repro_torch.core.federation import (build_federated_stats,
                                             compute_federated_cps_ops)
    from repro_torch.rdf.generator import fedbench_like_spec, generate_federation

    fed, _ = generate_federation(fedbench_like_spec(scale=0.5))
    stats = build_federated_stats(fed)
    got = compute_federated_cps_ops(stats.exports, stats.summaries)
    want = compute_federated_cps_ops(stats.exports, stats.summaries, device="cpu")
    assert got.keys() == want.keys()
    for key, g in got.items():
        w = want[key]
        np.testing.assert_array_equal(g.candidates, w.candidates)
        assert g.pairs == w.pairs and g.n_checked_pairs == w.n_checked_pairs
        for f in ("pred", "cs1", "cs2", "count"):
            np.testing.assert_array_equal(getattr(g.cps, f), getattr(w.cps, f))
            np.testing.assert_array_equal(getattr(g.match_cps, f),
                                          getattr(w.match_cps, f))


# --------------------------------------------------------------------------
# the LM kernels: flash attention and the selective scan
# --------------------------------------------------------------------------

def _qkv(rng, B, S, H, KV, hd, dtype):
    mk = lambda h: torch.from_numpy(rng.normal(size=(B, S, h, hd)).astype(
        np.float32)).to(dtype)
    return mk(H), mk(KV), mk(KV)


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 200, 14, 2, 64),
                                         (2, 256, 4, 2, 128),
                                         (1, 129, 2, 1, 256),
                                         (1, 3072, 14, 2, 64),
                                         (1, 64, 4, 2, 64),    # one tile
                                         (2, 63, 4, 1, 128),   # one under
                                         (1, 63, 2, 1, 256),
                                         (1, 64, 2, 2, 256),
                                         (1, 2924, 14, 2, 64)])  # qwen2's longest
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100), (False, 0),
                                           (False, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_equals_plain(dev, B, S, H, KV, hd, causal,
                                             window, dtype):
    from repro_torch.kernels import flash_attention as FA

    dt = getattr(torch, dtype)
    q, k, v = (t.to(dev) for t in _qkv(np.random.default_rng(S + hd), B, S,
                                        H, KV, hd, dt))
    before = build.LAUNCHES["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    assert build.LAUNCHES["flash_attention"] == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_gqa_on_card_equals_cpu(dev):
    q, k, v = _qkv(np.random.default_rng(3), 2, 300, 8, 2, 128, torch.float32)
    got = ops.flash_attention_gqa(q.to(dev), k.to(dev), v.to(dev), window=77)
    want = ops.flash_attention_gqa(q, k, v, window=77)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)


def test_lm_kernels_reject_what_they_do_not_take(dev):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS

    q, k, v = (t.to(dev) for t in _qkv(np.random.default_rng(0), 1, 64, 2, 1,
                                        32, torch.float32))
    with pytest.raises(ValueError, match="head width"):
        FA.flash_attention(q, k, v)
    q, k, v = _qkv(np.random.default_rng(0), 1, 64, 2, 1, 64, torch.float32)
    with pytest.raises(ValueError, match="expected"):
        FA.flash_attention(q.to(dev), k, v.to(dev))
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.to(dev).transpose(1, 2).contiguous().transpose(1, 2),
                           k.to(dev), v.to(dev))
    x = torch.zeros((1, 8, 4), device=dev)
    bt = torch.zeros((1, 8, 40), device=dev)
    with pytest.raises(ValueError, match="state width"):
        SS.ssm_scan(x, bt, bt, x, torch.zeros((4, 40), device=dev))


def _scan_inputs(rng, B, S, D, N):
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (f(np.abs(rng.normal(0.1, 0.05, (B, S, D)))),
            f(rng.normal(size=(B, S, N))), f(rng.normal(size=(B, S, N))),
            f(rng.normal(size=(B, S, D))),
            f(-np.abs(rng.normal(1.0, 0.3, (D, N)))))


@pytest.mark.parametrize("B,S,D,N", [(1, 64, 256, 8), (2, 100, 300, 16),
                                     (1, 37, 5, 32), (3, 0, 7, 16),
                                     (1, 1024, 8192, 16), (2, 5, 7, 0)])
def test_ssm_scan_kernel_equals_plain(dev, B, S, D, N):
    from repro_torch.kernels import ssm_scan as SS

    args = [t.to(dev) for t in _scan_inputs(np.random.default_rng(S + D), B,
                                             S, D, N)]
    before = build.LAUNCHES["ssm_scan"]
    y, h = SS.ssm_scan(*args)
    # no state (N = 0): nothing to launch, and y is zeros
    assert build.LAUNCHES["ssm_scan"] == before + (1 if N else 0)
    y0, h0 = SS.ssm_scan_plain(*args)
    torch.cuda.synchronize()
    assert y.shape == (B, S, D) and h.shape == (B, D, N)
    torch.testing.assert_close(y, y0, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, h0, rtol=2e-4, atol=2e-4)


# the scan's chunk length (32 steps): sequences at and around one and two
# chunks, channels that do not fill the 32-channel block, state widths on
# both sides of the 16-state instance, and three rows that differ
_L = 32
SCAN_EDGES = [(1, 1, 40, 16), (1, _L - 1, 40, 16), (1, _L, 40, 16),
              (1, _L + 1, 40, 16), (1, 2 * _L + 1, 40, 16),
              (1, 2 * _L + 1, 70, 1), (1, 2 * _L + 1, 70, 17),
              (1, 2 * _L + 1, 33, 32), (3, 3 * _L + 5, 45, 16)]


def _scan_check(SS, args):
    y0, h0 = SS.ssm_scan_plain(*args)
    before = build.LAUNCHES["ssm_scan"]
    y, h = SS.ssm_scan(*args)
    assert build.LAUNCHES["ssm_scan"] == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y0, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, h0, rtol=2e-4, atol=2e-4)
    return y, h


@pytest.mark.parametrize("B,S,D,N", SCAN_EDGES)
def test_ssm_scan_kernel_chunk_edges(dev, B, S, D, N):
    from repro_torch.kernels import ssm_scan as SS

    args = [t.to(dev) for t in _scan_inputs(np.random.default_rng(7 * S + N),
                                             B, S, D, N)]
    y, h = _scan_check(SS, args)
    if B == 3:       # rows differ, and each row's scan is its own
        assert not torch.allclose(y[0], y[1]) and not torch.allclose(h[1], h[2])


@pytest.mark.parametrize("dt_mean,S", [(3.0, 4 * _L + 3), (0.003, 4 * _L + 3)])
def test_ssm_scan_kernel_carry_across_chunks(dev, dt_mean, S):
    """Strong decay (large dt: a state forgets within a few steps, so a
    state carried into the next chunk without its decay shows) and weak
    decay (the carry dominates every later chunk, so a dropped carry
    shows), over five chunks, which wrap the three-slot staging ring."""
    from repro_torch.kernels import ssm_scan as SS

    rng = np.random.default_rng(int(dt_mean * 1000) + S)
    B, D, N = 2, 64, 16
    args = list(_scan_inputs(rng, B, S, D, N))
    args[0] = torch.from_numpy(np.abs(rng.normal(dt_mean, dt_mean / 3,
                                                 (B, S, D))).astype(np.float32))
    _scan_check(SS, [t.to(dev) for t in args])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b"])
def test_lm_prefill_and_serving_on_card_equal_cpu(dev, arch):
    """A narrow model (head width 64, so the flash kernel takes it) served
    on the card through both kernels gives the CPU's prefill logits, caches
    and greedy tokens."""
    from repro_torch.config.base import reduced_config
    from repro_torch.configs import get_arch
    from repro_torch.models import model as MDL
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = reduced_config(get_arch(arch), head_dim=64)
    cpu = MDL.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    card = {k: v.to(dev) for k, v in cpu.items() if k != "layers"}
    card["layers"] = [{k: ({n: t.to(dev) for n, t in v.items()}
                           if isinstance(v, dict) else v.to(dev))
                       for k, v in lp.items()} for lp in cpu["layers"]]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (1, 150)))
    before = dict(build.LAUNCHES)
    got, gc = MDL.prefill_with_caches(cfg, card, toks.to(dev), 192)
    kname = "ssm_scan" if arch.startswith("falcon") else "flash_attention"
    assert build.LAUNCHES[kname] == before[kname] + cfg.n_layers
    want, wc = MDL.prefill_with_caches(cfg, cpu, toks, 192)
    # the largest errors per layer and cache, a digest of each side's
    # results (which side moved when they disagree), and the float32 matmul
    # settings, shown under -s
    def digest(logits, caches):
        h = hashlib.sha256(logits.cpu().numpy().tobytes())
        for c in caches:
            for k in sorted(c):
                h.update(c[k].cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    print(json.dumps({
        "arch": arch, "logits_max_abs_err": float((got.cpu() - want).abs().max()),
        "cache_max_abs_err": [{k: float((a[k].cpu() - b[k]).abs().max())
                               for k in b} for a, b in zip(gc, wc)],
        "card_digest": digest(got, gc), "cpu_digest": digest(want, wc),
        "cpu_threads": torch.get_num_threads(),
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision()}))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for a, b in zip(gc, wc):
        for key in b:
            torch.testing.assert_close(a[key].cpu(), b[key], rtol=1e-4,
                                       atol=1e-4)
    outs = []
    for params, device in ((card, dev), (cpu, "cpu")):
        eng = ServeEngine(cfg, params, n_slots=2, ctx_len=192,
                          use_prefill=True, device=device)
        for i, n in enumerate((150, 40, 7)):
            eng.submit(Request(rid=i, prompt=toks[0, :n].tolist(), max_new=6))
        outs.append([r.out for r in sorted(eng.drain(), key=lambda r: r.rid)])
    assert outs[0] == outs[1]


def _poison_allocator(dev, value: float) -> None:
    """Fill blocks of PyTorch's caching allocator with ``value`` and free
    them, so the next allocations of those sizes start from it instead of
    from whatever the card held."""
    sizes = [1 << k for k in range(8, 23)] * 16 + [1 << 26] * 8
    ts = [torch.full((n,), value, dtype=torch.float32, device=dev)
          for n in sizes]
    torch.cuda.synchronize()
    del ts


@pytest.mark.parametrize("poison", [float("nan"), 1.0e3])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b"])
def test_lm_prefill_on_card_ignores_stale_memory(dev, arch, poison):
    """The card's prefill reads nothing it did not write: with the
    allocator's free blocks filled with NaN or a large value beforehand,
    logits and caches still equal the CPU's, and two card runs are
    bit-identical."""
    from repro_torch.config.base import reduced_config
    from repro_torch.configs import get_arch
    from repro_torch.models import model as MDL

    cfg = reduced_config(get_arch(arch), head_dim=64)
    cpu = MDL.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    card = {k: v.to(dev) for k, v in cpu.items() if k != "layers"}
    card["layers"] = [{k: ({n: t.to(dev) for n, t in v.items()}
                           if isinstance(v, dict) else v.to(dev))
                       for k, v in lp.items()} for lp in cpu["layers"]]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (1, 150)))
    want, wc = MDL.prefill_with_caches(cfg, cpu, toks, 192)
    runs = []
    for _ in range(2):
        _poison_allocator(dev, poison)
        got, gc = MDL.prefill_with_caches(cfg, card, toks.to(dev), 192)
        runs.append((got.cpu(), [{k: c[k].cpu() for k in c} for c in gc]))
    print(json.dumps({"arch": arch, "poison": str(poison),
                      "layer_cache_max_abs_err": [
                          max(float((c[k] - w[k]).abs().max()) for k in w)
                          for c, w in zip(runs[0][1], wc)]}))
    for got, gc in runs:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        for a, b in zip(gc, wc):
            for key in b:
                torch.testing.assert_close(a[key], b[key], rtol=1e-4,
                                           atol=1e-4)
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        for key in a:
            assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("pipeline", [False, True])
def test_query_serve_on_card_equals_cpu(dev, pipeline):
    """``QueryServeEngine`` on the card (the planner thread launching
    ``dp_sweep`` when ``pipeline``) serves the rows of the same engine on
    the CPU, request by request, and answers equal the oracle."""
    from repro_torch.core.federation import build_federated_stats
    from repro_torch.engine.local import naive_evaluate
    from repro_torch.rdf.generator import (fedbench_like_spec,
                                           generate_federation,
                                           generate_workload)
    from repro_torch.serve import QueryServeEngine

    fed, gt = generate_federation(fedbench_like_spec(scale=0.06, seed=3))
    stats = build_federated_stats(fed)
    wave = generate_workload(fed, gt, n_star=4, n_hybrid=4, n_path=2, seed=9)
    wave = wave + wave[:3]
    served = []
    before = build.LAUNCHES["dp_sweep"]
    for device in ("cuda", "cpu"):
        with QueryServeEngine(fed, stats, max_batch=4, pipeline=pipeline,
                              device=device) as eng:
            for q in wave:
                eng.submit(q, deadline=0.0)
            served.append({r.qid: r for r in eng.drain()})
        if device == "cuda":
            assert build.LAUNCHES["dp_sweep"] > before
    for qid, r in served[0].items():
        w = served[1][qid]
        assert list(r.rows) == list(w.rows)
        for v in r.rows:
            assert r.rows[v].tobytes() == w.rows[v].tobytes()
        proj = r.query.effective_projection()
        n = len(next(iter(r.rows.values()))) if r.rows else 0
        got = set(zip(*[r.rows[v].tolist() for v in proj])) if n else set()
        assert got == naive_evaluate(fed, r.query)


def _tiny_fedbench():
    from repro_torch.core.federation import build_federated_stats
    from repro_torch.rdf.generator import (fedbench_like_spec,
                                           generate_federation,
                                           generate_workload)

    fed, gt = generate_federation(fedbench_like_spec(scale=0.06, seed=3))
    wl = (generate_workload(fed, gt, n_star=4, n_hybrid=4, n_path=2, seed=9)
          + generate_workload(fed, gt, n_star=0, n_hybrid=4, n_path=4,
                              seed=33))
    return fed, build_federated_stats(fed), wl


def test_fedx_odyssey_on_card_equals_numpy(dev):
    """The FedX-Odyssey hybrid plans through ``dp_sweep`` on the card by
    default, and its plans equal the numpy backend's node for node."""
    from repro_torch.baselines import FedXOdyssey

    fed, stats, wl = _tiny_fedbench()
    card, ref = FedXOdyssey(stats, fed), FedXOdyssey(stats, fed,
                                                     dp_backend="numpy")
    assert (card.dp_backend, card.device) == ("torch", "cuda")
    before = build.LAUNCHES["dp_sweep"]
    for q in wl:
        a, b = card.optimize(q), ref.optimize(q)
        assert a.root == b.root and a.selection.star_sources == \
            b.selection.star_sources, q.name
    assert build.LAUNCHES["dp_sweep"] > before


@pytest.mark.parametrize("salvage", [True, False])
def test_failover_session_on_card_equals_numpy(dev, salvage):
    """A ``FailoverSession`` with a dead endpoint plans and replans on the
    card by default; every result (rows, metrics, partial, excluded,
    replans, salvages, cache hits, epoch) equals a numpy-backend session's
    under the same faults, and ``restore`` brings complete answers back."""
    from repro_torch.engine.local import naive_evaluate
    from repro_torch.ft.failover import FailoverSession, FlakySource
    from repro_torch.rdf.dataset import Federation

    fed, stats, wl = _tiny_fedbench()
    out = []
    before = build.LAUNCHES["dp_sweep"]
    for dp in ({}, {"dp_backend": "numpy"}):
        srcs = [FlakySource(s, dead=s.name == "DBpedia") for s in fed.sources]
        session = FailoverSession(Federation(srcs, fed.dictionary), stats,
                                  salvage=salvage, **dp)
        res = [session.execute(q) for q in wl]
        res += session.execute_batch(wl)
        srcs[[s.name for s in srcs].index("DBpedia")].dead = False
        session.restore("DBpedia")
        res += session.execute_batch(wl)
        out.append(res)
        if not dp:
            assert session.optimizer.device == "cuda"
            assert build.LAUNCHES["dp_sweep"] > before
    assert any(r.partial for r in out[0])
    for got, want in zip(*out):
        assert list(got.rows) == list(want.rows)
        for v in got.rows:
            assert got.rows[v].tobytes() == want.rows[v].tobytes()
        for f in ("partial", "excluded", "replans", "salvages", "cache_hit",
                  "stats_epoch", "rerouted"):
            assert getattr(got, f) == getattr(want, f), f
        assert (got.metrics.transferred_tuples, got.metrics.requests) == \
            (want.metrics.transferred_tuples, want.metrics.requests)
    for q, r in zip(wl, out[0][-len(wl):]):
        proj = q.effective_projection()
        n = len(next(iter(r.rows.values()))) if r.rows else 0
        got = set(zip(*[r.rows[v].tolist() for v in proj])) if n else set()
        assert not r.partial and got == naive_evaluate(fed, q)


@pytest.mark.parametrize("aware", [False, True])
@pytest.mark.parametrize("which,mesh", [("selftest", (4, 2)), ("tiny", (9, 4))])
def test_spmd_engine_on_card_equals_cpu(dev, which, mesh, aware):
    """The SPMD executor with the whole mesh on the card (its default)
    gives the CPU port's rows (order, dtype) and ``DistMetrics`` per plan,
    and the same skipped plans; the CPU port is held to the reference by
    ``tests/test_torch_distributed.py``."""
    from test_torch_distributed import federation, run_case

    from repro_torch.core.federation import build_federated_stats
    from repro_torch.core.planner import OdysseyOptimizer
    from repro_torch.engine.distributed import (DistributedEngine,
                                                UnsupportedShapeError)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.rdf import generator as G

    fed, queries = federation(G, which, mesh[0])
    opt = OdysseyOptimizer(build_federated_stats(fed), dp_backend="numpy")
    card = DistributedEngine(fed, make_test_mesh(mesh), cap=4096,
                             partition_aware=aware)
    assert card.tables.is_cuda and card.trow.is_cuda
    cpu = DistributedEngine(fed, make_test_mesh(mesh, device="cpu"), cap=4096,
                            partition_aware=aware)
    (got_meta, got), (want_meta, want) = (
        run_case(queries, opt, eng, UnsupportedShapeError) for eng in (card, cpu))
    assert got_meta == want_meta
    assert any("metrics" in e and e["metrics"][0] > 0 for e in got_meta.values())
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_spmd_readback_copies_the_selected_rows_on_card(dev, tmp_path):
    """On the card the read-back copies the rows the select kept and its
    count, no more: per plan ``readback_bytes`` is the kept rows' int32
    bytes (before DISTINCT) plus ``NONZERO_COUNT_BYTES`` and ``host_syncs``
    the plan's reads + 2; and the device-to-host copies a profiler records
    over every plan add up to that, one byte per star's overflow flag and
    eight per join's flag and shipped count."""
    import dataclasses

    from test_torch_distributed import federation, plan_reads_and_columns
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.federation import build_federated_stats
    from repro_torch.core.planner import OdysseyOptimizer
    from repro_torch.engine.distributed import (NONZERO_COUNT_BYTES, DistributedEngine,
                                                UnsupportedShapeError)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.rdf import generator as G

    fed, queries = federation(G, "selftest", 4)
    opt = OdysseyOptimizer(build_federated_stats(fed), dp_backend="numpy")
    eng = DistributedEngine(fed, make_test_mesh((4, 2)), cap=4096, partition_aware=True)
    plans, want_bytes = [], 0
    for q in queries:
        plan = opt.optimize(q)
        if plan.fallback:
            continue
        try:
            met = eng.execute(plan).metrics
        except UnsupportedShapeError:
            continue
        reads, ncols = plan_reads_and_columns(plan.root)
        kept = eng.execute(dataclasses.replace(
            plan, query=dataclasses.replace(plan.query, distinct=False))).metrics
        assert met.host_syncs == reads + 2, q.name
        assert met.readback_slots == 4 * 2 * 4096
        assert met.readback_bytes == 4 * ncols * kept.answer_rows + NONZERO_COUNT_BYTES
        plans.append(plan)
        want_bytes += (reads + 1) // 2 + 8 * ((reads - 1) // 2) + met.readback_bytes
    assert len(plans) >= 6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for plan in plans:
            eng.execute(plan)
        torch.cuda.synchronize()
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    copies = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    assert sum(e["args"]["bytes"] for e in copies) == want_bytes


@pytest.mark.parametrize("seed", [0, 1])
def test_ranged_scan_equals_full_scan_on_card(dev, seed):
    """The star scan over a pattern's predicate rows (``PredicateIndex``)
    equals ``scan_pattern`` over every slot on the card, in ``data``,
    ``valid`` and ``overflow``: every case of
    ``tests/test_torch_predicate_scan.py``, then on 16 shards of 65,536
    slots at ``cap``s that some, none or all of the selected shards
    overflow."""
    from test_torch_predicate_scan import (SCANS, assert_same_relation, both_scans,
                                           random_shards, selected)

    table, trow = random_shards(seed)
    for name, pattern, which, cap in SCANS:
        got, _, want = both_scans(table, trow, pattern, selected(which, *trow.shape[:2]),
                                  cap, dev)
        assert got[0].is_cuda and want[0].is_cuda
        assert_same_relation(got, want)
    table, trow = random_shards(seed, d=4, m=4, n=1 << 16)
    overflowed = []
    for pattern, which, cap in (((-1, 11, -1), "not-1", 13_110),
                                ((-1, 11, -1), "not-1", 1 << 15),
                                ((2, 12, -1), "all", 3_280),
                                ((-1, 14, 1), "all", 4096)):
        got, slots, want = both_scans(table, trow, pattern, selected(which, 4, 4),
                                      cap, dev)
        assert_same_relation(got, want)
        assert 0 < slots < table[..., 0].size
        overflowed.append(int(want[2].sum()))
    assert 0 < overflowed[0] < 12 and overflowed[1] == 0 and overflowed[3] == 4


# --------------------------------------------------------------------------
# LM training: the backward kernels of flash attention and the scan
# --------------------------------------------------------------------------

def _bwd_close(got, want, tol):
    """``|got - want| <= tol * max(1, max|want|)`` everywhere, and finite."""
    got, want = got.float(), want.float()
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 129, 2, 2, 64),     # GQA 1
                                         (2, 200, 4, 2, 128),    # GQA 2
                                         (1, 77, 14, 2, 64),     # GQA 7
                                         (1, 63, 2, 1, 256),
                                         (1, 300, 7, 1, 64),
                                         (4, 512, 14, 2, 64),    # qwen2's step
                                         # the edges of the 64-key and
                                         # 128-query tiles
                                         (1, 1, 2, 1, 64),
                                         (2, 63, 4, 2, 64),
                                         (1, 65, 4, 4, 128),
                                         (1, 129, 2, 1, 256),
                                         # GQA 7, the group sum over four
                                         # batch rows
                                         (4, 97, 14, 2, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100), (False, 0),
                                           (False, 64),
                                           (True, 37)])  # ends inside a tile
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_equals_plain(dev, B, S, H, KV, hd, causal,
                                                 window, dtype):
    """``flash_attention_bwd`` against autograd through the plain version,
    and two launches bit-identical; the forward's ``lse`` against the plain
    log-sum-exp."""
    from repro_torch.kernels import flash_attention as FA

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S + hd + H)
    q, k, v = (t.to(dev) for t in _qkv(rng, B, S, H, KV, hd, dt))
    dout = torch.from_numpy(rng.normal(size=(B, S, H, hd)).astype(
        np.float32)).to(dev, dt)
    kw = dict(causal=causal, window=window)
    out, lse = FA.flash_attention_fwd(q, k, v, **kw)
    before = build.LAUNCHES["flash_attention_bwd"]
    got = FA.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    again = FA.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert build.LAUNCHES["flash_attention_bwd"] == before + 2
    want = FA.flash_attention_bwd_plain(q, k, v, dout, **kw)
    _, lse0 = FA.flash_attention_lse_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == "float32" else 2e-2
    _bwd_close(lse, lse0, tol)
    for g, a, w, t in zip(got, again, want, (q, k, v)):
        assert g.dtype == dt and g.shape == t.shape
        assert torch.equal(g, a)
        _bwd_close(g, w, tol)


@pytest.mark.parametrize("B,S,D,N", [(1, 1, 40, 16), (1, 33, 7, 16),
                                     (2, 100, 301, 16), (1, 65, 33, 32),
                                     (3, 37, 5, 17), (2, 5, 7, 0),
                                     (1, 512, 8192, 16),
                                     # the prefetch across a partial last
                                     # chunk, at 4 and 8 states a thread
                                     (2, 97, 40, 16), (1, 97, 300, 17)])
@pytest.mark.parametrize("with_dh", [False, True])
def test_ssm_scan_bwd_kernel_equals_plain(dev, B, S, D, N, with_dh):
    """``ssm_scan_bwd`` (from the forward's chunk states, ``d h_last`` zero
    or given) against autograd through the plain version, and two launches
    bit-identical."""
    from repro_torch.kernels import ssm_scan as SS

    rng = np.random.default_rng(S + D + N)
    args = [t.to(dev) for t in _scan_inputs(rng, B, S, D, N)]
    dy = torch.from_numpy(rng.normal(size=(B, S, D)).astype(np.float32)).to(dev)
    dh = (torch.from_numpy(rng.normal(size=(B, D, N)).astype(np.float32))
          .to(dev) if with_dh else None)
    y, h_last, hc = SS.ssm_scan_fwd(*args)
    y0, h0, hc0 = SS.ssm_scan_chunks_plain(*args)
    _bwd_close(y, y0, 2e-4)
    _bwd_close(hc, hc0, 2e-4)
    if S:
        _bwd_close(hc[:, -1], h_last, 0.0)
    before = build.LAUNCHES["ssm_scan_bwd"]
    got = SS.ssm_scan_bwd(*args, hc, dy, dh)
    again = SS.ssm_scan_bwd(*args, hc, dy, dh)
    assert build.LAUNCHES["ssm_scan_bwd"] == before + (2 if N and S else 0)
    want = SS.ssm_scan_bwd_plain(*args, dy, dh)
    torch.cuda.synchronize()
    for g, a, w, t in zip(got, again, want, args):
        assert g.shape == t.shape
        assert torch.equal(g, a)
        _bwd_close(g, w, 2e-4)


def test_lm_kernel_outputs_carry_grad_fn_on_card(dev):
    """F3 (ROADMAP queue 3): on the card an output of either wrapper has a
    ``grad_fn`` (the kernels' autograd Functions) when an input requires a
    gradient, and the gradient reaches every input."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS

    q, k, v = (t.to(dev).requires_grad_()
               for t in _qkv(np.random.default_rng(0), 1, 64, 4, 2, 64,
                             torch.float32))
    out = ops.flash_attention_gqa(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.square().sum().backward()
    assert all(t.grad is not None and float(t.grad.abs().sum()) > 0
               for t in (q, k, v))
    args = [t.to(dev).requires_grad_() for t in _scan_inputs(
        np.random.default_rng(1), 1, 40, 64, 16)]
    y, h = ops.selective_scan(*args)
    assert type(y.grad_fn).__name__ == "SSMScanFnBackward"
    y.square().sum().backward()
    assert all(t.grad is not None and float(t.grad.abs().sum()) > 0
               for t in args)
    with torch.no_grad():       # serving: no Function, no chunk states
        assert FA.flash_attention(q, k, v).grad_fn is None
        assert SS.ssm_scan(*args)[0].grad_fn is None


def _train_cfg(arch):
    from repro_torch.config.base import reduced_config
    from repro_torch.configs import get_arch

    return reduced_config(get_arch(arch), head_dim=64, n_layers=3)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b"])
def test_train_step_on_card_equals_cpu(dev, arch):
    """Two train steps (AdamW, two microbatches, compression, remat) on the
    card give the CPU port's params and metrics within 1e-4; every
    parameter gets a gradient through the kernels (F3), and the launches
    are what remat predicts: two forwards and one backward per layer and
    microbatch.  AdamW's ``eps`` is 1 so that its update is smooth in the
    gradient: with a tiny ``eps`` the first update is ``lr * sign(g)``, and
    an int8 rounding that the two devices' float32 sums split (0 against
    one quantization step) would move an element by ``lr``."""
    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.data.loader import TokenLoader
    from repro_torch.models import model as MDL
    from repro_torch.train.grad_compress import init_error_feedback
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import loss_and_grads, make_train_step

    cfg = _train_cfg(arch)
    cpu = MDL.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    card = tree_map(lambda t: t.clone().to(dev), cpu)
    loader = TokenLoader(vocab=cfg.vocab, batch=4, seq=96, seed=2)
    kname = "ssm_scan" if arch.startswith("falcon") else "flash_attention"
    _, _, _, grads = loss_and_grads(cfg, card, {
        k: torch.from_numpy(v).long().to(dev)
        for k, v in loader.batch_at(0).items()})
    assert all(g is not None and float(g.abs().max()) > 0
               for g in leaves(grads))
    out = []
    for params, where in ((card, dev), (cpu, "cpu")):
        opt = adamw(lr=1e-3, eps=1.0)
        step = make_train_step(cfg, opt, microbatches=2, compress=True)
        state, efb = opt.init(params), init_error_feedback(params)
        before = dict(build.LAUNCHES)
        for s in range(2):
            batch = {k: torch.from_numpy(v).long().to(where)
                     for k, v in loader.batch_at(s).items()}
            params, state, metrics, efb = step(params, state, batch, efb)
        if where == dev:
            assert build.LAUNCHES[kname] - before[kname] == \
                2 * 2 * 2 * cfg.n_layers
            assert build.LAUNCHES[kname + "_bwd"] - before[kname + "_bwd"] \
                == 2 * 2 * cfg.n_layers
        out.append((leaves(params), {k: float(v) for k, v in metrics.items()}))
    (pc, mc), (pp, mp) = out
    for k in mp:
        assert abs(mc[k] - mp[k]) <= 1e-4 * max(1.0, abs(mp[k])), k
    for a, b in zip(pc, pp):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


# the rest of the zoo at reduced width (head width 64, so the flash kernel
# takes it); the int8 KV cache on qwen2
ZOO = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "jamba-1.5-large-398b",
       "chameleon-34b", "qwen2-0.5b-int8", "whisper-tiny"]


def _zoo_cfg(name):
    import dataclasses

    from repro_torch.config.base import PerfFlags, reduced_config
    from repro_torch.configs import get_arch

    cfg = reduced_config(get_arch(name.removesuffix("-int8")), head_dim=64)
    if name.endswith("-int8"):
        cfg = dataclasses.replace(cfg, perf=PerfFlags(kv_quant_int8=True))
    return cfg


def _zoo_params(name, dev):
    from repro_torch.common.tree import tree_map
    from repro_torch.models import model as MDL

    cfg = _zoo_cfg(name)
    cpu = MDL.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    return cfg, cpu, tree_map(lambda t: t.to(dev), cpu)


def _kernel_layers(cfg) -> dict:
    """Launches one full-sequence pass makes: one flash launch per attention
    layer (and, for enc-dec, per encoder layer), one scan launch per Mamba
    layer; MLA attends without the flash kernel."""
    mamba = sum(cfg.mixer_of(i) == "m" for i in range(cfg.n_layers))
    attn = 0 if cfg.mla is not None else cfg.n_layers - mamba
    return {"flash_attention": attn + (cfg.enc_layers if cfg.encdec else 0),
            "ssm_scan": mamba}


def _launched(before) -> dict:
    return {k: build.LAUNCHES[k] - before[k]
            for k in ("flash_attention", "ssm_scan")}


@pytest.mark.parametrize("name", ZOO)
def test_zoo_prefill_and_serving_on_card_equal_cpu(dev, name):
    """Each new family on the card against the CPU port on the same
    weights: prefill logits and every cache within 1e-4 (enc-dec: the
    forward with ``frames``; the VLM: also the forward with
    ``patch_embeds``), the kernels launched once per layer of their kind,
    and the greedy tokens of ``ServeEngine`` (prefill admission, enc-dec
    token by token) equal."""
    from repro_torch.models import model as MDL
    from repro_torch.serve.engine import Request, ServeEngine

    cfg, cpu, card = _zoo_params(name, dev)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (1, 150)))
    want_launches = _kernel_layers(cfg)
    if cfg.encdec or cfg.vlm_prefix:
        batch = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab, (2, 96)))}
        if cfg.encdec:
            batch["frames"] = torch.from_numpy(rng.normal(
                size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        else:
            batch["patch_embeds"] = torch.from_numpy(rng.normal(
                size=(2, cfg.vlm_prefix, cfg.d_model)).astype(np.float32))
        before = dict(build.LAUNCHES)
        with torch.no_grad():
            got, gaux = MDL.forward(cfg, card, {k: v.to(dev)
                                                for k, v in batch.items()})
            want, waux = MDL.forward(cfg, cpu, batch)
        assert _launched(before) == want_launches
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    if not cfg.encdec:
        before = dict(build.LAUNCHES)
        got, gc = MDL.prefill_with_caches(cfg, card, toks.to(dev), 192)
        assert _launched(before) == want_launches
        want, wc = MDL.prefill_with_caches(cfg, cpu, toks, 192)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        for a, b in zip(gc, wc):
            for key in b:
                assert a[key].dtype == b[key].dtype
                if b[key].dtype == torch.int8:      # a rounding flip at most
                    assert int((a[key].cpu().int() - b[key].int()).abs()
                               .max()) <= 1
                else:
                    torch.testing.assert_close(a[key].cpu(), b[key],
                                               rtol=1e-4, atol=1e-4)
    outs = []
    for params, device in ((card, dev), (cpu, "cpu")):
        eng = ServeEngine(cfg, params, n_slots=2, ctx_len=192,
                          use_prefill=True, device=device)
        for i, n in enumerate((150, 40, 7)):
            eng.submit(Request(rid=i, prompt=toks[0, :n].tolist(), max_new=6))
        outs.append([r.out for r in sorted(eng.drain(), key=lambda r: r.rid)])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"])
def test_moe_prefill_on_card_is_bitwise_repeatable(dev, name):
    """Two identical MoE prefills on the card give the same bits: the
    combine sums each token's experts in a fixed order, without atomics."""
    from repro_torch.models import model as MDL

    cfg, _, card = _zoo_params(name, dev)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (1, 300))).to(dev)
    runs = [MDL.prefill_with_caches(cfg, card, toks, 320) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    x = torch.randn((2, 150, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    from repro_torch.models import moe as MOE

    lp = card["layers"][-1]["ffn"]
    a, aux_a = MOE.moe_ffn(lp, cfg, x)
    b, aux_b = MOE.moe_ffn(lp, cfg, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"])
def test_moe_gradients_on_card_reach_every_leaf(dev, name):
    """F3's lesson for the new families: on the card every leaf gets a
    nonzero gradient (router, experts, shared experts, MLA projections and
    norms, the dense prelude layer), within 1e-4 of the CPU's."""
    from repro_torch.common.tree import leaves, named_leaves
    from repro_torch.data.loader import TokenLoader
    from repro_torch.train.train_step import loss_and_grads

    cfg, cpu, card = _zoo_params(name, dev)
    batch = TokenLoader(vocab=cfg.vocab, batch=2, seq=96, seed=5).batch_at(0)
    outs = []
    for params, where in ((card, dev), (cpu, "cpu")):
        _, _, aux, grads = loss_and_grads(cfg, params, {
            k: torch.from_numpy(v).long().to(where) for k, v in batch.items()})
        outs.append(grads)
        assert float(aux) > 0
    for path, g in named_leaves(outs[0]):
        assert g is not None and float(g.abs().max()) > 0, path
    for a, b in zip(leaves(outs[0]), leaves(outs[1])):
        tol = 1e-4 * max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)


def test_kernel_operators_launch_on_card(dev):
    """The kernels' ``torch.library`` operators (the route the dry-run
    books) launch the kernel on CUDA tensors, one launch a call, equal to
    the wrappers; with gradients on, the wrappers still go through the
    autograd Functions and their backward operators launch the backward
    kernels."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS

    q, k, v = (t.to(dev) for t in _qkv(np.random.default_rng(2), 1, 96, 4,
                                        2, 64, torch.float32))
    build.reset_launches()
    out = torch.ops.repro_torch.flash_attention(q, k, v, True, 0, 64 ** -0.5)
    out2, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, True, 0,
                                                          64 ** -0.5)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 2
    assert torch.equal(out, FA.flash_attention(q, k, v))
    torch.testing.assert_close(out2, out, rtol=0, atol=1e-6)
    assert lse.shape == (1, 4, 96)
    args = [t.to(dev) for t in _scan_inputs(np.random.default_rng(3), 1, 40,
                                            64, 16)]
    y, h = torch.ops.repro_torch.ssm_scan(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ssm_scan"] == 1
    y0, h0 = SS.ssm_scan(*args)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    build.reset_launches()
    q.requires_grad_()
    out = FA.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.sum().backward()
    args[0].requires_grad_()
    y, _ = SS.ssm_scan(*args)
    assert type(y.grad_fn).__name__ == "SSMScanFnBackward"
    y.sum().backward()
    torch.cuda.synchronize()
    assert {k: build.LAUNCHES[k] for k in ("flash_attention",
                                           "flash_attention_bwd", "ssm_scan",
                                           "ssm_scan_bwd")} == \
        {"flash_attention": 1, "flash_attention_bwd": 1, "ssm_scan": 1,
         "ssm_scan_bwd": 1}
    assert q.grad is not None and args[0].grad is not None
