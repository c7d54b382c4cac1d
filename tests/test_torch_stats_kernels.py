"""The port's statistics kernels (their plain versions, on the CPU), its
``kernels/ops`` entry points and its device CS function, held against the
reference package: the Pallas wrappers of ``repro.kernels.ops`` (interpret
mode), the oracles of ``repro.kernels.ref``, ``compute_characteristic_sets_jnp``
under x64, and Algorithm 1's federated CP counts of both packages'
``build_federated_stats``.  Every comparison is exact: the four functions
are integer or exact counts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                            # noqa: E402
import jax.numpy as jnp                               # noqa: E402

from repro.core import federation as ref_fed          # noqa: E402
from repro.core.characteristic_sets import compute_characteristic_sets_jnp  # noqa: E402
from repro.kernels import ops as ref_ops              # noqa: E402
from repro.kernels import ref                         # noqa: E402
from repro.rdf import generator as ref_gen            # noqa: E402
from repro_torch.common.hashing import splitmix64     # noqa: E402
from repro_torch.core.characteristic_pairs import CPStats  # noqa: E402
from repro_torch.core.characteristic_sets import (    # noqa: E402
    compute_characteristic_sets, compute_characteristic_sets_torch)
from repro_torch.core.federation import (             # noqa: E402
    build_federated_stats, candidate_export_pairs, compute_federated_cps,
    compute_federated_cps_ops)
from repro_torch.core.summaries import candidate_cs_pairs  # noqa: E402
from repro_torch.kernels import join_count as JC      # noqa: E402
from repro_torch.kernels import ops                   # noqa: E402
from repro_torch.kernels import seg_bitmap as SB      # noqa: E402
from repro_torch.kernels import sorted_intersect as SI  # noqa: E402
from repro_torch.kernels import summary_probe as SP   # noqa: E402
from repro_torch.rdf.generator import fedbench_like_spec, generate_federation  # noqa: E402

SCALE = 0.05


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


def _lists(case: str):
    """(a, aw, b, bw): ``b`` sorted ascending; ``a`` is also ``join_count``'s
    probe and ``b`` its build side."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "ragged":
        return (np.sort(rng.choice(900, 301, replace=False)),
                rng.integers(1, 60, 301), np.sort(rng.integers(0, 900, 517)),
                rng.integers(1, 60, 517))
    if case == "ties":
        return ([5, 5, 7, 7, 7, 9, 2], [1, 2, 3, 4, 5, 6, 7],
                [2, 5, 5, 5, 7, 8, 9, 9], [1, 1, 2, 3, 5, 8, 13, 21])
    if case == "unsorted_negative":
        return (rng.permutation(200) - 50, rng.integers(-9, 9, 200),
                np.sort(rng.integers(-40, 160, 260)), rng.integers(-9, 9, 260))
    if case == "wraps":
        return (np.zeros(300), np.full(300, 2**30 + 7), np.zeros(257),
                np.full(257, 2**29 + 3))
    if case == "disjoint":
        return np.arange(0, 100, 2), np.ones(50), np.arange(1, 101, 2), np.ones(50)
    if case == "single":
        return [3], [2], [3], [5]
    if case == "empty_a":
        return [], [], [1, 2, 3], [1, 1, 1]
    if case == "empty_b":
        return [1, 2, 3], [1, 1, 1], [], []
    raise KeyError(case)


LIST_CASES = ["ragged", "ties", "unsorted_negative", "wraps", "disjoint",
              "single", "empty_a", "empty_b"]


def _nonempty(*xs) -> bool:
    return all(len(x) for x in xs)


@pytest.mark.parametrize("case", LIST_CASES)
def test_sorted_intersect_plain_matches_reference(case):
    a, aw, b, bw = (np.asarray(x, np.int32) for x in _lists(case))
    got = SI.sorted_intersect(_t(a), _t(aw), _t(b), _t(bw))
    assert got.dtype == torch.int32 and got.shape == ()
    oracle = ref.sorted_intersect_weighted_ref(jnp.asarray(a), jnp.asarray(aw),
                                               jnp.asarray(b), jnp.asarray(bw))
    assert int(got) == int(oracle)
    if _nonempty(a, b):                     # the Pallas grid needs a block
        assert int(got) == ref_ops.intersect_count(a, aw, b, bw)


@pytest.mark.parametrize("case", LIST_CASES)
def test_join_count_plain_matches_reference(case):
    p, _, b, bw = (np.asarray(x, np.int32) for x in _lists(case))
    got = JC.join_count(_t(p), _t(b), _t(bw))
    assert got.dtype == torch.int32 and got.shape == (len(p),)
    oracle = np.asarray(ref.join_count_ref(jnp.asarray(p), jnp.asarray(b),
                                           jnp.asarray(bw)))
    np.testing.assert_array_equal(got.numpy(), oracle)
    if _nonempty(p, b):
        np.testing.assert_array_equal(got.numpy(),
                                      ref_ops.match_counts(p, b, bw))


def _seg_rows(case: str):
    rng = np.random.default_rng(len(case))
    if case == "sorted_with_padding":
        seg = np.sort(rng.integers(0, 300, 1000))
        seg[rng.random(1000) < 0.3] = -1
        return seg, rng.integers(0, 128, 1000), 300
    if case == "out_of_plane":       # segments >= n_seg, buckets outside [0, 128)
        return rng.integers(-3, 45, 700), rng.integers(-2, 131, 700), 37
    if case == "one_cell":
        return np.zeros(600), np.full(600, 7), 1
    if case == "single_row":
        return [4], [127], 5
    if case == "interspersed_pads":  # the statistics path's layout
        seg = np.sort(rng.integers(0, 300, 2000))
        seg[rng.random(2000) < 0.3] = -1
        return seg, rng.integers(0, 128, 2000), 300
    if case == "gaps":               # missing segments at start, middle, end
        seg = np.sort(np.concatenate([rng.integers(40, 90, 500),
                                      rng.integers(150, 200, 400)]))
        seg[rng.random(900) < 0.3] = -1
        return seg, rng.integers(0, 128, 900), 260
    if case == "long_segment":       # one segment of 5,000 rows
        seg = np.sort(np.concatenate([rng.integers(0, 40, 600),
                                      np.full(5000, 17)]))
        seg[rng.random(5600) < 0.2] = -1
        return seg, rng.integers(0, 128, 5600), 40
    raise KeyError(case)


SEG_CASES = ["sorted_with_padding", "out_of_plane", "one_cell", "single_row",
             "interspersed_pads", "gaps", "long_segment"]


@pytest.mark.parametrize("case", SEG_CASES)
def test_seg_bitmap_plain_matches_reference(case):
    seg, bucket, n_seg = _seg_rows(case)
    seg, bucket = np.asarray(seg, np.int32), np.asarray(bucket, np.int32)
    got = SB.seg_bitmap(_t(seg), _t(bucket), n_seg)
    assert got.dtype == torch.float32 and got.shape == (n_seg, 128)
    oracle = np.asarray(ref.seg_bitmap_ref(jnp.asarray(seg), jnp.asarray(bucket),
                                           n_seg))
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(got.numpy() > 0,
                                  ref_ops.predicate_bitmaps(seg, bucket, n_seg))


def test_seg_bitmap_path_on_the_cpu_is_the_plain_version():
    seg, bucket, n_seg = _seg_rows("interspersed_pads")
    ts, tk = _t(seg), _t(bucket)
    got, path = SB.seg_bitmap_path(ts, tk, n_seg)
    assert path is None
    assert torch.equal(got, SB.seg_bitmap_plain(ts, tk, n_seg))


@pytest.mark.parametrize("na,nb,sms,form", [
    (8, 40, 132, "warp"), (300, 200, 132, "warp"), (352, 384, 132, "tiled"),
    (1000, 600, 132, "tiled"), (1, 1, 1, "tiled"), (33, 33, 5, "warp")])
def test_summary_probe_form_threshold(na, nb, sms, form):
    """The warp form below one 32 x 32 output tile per SM: 352 x 384 makes
    11 x 12 = 132 tiles, so it tiles on the H100's 132 SMs."""
    assert SP.form(na, nb, sms) == form


def test_seg_bitmap_plain_empty_rows_and_plane():
    z = torch.zeros(0, dtype=torch.int32)
    assert torch.equal(SB.seg_bitmap(z, z, 3), torch.zeros((3, 128)))
    got = SB.seg_bitmap(_t([0, 1]), _t([3, 4]), 0)
    assert got.shape == (0, 128)


SIG_SHAPES = [(37, 50, 256), (1, 1, 1), (33, 65, 31), (5, 3, 8)]


@pytest.mark.parametrize("na,nb,w", SIG_SHAPES)
def test_summary_probe_plain_matches_reference(na, nb, w):
    rng = np.random.default_rng(na * 100 + nb + w)
    a = rng.integers(-2**31, 2**31, (na, w)).astype(np.int32)
    b = rng.integers(-2**31, 2**31, (nb, w)).astype(np.int32)
    a[0] &= rng.integers(-2**31, 2**31, w).astype(np.int32)   # sparser rows
    got = SP.summary_probe(_t(a), _t(b))
    assert got.dtype == torch.int32 and got.shape == (na, nb)
    oracle = np.asarray(ref.summary_probe_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), oracle)
    if w % 2 == 0:                       # the host layout: uint64 words
        a64, b64 = a.view(np.uint64), b.view(np.uint64)
        np.testing.assert_array_equal(got.numpy(),
                                      ref_ops.signature_overlap(a64, b64))


def test_popcount32_edges():
    v = torch.tensor([0, -1, -2**31, 2**31 - 1, 1, 0x55555555], dtype=torch.int32)
    assert SP.popcount32(v).tolist() == [0, 32, 1, 31, 1, 16]


def test_wrappers_raise_off_the_cpu_and_on_bad_arguments():
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        SI.sorted_intersect(meta, meta, meta, meta)
    with pytest.raises(ValueError):
        JC.join_count(meta, meta, meta)
    with pytest.raises(ValueError):
        SB.seg_bitmap(meta, meta, 2)
    with pytest.raises(ValueError):
        SP.summary_probe(meta.view(2, 2), meta.view(2, 2))
    x = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        JC.join_count(x, x, x)
    with pytest.raises(ValueError):
        SP.summary_probe(torch.zeros((2, 3), dtype=torch.int32),
                         torch.zeros((2, 4), dtype=torch.int32))


@pytest.mark.parametrize("entry", ["intersect_count", "match_counts",
                                   "predicate_bitmaps", "signature_overlap"])
def test_ops_cpu_match_reference_ops(entry):
    rng = np.random.default_rng(7)
    if entry in ("intersect_count", "match_counts"):
        for case in ("ragged", "ties", "wraps", "unsorted_negative"):
            a, aw, b, bw = (np.asarray(x, np.int64) for x in _lists(case))
            if entry == "intersect_count":
                got = ops.intersect_count(a, aw, b, bw, device="cpu")
                assert isinstance(got, int)
                assert got == ref_ops.intersect_count(a, aw, b, bw)
            else:
                got = ops.match_counts(a, b, bw, device="cpu")
                assert isinstance(got, np.ndarray) and got.dtype == np.int32
                np.testing.assert_array_equal(got, ref_ops.match_counts(a, b, bw))
    elif entry == "predicate_bitmaps":
        for case in SEG_CASES:
            seg, bucket, n_seg = _seg_rows(case)
            got = ops.predicate_bitmaps(seg, bucket, n_seg, device="cpu")
            assert got.dtype == bool
            np.testing.assert_array_equal(
                got, ref_ops.predicate_bitmaps(seg, bucket, n_seg))
    else:
        a = rng.integers(0, 2**63, (20, 16), dtype=np.uint64)
        b = rng.integers(0, 2**63, (9, 16), dtype=np.uint64)
        a[2] |= np.uint64(1 << 63)
        got = ops.signature_overlap(a, b, device="cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref_ops.signature_overlap(a, b))


def test_ops_empty_inputs():
    """Zero-length lists and zero signature rows, where the reference's
    Pallas grid and its ``_u64_to_i32`` reshape fail."""
    z = np.zeros(0, np.int32)
    assert ops.intersect_count(z, z, [1, 2], [1, 1], device="cpu") == 0
    assert ops.match_counts(z, [1, 2], [1, 1], device="cpu").shape == (0,)
    assert ops.predicate_bitmaps(z, z, 4, device="cpu").shape == (4, 128)
    sig = np.zeros((3, 4), np.uint64)
    assert ops.signature_overlap(sig[:0], sig, device="cpu").shape == (0, 3)
    assert ops.signature_overlap(sig, sig[:0], device="cpu").shape == (3, 0)


def test_ops_take_tensors_in_place():
    a, aw, b, bw = (torch.tensor(x, dtype=torch.int32) for x in _lists("ties"))
    assert ops.intersect_count(a, aw, b, bw, device="cpu") == int(
        SI.sorted_intersect_plain(a, aw, b, bw))
    assert ops._i32(a, "cpu") is a


@pytest.fixture(scope="module")
def small_federation():
    fed, _ = generate_federation(fedbench_like_spec(scale=SCALE))
    return fed, build_federated_stats(fed)


@pytest.fixture(scope="module")
def fed_cps_ops(small_federation):
    _, stats = small_federation
    return compute_federated_cps_ops(stats.exports, stats.summaries, device="cpu")


def test_signature_overlap_on_real_summaries(small_federation, fed_cps_ops):
    """The probe of ``compute_federated_cps_ops``: its candidates are
    ``candidate_cs_pairs``'s, and each of its blocks equals the reference's
    ``signature_overlap``."""
    fed, stats = small_federation
    n = len(fed.sources)
    assert set(fed_cps_ops) == {(i, j) for i in range(n) for j in range(n) if i != j}
    blocks = 0
    for (i, j), res in fed_cps_ops.items():
        so, ss = stats.summaries[i], stats.summaries[j]
        np.testing.assert_array_equal(res.candidates, candidate_cs_pairs(so, ss))
        for orows, srows in res.blocks:
            np.testing.assert_array_equal(
                ops.signature_overlap(so.obj_sig[orows], ss.subj_sig[srows],
                                      device="cpu"),
                ref_ops.signature_overlap(so.obj_sig[orows], ss.subj_sig[srows]))
            blocks += 1
    assert blocks > 0


def test_federated_cps_ops_visit_the_host_pairs(small_federation, fed_cps_ops):
    """Same export pairs, in the same order, and the same exact-check and
    possible-pair counts as the host's Algorithm 1."""
    _, stats = small_federation
    for (i, j), res in fed_cps_ops.items():
        args = (stats.exports[i], stats.exports[j], stats.summaries[i],
                stats.summaries[j])
        assert res.pairs == candidate_export_pairs(*args)
        host = compute_federated_cps(*args)
        assert (res.n_checked_pairs, res.n_possible_pairs) == (
            host.n_checked_pairs, host.n_possible_pairs)
        assert res.n_checked_pairs == stats._pair_pruning[(i, j)][0]


def _cs_inputs(kind: str):
    if kind == "random_unsorted":
        rng = np.random.default_rng(11)
        return (rng.integers(0, 120, 3000).astype(np.int32),
                rng.integers(0, 50, 3000).astype(np.int32))
    fed, _ = generate_federation(fedbench_like_spec(scale=SCALE))
    tab = fed.sources[int(kind)].table
    return tab.s, tab.p


@pytest.mark.parametrize("kind", ["random_unsorted", "0", "3"])
def test_device_cs_matches_jnp_reference_under_x64(kind):
    s, p = _cs_inputs(kind)
    got = compute_characteristic_sets_torch(s, p, device="cpu")
    with jax.enable_x64(True):
        want = compute_characteristic_sets_jnp(jnp.asarray(s), jnp.asarray(p))
        want = [np.asarray(w) for w in want]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        g = g.numpy()
        if w.dtype == np.uint64:         # sig_sum and ph: uint64 bit patterns
            g = g.view(np.uint64)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("src", [0, 3, 6])
def test_device_cs_matches_numpy_cs(small_federation, src):
    fed, stats = small_federation
    tab = fed.sources[src].table
    cs = compute_characteristic_sets(tab)
    subj_ids, sig_sum, deg, subj_seg, _ = compute_characteristic_sets_torch(
        tab.s, tab.p, device="cpu")
    n_subj = int(subj_seg[-1]) + 1
    assert n_subj == len(cs.ent_ids)
    sizes = np.diff(cs.indptr)
    owner = np.repeat(np.arange(cs.n_cs), sizes)
    with np.errstate(over="ignore"):
        cs_sig = np.zeros(cs.n_cs, np.uint64)
        np.add.at(cs_sig, owner, splitmix64(cs.pred_ids.astype(np.uint64)))
    np.testing.assert_array_equal(subj_ids[:n_subj].numpy(), cs.ent_ids)
    np.testing.assert_array_equal(deg[:n_subj].numpy(), sizes[cs.ent_cs])
    np.testing.assert_array_equal(sig_sum[:n_subj].numpy().view(np.uint64),
                                  cs_sig[cs.ent_cs])
    assert not subj_ids[n_subj:].any() and not deg[n_subj:].any()
    # predicate bitmaps of the unique (s, p) rows, bucket p % 128
    s_t, p_t = torch.from_numpy(tab.s), torch.from_numpy(tab.p)
    new_sp = torch.cat([torch.ones(1, dtype=torch.bool),
                        (s_t[1:] != s_t[:-1]) | (p_t[1:] != p_t[:-1])])
    bm = ops.predicate_bitmaps(torch.where(new_sp, subj_seg, -1), p_t % 128,
                               n_subj, device="cpu")
    cs_bm = np.zeros((cs.n_cs, 128), bool)
    cs_bm[owner, cs.pred_ids % 128] = True
    np.testing.assert_array_equal(bm, cs_bm[cs.ent_cs])


def test_device_cs_empty():
    out = compute_characteristic_sets_torch(np.zeros(0, np.int32),
                                            np.zeros(0, np.int32), device="cpu")
    assert all(t.shape == (0,) for t in out)


def test_algorithm1_through_ops_matches_both_builds(small_federation, fed_cps_ops):
    """The stats slice as a whole: Algorithm 1's exact intersections through
    the port's ``intersect_count`` and ``match_counts`` rebuild the federated
    CP counts of the port's and the reference's ``build_federated_stats``."""
    _, stats = small_federation
    ref_fed_, _ = ref_gen.generate_federation(ref_gen.fedbench_like_spec(scale=SCALE))
    ref_stats = ref_fed.build_federated_stats(ref_fed_)
    for (i, j), res in fed_cps_ops.items():
        for want in (stats.fed_cp.get((i, j)), ref_stats.fed_cp.get((i, j))):
            for got in (res.cps, res.match_cps):
                if want is None:
                    assert got.n_cp == 0
                    continue
                for f in ("pred", "cs1", "cs2", "count"):
                    np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    total_checks = sum(r.n_checked_pairs for r in fed_cps_ops.values())
    assert total_checks == stats.pruning_checked == ref_stats.pruning_checked
    assert total_checks > 0 and stats.fed_cp


# --------------------------------------------------------------------------
# the segmented entry points: K list pairs in one call
# --------------------------------------------------------------------------

def _packed(layout: str):
    """``LIST_CASES`` (and empty segments) packed as segments of shared base
    arrays, with unrelated ids between them: ``(a, aw, a_off, a_len, b, bw,
    b_off, b_len)``, the bases int32 numpy, the bounds int64."""
    rng = np.random.default_rng(sum(map(ord, layout)))
    if layout == "none":
        z = np.zeros(0, np.int64)
        return (np.zeros(5, np.int32),) * 2 + (z, z) + (np.zeros(4, np.int32),) * 2 + (z, z)
    if layout == "list_cases":
        cases = [_lists(c) for c in LIST_CASES]
        cases.insert(3, ([], [], [], []))                 # both sides empty
        cases.append(([4, 9], [1, 1], [], []))
    else:                                                 # one build, many probes
        b, bw = _lists("ragged")[2:]
        cases = [(rng.permutation(rng.choice(900, n, replace=False)),
                  rng.integers(-5, 60, n), b, bw) for n in (0, 7, 300, 899)]
    bases = [[], [], [], []]
    bounds = [[], [], [], []]
    for case in cases:
        for side in (0, 1):
            keys, wts = (np.asarray(x, np.int64) for x in case[2 * side:2 * side + 2])
            gap = rng.integers(0, 4)
            pos = sum(len(x) for x in bases[2 * side])
            bases[2 * side].append(rng.integers(-99, 99, gap))
            bases[2 * side + 1].append(rng.integers(-99, 99, gap))
            if layout == "shared_build" and side == 1 and pos:
                bounds[2].append(bounds[2][0])            # the first copy
                bounds[3].append(len(keys))
                continue
            bases[2 * side].append(keys)
            bases[2 * side + 1].append(wts)
            bounds[2 * side].append(pos + gap)
            bounds[2 * side + 1].append(len(keys))
    a, aw, b, bw = (np.concatenate(x).astype(np.int32) for x in bases)
    a_off, a_len, b_off, b_len = (np.asarray(x, np.int64) for x in bounds)
    return a, aw, a_off, a_len, b, bw, b_off, b_len


SEG_LAYOUTS = ["list_cases", "shared_build", "none"]


def _segs(x, off, length):
    return [x[o:o + n] for o, n in zip(off, length)]


@pytest.mark.parametrize("layout", SEG_LAYOUTS)
def test_sorted_intersect_segments_plain_matches_reference(layout):
    a, aw, a_off, a_len, b, bw, b_off, b_len = _packed(layout)
    got = SI.sorted_intersect_segments(_t(a), _t(aw), a_off, a_len, _t(b),
                                       _t(bw), b_off, b_len)
    assert got.dtype == torch.int32 and got.shape == (len(a_off),)
    for k, (sa, saw, sb, sbw) in enumerate(zip(
            _segs(a, a_off, a_len), _segs(aw, a_off, a_len),
            _segs(b, b_off, b_len), _segs(bw, b_off, b_len))):
        oracle = ref.sorted_intersect_weighted_ref(
            jnp.asarray(sa), jnp.asarray(saw), jnp.asarray(sb), jnp.asarray(sbw))
        assert int(got[k]) == int(oracle)
        if _nonempty(sa, sb):
            assert int(got[k]) == ref_ops.intersect_count(sa, saw, sb, sbw)
    got_ops = ops.intersect_counts(a, aw, a_off, a_len, b, bw, b_off, b_len,
                                   device="cpu")
    assert torch.equal(got_ops, got)


@pytest.mark.parametrize("layout", SEG_LAYOUTS)
def test_join_count_segments_plain_matches_reference(layout):
    p, _, p_off, p_len, b, bw, b_off, b_len = _packed(layout)
    got = JC.join_count_segments(_t(p), p_off, p_len, _t(b), _t(bw), b_off,
                                 b_len)
    assert got.dtype == torch.int32 and got.shape == (int(p_len.sum()),)
    ends = np.cumsum(p_len)
    for k, (sp, sb, sbw) in enumerate(zip(_segs(p, p_off, p_len),
                                          _segs(b, b_off, b_len),
                                          _segs(bw, b_off, b_len))):
        part = got[ends[k] - len(sp):ends[k]].numpy()
        oracle = np.asarray(ref.join_count_ref(jnp.asarray(sp), jnp.asarray(sb),
                                               jnp.asarray(sbw)))
        np.testing.assert_array_equal(part, oracle)
        if _nonempty(sp, sb):
            np.testing.assert_array_equal(part, ref_ops.match_counts(sp, sb, sbw))
    got_ops = ops.match_counts_segments(p, p_off, p_len, b, bw, b_off, b_len,
                                        device="cpu")
    assert torch.equal(got_ops, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_list_covers_every_probe_once(seed):
    rng = np.random.default_rng(seed)
    length = rng.choice([0, 1, SI.TILE - 1, SI.TILE, SI.TILE + 1, 5000], 40)
    keep = rng.random(40) < 0.8
    seg, start = SI.tile_list(length, keep)
    assert seg.dtype == start.dtype == np.int64
    assert (np.diff(seg) >= 0).all() and (start % SI.TILE == 0).all()
    for k in range(40):
        got = start[seg == k]
        want = np.arange(0, length[k], SI.TILE) if keep[k] else []
        np.testing.assert_array_equal(got, want)
    # the launch table: four (or five) rows of 40 segments, then the tiles
    off = np.cumsum(length) - length
    table, n_tiles = SI.segment_table(off, length, off, length, keep, "cpu",
                                      out_off=off)
    assert n_tiles == len(seg)
    np.testing.assert_array_equal(table.numpy(), np.concatenate(
        [off, length, off, length, off, seg, start]))


def test_segmented_wrappers_raise_on_bad_segments():
    x = torch.zeros(6, dtype=torch.int32)
    for a_off, a_len, b_off, b_len, err in (
            ([0], [7], [0], [1], ValueError),       # past the base
            ([-1], [1], [0], [1], ValueError),
            ([0], [-1], [0], [1], ValueError),
            ([0, 1], [1, 1], [0], [1], ValueError),  # K differs
            ([[0]], [[1]], [[0]], [[1]], ValueError),
            ([0.0], [1.0], [0], [1], TypeError)):
        with pytest.raises(err):
            SI.sorted_intersect_segments(x, x, a_off, a_len, x, x, b_off, b_len)
        with pytest.raises(err):
            JC.join_count_segments(x, a_off, a_len, x, x, b_off, b_len)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        SI.sorted_intersect_segments(meta, meta, [0], [1], meta, meta, [0], [1])
    with pytest.raises(ValueError):
        JC.join_count_segments(meta, [0], [1], meta, meta, [0], [1])


def test_segmented_entry_points_default_to_the_card():
    import inspect

    for fn in (ops.intersect_counts, ops.match_counts_segments):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_federated_cps_ops_equal_the_per_check_loop(small_federation,
                                                    fed_cps_ops):
    """One launch per source pair gives what one ``intersect_count`` and
    one ``match_counts`` call per exact check gave: the same checks, CP rows
    and counts, in the same order."""
    _, stats = small_federation
    for (i, j), res in fed_cps_ops.items():
        eo, es = stats.exports[i], stats.exports[j]
        by_intersect, by_match, checked = [], [], 0
        for r, c2 in res.pairs:
            ents, mult = eo.objects_row(r)
            subj = es.subjects_of(c2)
            if len(ents) == 0 or len(subj) == 0:
                continue
            checked += 1
            key = (int(eo.obj_pred[r]), int(eo.obj_cs[r]), c2)
            ones = np.ones(len(subj), np.int32)
            cnt = ops.intersect_count(ents, mult, subj, ones, device="cpu")
            if cnt:
                by_intersect.append((*key, cnt))
            mc = ops.match_counts(ents, subj, ones, device="cpu")
            m = int((mult.astype(np.int64) * mc).sum())
            if m:
                by_match.append((*key, m))
        assert res.n_checked_pairs == checked
        for got, rows in ((res.cps, by_intersect), (res.match_cps, by_match)):
            cols = np.asarray(rows, np.int64).reshape(-1, 4).T
            want = CPStats.from_rows(*cols, src1=eo.src, src2=es.src)
            for f in ("pred", "cs1", "cs2", "count", "src1", "src2"):
                np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
