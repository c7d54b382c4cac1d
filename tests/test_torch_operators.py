"""The port's bounded-buffer operators (``repro_torch.engine.operators``)
against the reference's ``jax.jit`` operators (``repro.engine.operators``)
in-process, on the same seeded numpy inputs: ``data``, ``valid`` and the
overflow flag equal element for element and in dtype (int32 data, bool
flags), overflowing buffers included.  Batched calls over ``(d, m)`` shards
equal one reference call per shard, and a build side broadcast over the
data shards equals its copies."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.engine import operators as R  # noqa: E402
from repro_torch.engine import operators as P  # noqa: E402

OPS = ("=", "!=", "<", "<=", ">", ">=")


def same(got, want) -> None:
    """One tensor (or tuple of them) of the port against the reference's
    arrays: equal values and the same numpy dtype."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def t(x) -> "torch.Tensor":
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(rng, n, ncols, hi, n_valid):
    data = rng.integers(0, hi, (n, ncols)).astype(np.int32)
    valid = np.arange(n) < n_valid
    return data, valid


@pytest.mark.parametrize("n,cap,frac", [(64, 32, 0.3), (64, 128, 0.3),
                                        (64, 16, 0.9), (50, 50, 1.0),
                                        (40, 8, 0.0)])
def test_compact_equals_reference(n, cap, frac):
    """Below ``cap`` rows the indices pad with 0 (the pad rows are gathered
    and then zeroed by the engine); above it the flag is set."""
    mask = np.random.default_rng(n + cap).random(n) < frac
    idx, valid, ovf = P.compact(t(mask), cap)
    ridx, rvalid, rovf = R.compact(jnp.asarray(mask), cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    same((valid, ovf), (rvalid, rovf))


@pytest.mark.parametrize("pattern", [[5, -1, -1], [-1, 3, -1], [-1, 3, 7],
                                     [2, 1, -1], [-1, -1, -1]])
@pytest.mark.parametrize("cap", [16, 32, 128])
def test_scan_pattern_wildcards_equal_reference(pattern, cap):
    rng = np.random.default_rng(0)
    table = rng.integers(0, 20, (64, 3)).astype(np.int32)
    trow = np.ones(64, bool)
    trow[50:] = False
    got = P.scan_pattern(t(table), t(trow), pattern, cap, (0, 2))
    want = R.scan_pattern(jnp.asarray(table), jnp.asarray(trow),
                          jnp.asarray(pattern, jnp.int32), cap, (0, 2))
    same(got, want)


def test_scan_pattern_overflow_flag_equals_reference():
    table = np.zeros((64, 3), np.int32)
    trow = np.ones(64, bool)
    got = P.scan_pattern(t(table), t(trow), [-1, -1, -1], 16, (0, 1))
    want = R.scan_pattern(jnp.asarray(table), jnp.asarray(trow),
                          jnp.asarray([-1, -1, -1], jnp.int32), 16, (0, 1))
    same(got, want)
    assert bool(got[2]) and int(got[1].sum()) == 16


@pytest.mark.parametrize("cap", [8, 64, 256, 2048])
@pytest.mark.parametrize("hi", [3, 12])
def test_merge_join_equals_reference(cap, hi):
    """Duplicate keys on both sides (``hi`` = 3 keys: many matches per
    row), invalid rows on both sides, ``cap`` below and above the output."""
    rng = np.random.default_rng(cap + hi)
    left, lvalid = _rel(rng, 64, 2, hi, 48)
    right, rvalid = _rel(rng, 64, 3, hi, 56)
    got = P.merge_join(t(left), t(lvalid), 0, t(right), t(rvalid), 1, cap)
    want = R.merge_join(jnp.asarray(left), jnp.asarray(lvalid), 0,
                        jnp.asarray(right), jnp.asarray(rvalid), 1, cap)
    same(got, want)


@pytest.mark.parametrize("cap", [4, 32, 64])
@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_distinct_equals_reference(cap, ncols):
    """The reference's lexsort order (last column most significant), with
    invalid rows holding values too."""
    rng = np.random.default_rng(5 * ncols + cap)
    rel, valid = _rel(rng, 32, ncols, 4, 30)
    got = P.distinct(t(rel), t(valid), cap)
    want = R.distinct(jnp.asarray(rel), jnp.asarray(valid), cap)
    same(got, want)


@pytest.mark.parametrize("cap", [1, 4, 8])
def test_semi_bind_equals_reference(cap):
    rel = np.array([[1, 10], [2, 20], [3, 30], [4, 40], [2, 21], [4, 41]], np.int32)
    valid = np.array([True, True, True, False, True, True])
    keys = np.array([2, 4, 9], np.int32)
    kvalid = np.array([True, True, False])
    got = P.semi_bind(t(rel), t(valid), t(keys), t(kvalid), 0, cap)
    want = R.semi_bind(jnp.asarray(rel), jnp.asarray(valid), jnp.asarray(keys),
                       jnp.asarray(kvalid), 0, cap)
    same(got, want)


@pytest.mark.parametrize("cap", [16, 64, 256])
def test_left_merge_join_equals_reference(cap):
    """Keys 8..15 of the left side have no match: UNDEF pad rows."""
    rng = np.random.default_rng(9)
    left = rng.integers(0, 16, (32, 2)).astype(np.int32)
    right = rng.integers(0, 8, (32, 2)).astype(np.int32)
    lvalid = np.arange(32) < 20
    rvalid = np.arange(32) < 24
    got = P.left_merge_join(t(left), t(lvalid), 0, t(right), t(rvalid), 1, cap)
    want = R.left_merge_join(jnp.asarray(left), jnp.asarray(lvalid), 0,
                             jnp.asarray(right), jnp.asarray(rvalid), 1, cap)
    same(got, want)
    if cap == 256:
        assert (got[0][got[1]] == P.UNDEF).any()


def test_left_merge_join_overflow_flag_equals_reference():
    left = np.zeros((16, 1), np.int32)
    right = np.zeros((16, 1), np.int32)
    valid = np.ones(16, bool)
    got = P.left_merge_join(t(left), t(valid), 0, t(right), t(valid), 0, 64)
    want = R.left_merge_join(jnp.asarray(left), jnp.asarray(valid), 0,
                             jnp.asarray(right), jnp.asarray(valid), 0, 64)
    same(got, want)
    assert bool(got[2]) and int(got[1].sum()) == 64


@pytest.mark.parametrize("cap", [2, 4, 8])
def test_align_columns_and_union_rels_equal_reference(cap):
    a = np.array([[1, 2], [3, 4], [0, 0]], np.int32)
    av = np.array([True, True, False])
    b = np.array([[5], [6], [7]], np.int32)
    bv = np.array([True, False, True])
    aa, av2 = P.align_columns(t(a), t(av), (0, 1, -1))
    bb, bv2 = P.align_columns(t(b), t(bv), (-1, 0, -1))
    raa, rav2 = R.align_columns(jnp.asarray(a), jnp.asarray(av), (0, 1, -1))
    rbb, rbv2 = R.align_columns(jnp.asarray(b), jnp.asarray(bv), (-1, 0, -1))
    same((aa, av2, bb, bv2), (raa, rav2, rbb, rbv2))
    same(P.union_rels(aa, av2, bb, bv2, cap), R.union_rels(raa, rav2, rbb, rbv2, cap))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("rhs", ["column", "constant"])
def test_compare_mask_and_filter_rows_equal_reference(op, rhs):
    """Two-valued: rows with an UNDEF side are false, ``!=`` included."""
    U = P.UNDEF
    rel = np.array([[3, 3], [3, 5], [5, 3], [U, 3], [3, U], [4, 4]], np.int32)
    valid = np.array([True, True, True, True, True, False])
    rhs_col = 1 if rhs == "column" else -1
    got = P.compare_mask(t(rel), t(valid), P.OP_CODES[op], 0, rhs_col, 0, 4)
    want = R.compare_mask(jnp.asarray(rel), jnp.asarray(valid), R.OP_CODES[op],
                          0, rhs_col, jnp.int32(0), jnp.int32(4))
    same(got, want)
    same(P.filter_rows(t(rel), t(valid), got, 3),
         R.filter_rows(jnp.asarray(rel), jnp.asarray(valid), want, 3))


def test_constants_and_empty_relation_equal_reference():
    assert (P.UNDEF, P.OP_CODES) == (R.UNDEF, R.OP_CODES)
    same(P.make_rel(8, 3, device="cpu"), R.make_rel(8, 3))
    valid = np.random.default_rng(1).random((3, 17)) < 0.5
    same(P.count_valid(t(valid)), np.stack([np.asarray(R.count_valid(jnp.asarray(v)))
                                            for v in valid]))


# --------------------------------------------------------------------------
# batched calls over (d, m) shards
# --------------------------------------------------------------------------

D, M = 3, 2


def per_shard(fn, *arrays):
    """The reference ``fn`` once per (d, m) shard of every array, stacked."""
    outs = [fn(*[jnp.asarray(a[i, j]) for a in arrays])
            for i in range(D) for j in range(M)]
    return tuple(np.stack([np.asarray(o[k]) for o in outs]).reshape(
        (D, M) + np.asarray(outs[0][k]).shape) for k in range(len(outs[0])))


@pytest.mark.parametrize("cap", [8, 48])
def test_batched_scan_pattern_equals_per_shard(cap):
    rng = np.random.default_rng(cap)
    table = rng.integers(0, 6, (D, M, 40, 3)).astype(np.int32)
    trow = rng.random((D, M, 40)) < 0.8
    pats = rng.integers(-1, 6, (D, M, 3)).astype(np.int32)
    got = P.scan_pattern(t(table), t(trow), t(pats), cap, (0, 2))
    want = per_shard(lambda a, b, c: R.scan_pattern(a, b, c, cap, (0, 2)),
                     table, trow, pats)
    same(got, want)


@pytest.mark.parametrize("cap", [8, 64])
@pytest.mark.parametrize("fn", ["merge_join", "left_merge_join"])
def test_batched_joins_equal_per_shard(cap, fn):
    rng = np.random.default_rng(cap + len(fn))
    left = rng.integers(0, 5, (D, M, 24, 2)).astype(np.int32)
    lvalid = rng.random((D, M, 24)) < 0.7
    right = rng.integers(0, 5, (D, M, 20, 3)).astype(np.int32)
    rvalid = rng.random((D, M, 20)) < 0.7
    got = getattr(P, fn)(t(left), t(lvalid), 1, t(right), t(rvalid), 2, cap)
    want = per_shard(lambda a, b, c, e: getattr(R, fn)(a, b, 1, c, e, 2, cap),
                     left, lvalid, right, rvalid)
    same(got, want)


@pytest.mark.parametrize("cap", [8, 64])
@pytest.mark.parametrize("shared", [(1, M), (1, 1)])
def test_merge_join_broadcast_build_side_equals_copies(cap, shared):
    """A build side kept at size 1 over the data axis (or both axes), as
    the engine's gathered build side is, equals its materialized copies:
    the sort and the search run once for every index it does keep."""
    rng = np.random.default_rng(cap + shared[1])
    left = rng.integers(0, 6, (D, M, 24, 2)).astype(np.int32)
    lvalid = rng.random((D, M, 24)) < 0.7
    right = rng.integers(0, 6, (1, 1, 30, 2)).astype(np.int32)
    rvalid = rng.random(shared + (30,)) < 0.7
    got = P.merge_join(t(left), t(lvalid), 0, t(right), t(rvalid), 1, cap)
    rfull = np.broadcast_to(right, (D, M, 30, 2))
    vfull = np.broadcast_to(rvalid, (D, M, 30))
    want = per_shard(lambda a, b, c, e: R.merge_join(a, b, 0, c, e, 1, cap),
                     left, lvalid, rfull, vfull)
    same(got, want)


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_broadcast_equals_numpy(side):
    rng = np.random.default_rng(3)
    seq = np.sort(rng.integers(0, 9, (1, M, 15)), axis=-1).astype(np.int32)
    vals = rng.integers(-1, 10, (D, M, 7)).astype(np.int32)
    got = P.searchsorted(t(seq), t(vals), side).numpy()
    for i in range(D):
        for j in range(M):
            np.testing.assert_array_equal(
                got[i, j], np.searchsorted(seq[0, j], vals[i, j], side=side))


def test_batched_distinct_and_union_equal_per_shard():
    rng = np.random.default_rng(11)
    rel = rng.integers(0, 3, (D, M, 16, 2)).astype(np.int32)
    valid = rng.random((D, M, 16)) < 0.8
    same(P.distinct(t(rel), t(valid), 12),
         per_shard(lambda a, b: R.distinct(a, b, 12), rel, valid))
    other = rng.integers(0, 3, (D, M, 10, 2)).astype(np.int32)
    ovalid = rng.random((D, M, 10)) < 0.5
    same(P.union_rels(t(rel), t(valid), t(other), t(ovalid), 20),
         per_shard(lambda a, b, c, e: R.union_rels(a, b, c, e, 20),
                   rel, valid, other, ovalid))
