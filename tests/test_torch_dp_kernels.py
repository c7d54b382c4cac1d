"""The port's DP kernels (their plain versions, on the CPU) against the
reference package's device programs and its scalar/jnp oracles: exact
equality, including injected cost ties, exclusive-leaf seeds and source-less
leaves.  The reference kernels need ``jax.experimental.enable_x64``, which
jax 0.9.0 no longer has; a module-scoped shim supplies it and is undone
after this module."""
import importlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import join_order as ref_jo          # noqa: E402
from repro.core.cost import CostModel as RefCostModel  # noqa: E402
from repro.rdf.shapes import shaped_planning_inputs as ref_shaped  # noqa: E402
from repro_torch.core import join_order as jo        # noqa: E402
from repro_torch.core.cost import CostModel          # noqa: E402
from repro_torch.kernels import dp_layer as K        # noqa: E402
from repro_torch.rdf.shapes import shaped_planning_inputs  # noqa: E402
from test_torch_cuda import _sweep_inputs            # noqa: E402

PARAMS = [(1.0, 1.0, 5.0, 20), (2.0, 0.5, 7.0, 10)]


@pytest.fixture(scope="module")
def ref_kernels():
    """``(repro.kernels.dp_layer, repro.kernels.ref)`` importable under the
    x64 shim; the shimmed module is dropped again after this module."""
    import jax
    import jax.experimental

    name = "repro.kernels.dp_layer"
    had = name in sys.modules
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        mod = importlib.import_module(name)
        ref = importlib.import_module("repro.kernels.ref")
        yield mod, ref
        if not had:
            sys.modules.pop(name, None)
            pkg = sys.modules["repro.kernels"]
            if getattr(pkg, "dp_layer", None) is mod:
                mp.delattr(pkg, "dp_layer")


def _port_sweep(sched, params, arrays):
    t = [torch.from_numpy(x) for x in arrays]
    return [x.numpy() for x in K.dp_sweep(params, *sched.device_arrays("cpu"),
                                          *t)]


@pytest.mark.parametrize("shape,n,B,seed", [
    ("tree", 8, 4, 3), ("clique", 6, 3, 5), ("chain", 9, 2, 7)])
def test_dp_sweep_plain_matches_reference_resident(ref_kernels, shape, n, B,
                                                   seed):
    ref_dp, ref = ref_kernels
    g, _, _, _ = ref_shaped(shape, n, seed=seed)
    rsched = ref_jo._dp_schedule(g, ref_jo.DP_BLOCK_BYTES, B)
    assert rsched is not None
    size = 1 << n
    conn = rsched.layer_cols[rsched.layer_cols < size]
    arrays = _sweep_inputs(n, conn, B, seed + 10, n_excl=12)
    sched = jo.from_reference_schedule(rsched)
    before = dict(K.LAUNCHES)
    for params in PARAMS:
        got = _port_sweep(sched, params, arrays)
        want = ref_dp.dp_sweep_resident(
            params, rsched.pair_a, rsched.pair_b, rsched.pair_seg,
            rsched.layer_cols, *arrays)
        oracle = ref.dp_sweep_ref(params, rsched.pair_a, rsched.pair_b,
                                  rsched.pair_seg, rsched.layer_cols, *arrays)
        for g_, w_, o_ in zip(got, want, oracle):
            np.testing.assert_array_equal(g_, np.asarray(w_))
            np.testing.assert_array_equal(g_, o_)
        assert (got[1] != 0).any()
    assert K.LAUNCHES == before          # the plain version launches nothing


def test_port_schedule_equals_reference_schedule():
    """The port builds the reference's schedule itself (same extents,
    sentinels, pair count and budget bytes), sorted column-major."""
    for shape, n, seed in (("tree", 8, 3), ("clique", 7, 2), ("chain", 10, 1)):
        rg, _, _, _ = ref_shaped(shape, n, seed=seed)
        g, _, _, _ = shaped_planning_inputs(shape, n, seed=seed)
        rs = ref_jo._dp_schedule(rg, ref_jo.DP_BLOCK_BYTES, 2)
        ps = jo._dp_schedule(g, jo.DP_BLOCK_BYTES, 2)
        conv = jo.from_reference_schedule(rs)
        for f in ("pair_a", "pair_b", "pair_seg", "layer_cols", "col_ptr"):
            np.testing.assert_array_equal(getattr(ps, f), getattr(conv, f))
        assert (ps.n, ps.n_pairs, ps.nbytes) == (rs.n, rs.n_pairs, rs.nbytes)
        C = ps.layer_cols.shape[1]
        for li in range(ps.pair_seg.shape[0]):
            seg = ps.pair_seg[li]
            assert (np.diff(seg) >= 0).all()
            counts = np.bincount(seg[seg < C], minlength=C)
            np.testing.assert_array_equal(np.diff(ps.col_ptr[li]), counts)


def test_dp_sweep_on_row_chunked_schedule(ref_kernels):
    """A budget small enough that the reference enumerates a layer in row
    chunks (its pairs come out chunk-major, not column-major): the port's
    stable column sort keeps the first strict minimum."""
    ref_dp, ref = ref_kernels
    g, _, _, _ = ref_shaped("clique", 8, seed=31)
    budget = 180224
    ref_jo._SCHEDULE_CACHE.pop(ref_jo.star_graph_topology(g), None)
    rsched = ref_jo._dp_schedule(g, budget, 1)
    ref_jo._SCHEDULE_CACHE.pop(ref_jo.star_graph_topology(g), None)
    assert rsched is not None
    C = rsched.layer_cols.shape[1]
    unsorted = [li for li in range(rsched.pair_seg.shape[0])
                if (np.diff(rsched.pair_seg[li][rsched.pair_seg[li] < C])
                    < 0).any()]
    assert unsorted, "the budget must force a chunked layer"
    B, n = 3, 8
    arrays = _sweep_inputs(n, rsched.layer_cols[rsched.layer_cols < 256], B,
                           41, n_excl=20)
    sched = jo.from_reference_schedule(rsched)
    got = _port_sweep(sched, PARAMS[0], arrays)
    want = ref.dp_sweep_ref(PARAMS[0], rsched.pair_a, rsched.pair_b,
                            rsched.pair_seg, rsched.layer_cols, *arrays)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)


def _tile(B, R, C, seed):
    """The input recipe of the reference's ``test_dp_layer_sweep``: exact
    ties across rows and an all-invalid column."""
    rng = np.random.default_rng(seed)
    cost_a = rng.uniform(1, 100, (B, R, C))
    cost_b = rng.uniform(1, 100, (B, R, C))
    card_a = rng.uniform(0, 50, (B, R, C))
    n_src_b = rng.integers(1, 4, (B, R, C)).astype(np.float64)
    src_w_b = rng.uniform(0.5, 2, (B, R, C))
    bindable = rng.random((B, R, C)) < 0.5
    valid = rng.random((R, C)) < 0.6
    if C > 1:
        valid[:, -1] = False
    card_s = rng.uniform(0, 80, (B, C))
    cost_a[:, ::3, :] = 5.0
    cost_b[:, ::3, :] = 5.0
    return cost_a, cost_b, card_a, n_src_b, src_w_b, bindable, valid, card_s


@pytest.mark.parametrize("B,R,C", [(1, 2, 3), (4, 130, 7), (3, 40, 60)])
def test_dp_layer_plain_matches_reference(ref_kernels, B, R, C):
    import jax
    import jax.numpy as jnp

    ref_dp, ref = ref_kernels
    tile = _tile(B, R, C, B * 1000 + R + C)
    cost_a, cost_b, card_a, n_src_b, src_w_b, bindable, valid, card_s = tile
    args = [torch.from_numpy(x) for x in (cost_a, cost_b, card_a, n_src_b,
                                          src_w_b)]
    args += [torch.from_numpy(bindable.astype(np.int8)),
             torch.from_numpy(valid.astype(np.int8)),
             torch.from_numpy(card_s)]
    for params in PARAMS:
        got = [x.numpy() for x in K.dp_layer(*args, params)]
        want = ref_dp.dp_layer(*tile, params)
        with jax.enable_x64(True):
            oracle = ref.dp_layer_ref(*(jnp.asarray(x) for x in tile), params)
        assert got[0].dtype == np.float64 and got[1].dtype == np.int32
        for g_, w_, o_ in zip(got, want, oracle):
            np.testing.assert_array_equal(g_, np.asarray(w_).astype(g_.dtype))
            np.testing.assert_array_equal(g_, np.asarray(o_).astype(g_.dtype))
        if C > 1:
            assert np.isinf(got[0][:, -1]).all()
            assert (got[1][:, -1] == 2**31 - 1).all()


def test_cost_twin_bitwise_equals_numpy_form():
    """Cardinalities are small against the costs so that both the hash and
    the bind branch win often; arbitrary source weights make any change of
    association visible in the last bit."""
    rng = np.random.default_rng(3)
    shp = (5, 300)
    cost_a = rng.uniform(0, 1e4, shp)
    cost_b = rng.uniform(0, 1e4, shp)
    card_out = rng.uniform(0, 1e3, shp)
    card_a = rng.uniform(0, 1e3, shp)
    n_src = rng.integers(0, 4, shp).astype(np.float64)
    src_w = rng.uniform(0.3, 3.0, shp)
    src_w[:, ::7] = 1.5
    cost_a[:, ::4] = 3.0                                     # ties
    cost_b[:, ::4] = 3.0
    card_a[:, ::5] = 7.0
    bindable = n_src > 0
    for iw, tw, rc, bb in [(1.0, 1.0, 5.0, 20), (0.3, 2.5, 11.0, 7),
                           (1e-3, 7.3, 0.1, 1)]:
        cm = RefCostModel(iw, tw, rc, bb)
        want_c, want_b = cm.join_candidates_v(
            cost_a, cost_b, card_out, cm.hash_join_cost_v(card_out), card_a,
            np.maximum(n_src, 1), src_w, bindable)
        assert 0.1 < want_b.mean() < 0.9                 # both branches win
        t = [torch.from_numpy(x) for x in (cost_a, cost_b, card_out, card_a,
                                           np.maximum(n_src, 1), src_w)]
        got_c, got_b = CostModel.join_candidates_params_torch(
            (iw, tw, rc, bb), *t, torch.from_numpy(bindable))
        assert got_c.dtype == torch.float64
        np.testing.assert_array_equal(got_c.numpy().view(np.int64),
                                      want_c.view(np.int64))
        np.testing.assert_array_equal(got_b.numpy(), want_b)


def test_wrappers_check_their_inputs():
    B, R, C = 2, 5, 3
    f = lambda *s: torch.zeros(s, dtype=torch.float64)  # noqa: E731
    i8 = lambda *s: torch.zeros(s, dtype=torch.int8)    # noqa: E731
    good = [f(B, R, C)] * 5 + [i8(B, R, C), i8(R, C), f(B, C)]
    K.dp_layer(*good, PARAMS[0])
    bad_dtype = list(good)
    bad_dtype[0] = good[0].float()
    with pytest.raises(TypeError):
        K.dp_layer(*bad_dtype, PARAMS[0])
    bad_shape = list(good)
    bad_shape[7] = f(B, C + 1)
    with pytest.raises(ValueError):
        K.dp_layer(*bad_shape, PARAMS[0])
    bad_layout = list(good)
    bad_layout[1] = f(B, C, R).transpose(1, 2)
    with pytest.raises(ValueError):
        K.dp_layer(*bad_layout, PARAMS[0])
    meta = [t.to("meta") for t in good]
    with pytest.raises(ValueError):
        K.dp_layer(*meta, PARAMS[0])
    g, _, _, _ = shaped_planning_inputs("chain", 4, seed=1)
    sched = jo._dp_schedule(g, jo.DP_BLOCK_BYTES, 1)
    planes = [f(1, 16) for _ in range(6)]
    sa = list(sched.device_arrays("cpu"))
    sa[3] = sa[3][:, :-1].contiguous()            # col_ptr one column short
    with pytest.raises(ValueError):
        K.dp_sweep(PARAMS[0], *sa, *planes)
