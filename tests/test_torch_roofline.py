"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's: ``model_flops`` exactly equal for every architecture and
shape, and ``Roofline``'s properties exactly equal given the same inputs
and the reference's peaks; then the op-trace analyzer on hand-built
programs -- a matmul sharded on a fake ``(16, 16)`` DTensor mesh, in-place
slice writes, one of each collective, a ``BookingMesh`` program's own
bookings (and none by the engine's plain mesh) -- and each hand-written kernel booked as one op with the work
``kernels/work.py`` counts for it."""
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.config.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.launch import roofline as RRL  # noqa: E402
from repro_torch.config.base import SHAPES  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ssm_scan as SS  # noqa: E402
from repro_torch.kernels import work as W  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch.dryrun import fake_mesh  # noqa: E402

BF16 = torch.bfloat16


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    assert RL._attn_layers(cfg) == RRL._attn_layers(rcfg)
    for name in SHAPES:
        assert RL.model_flops(cfg, SHAPES[name]) == \
            RRL.model_flops(rcfg, REF_SHAPES[name]), name


ROOFLINES = [  # flops, HBM bytes, collective bytes, useful flops, chips
    (1.9e9, 3.1e10, 8.3e6, 4.9e11, 256), (7.5e13, 2.0e11, 4.1e11, 1.5e16, 512),
    (0.0, 1.0e9, 5.8e6, 0.0, 256), (3.0e12, 0.0, 0.0, 1.0e14, 256)]


@pytest.mark.parametrize("case", range(len(ROOFLINES)))
def test_roofline_properties_equal_reference(monkeypatch, case):
    monkeypatch.setattr(RL, "PEAK_FLOPS", RRL.PEAK_FLOPS)
    monkeypatch.setattr(RL, "HBM_BW", RRL.HBM_BW)
    monkeypatch.setattr(RL, "LINK_BW", RRL.ICI_BW)
    f, b, c, useful, chips = ROOFLINES[case]
    kw = dict(arch="a", shape="s", mesh="16x16", n_chips=chips,
              flops_per_dev=f, hbm_bytes_per_dev=b,
              collective_bytes_per_dev=c, model_flops_total=useful,
              xla_flops_reported=f, xla_bytes_reported=0.0,
              by_collective={"all-gather": c}, memory_per_dev_bytes=1e9,
              max_while_trip=24)
    got, want = RL.Roofline(**kw).to_dict(), RRL.Roofline(**kw).to_dict()
    # the port's one key more: no FP32-pipe kernel work given, none priced
    assert got.pop("fp32_flops_per_dev") == 0.0
    assert got == want


@pytest.mark.parametrize("case", range(len(ROOFLINES)))
def test_roofline_prices_fp32_work_apart(case):
    """The scan kernels' FP32-pipe work adds its time at the FP32 rate to
    the compute term, and is no part of the useful-flops fraction."""
    f, b, c, useful, chips = ROOFLINES[case]
    kw = dict(arch="a", shape="s", mesh="16x16", n_chips=chips,
              flops_per_dev=f, hbm_bytes_per_dev=b,
              collective_bytes_per_dev=c, model_flops_total=useful,
              xla_flops_reported=f, xla_bytes_reported=0.0,
              by_collective={"all-gather": c})
    plain = RL.Roofline(**kw)
    rf = RL.Roofline(**kw, fp32_flops_per_dev=6.7e12)
    assert rf.compute_s == f / RL.PEAK_FLOPS + 6.7e12 / RL.PEAK_FP32
    assert rf.useful_flops_fraction == plain.useful_flops_fraction
    assert (rf.memory_s, rf.collective_s) == (plain.memory_s, plain.collective_s)
    assert rf.to_dict()["fp32_flops_per_dev"] == 6.7e12


def test_peaks_are_one_h100s():
    assert (RL.PEAK_FLOPS, RL.PEAK_FP32, RL.HBM_BW, RL.HBM_CAP, RL.LINK_BW) == \
        (989e12, 67e12, 3.35e12, 80e9, 50e9)


def test_sharded_matmul_books_the_local_product():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_mesh((16, 16), ("data", "model")) as mesh, FakeTensorMode():
        x = distribute_tensor(torch.empty(256, 4096, dtype=BF16), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(4096, 16384, dtype=BF16), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with RL.record_ops() as trace:
            y = x @ w
        assert tuple(y.to_local().shape) == (16, 1024)
    costs = RL.analyze(trace)
    assert costs.flops == 2 * 16 * 4096 * 1024
    assert costs.hbm_bytes == 2 * (16 * 4096 + 4096 * 1024 + 16 * 1024)
    assert costs.collective_bytes == 0 and RL.counter_flops(trace) == costs.flops


def test_slice_writes_move_twice_the_slice():
    with FakeTensorMode():
        buf = torch.empty(64, 128)
        src = torch.empty(64, 16)
        idx = torch.empty(8, dtype=torch.int64)
        rows = torch.empty(8, 128)
        index = torch.empty(64, 16, dtype=torch.int64)
        with RL.record_ops() as trace:
            buf[:, 16:32].copy_(src)
            buf.index_copy_(0, idx, rows)
            buf.scatter_(1, index, src)
            buf.zero_()
    costs = RL.analyze(trace)
    four = 4
    assert costs.hbm_bytes == (2 * 64 * 16 + 2 * 8 * 128 + 2 * 64 * 16
                               + 64 * 128) * four
    assert [r["kind"] for r in trace.records if r["kind"] != "view"] == \
        ["write", "write", "write", "fill"]


def test_each_collective_books_its_operand():
    from torch.distributed import _functional_collectives as funcol

    with fake_mesh((4, 2), ("data", "model")) as mesh, FakeTensorMode():
        t = torch.empty(8, 4)
        with RL.record_ops() as trace:
            funcol.all_gather_single(t, 0, (mesh, 0))
            funcol.all_reduce(t, "sum", (mesh, 0))
            getattr(funcol, "reduce_scatter_single",
                    funcol.reduce_scatter_tensor)(t, "sum", 0, (mesh, 0))
            funcol.all_to_all_single(t, None, None, (mesh, 1))
            RL.book_collective("collective-permute", 12)
    costs = RL.analyze(trace)
    nbytes = 8 * 4 * 4
    assert costs.by_collective == {"all-gather": nbytes, "all-reduce": nbytes,
                                   "reduce-scatter": nbytes,
                                   "all-to-all": nbytes,
                                   "collective-permute": 12}
    assert costs.collective_count == {k: 1 for k in costs.by_collective}
    assert costs.collective_bytes == 4 * nbytes + 12
    with pytest.raises(ValueError):
        RL.book_collective("broadcast", 1)


def test_plain_mesh_books_nothing():
    """Only the dry-run's ``BookingMesh`` books: the engine's own mesh runs
    its collectives inside a recording and adds no collective to it."""
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((2, 2), device="cpu")
    booking = RL.BookingMesh(mesh.shape, mesh.axis_names, mesh.device)
    x = torch.arange(2 * 2 * 2 * 3, dtype=torch.int32).reshape(2, 2, 2, 3)
    with RL.record_ops() as plain:
        want = (mesh.all_to_all(x), mesh.all_gather(x), mesh.psum(x))
    with RL.record_ops() as booked:
        got = (booking.all_to_all(x), booking.all_gather(x), booking.psum(x))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not [r for r in plain.records if r["kind"] == "collective"]
    assert RL.analyze(booked).collective_count == {
        "all-to-all": 1, "all-gather": 2, "all-reduce": 2}


def test_mesh_collectives_book_per_shard():
    """The federation step on a 2 x 2 one-device mesh: each gather over
    (model, data) moves a shard's block, then one twice as large."""
    from repro_torch.engine.distributed import fed_dryrun_lower
    from repro_torch.launch.mesh import make_test_mesh

    cap = 64
    trace = fed_dryrun_lower(make_test_mesh((2, 2), device="cpu"), cap=cap,
                             table_cap=256)
    costs = RL.analyze(trace)
    assert trace.shards == 4
    block = cap * (4 * 7 + 1) + cap * (4 * 3 + 1)   # collect + build side
    assert costs.by_collective == {"all-to-all": 2 * (cap // 2) * (4 * 4 + 1),
                                   "all-gather": 3 * block,
                                   "all-reduce": 2 * 2 * 4}
    assert costs.collective_count == {"all-to-all": 2, "all-gather": 8,
                                      "all-reduce": 4}
    assert costs.hbm_bytes > 0 and trace.peak_bytes >= trace.base_bytes
    again = RL.analyze(RL.OpTrace.from_json(trace.to_json()))
    assert (again.flops, again.hbm_bytes, again.by_collective) == \
        (costs.flops, costs.hbm_bytes, costs.by_collective)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_flash_kernels_booked_as_one_op(dtype, window):
    B, S, H, KV, hd = 2, 96, 8, 2, 64
    item = torch.tensor([], dtype=dtype).element_size()
    with FakeTensorMode():
        q = torch.empty(B, S, H, hd, dtype=dtype)
        k = torch.empty(B, S, KV, hd, dtype=dtype)
        with RL.record_ops() as fwd:
            FA.flash_attention(q, k, k, window=window)
        q.requires_grad_()
        with RL.record_ops() as train:
            FA.flash_attention(q, k, k, window=window).sum().backward()
    assert [r["kernel"] for r in fwd.records if r["kind"] == "kernel"] == \
        ["flash_attention"]
    w = W.flash_attention(B, S, H, KV, hd, window=window, itemsize=item)
    costs = RL.analyze(fwd)
    assert (costs.flops, costs.hbm_bytes) == (w.flops, w.bytes)
    kernels = [r for r in train.records if r["kind"] == "kernel"]
    assert [r["kernel"] for r in kernels] == ["flash_attention_fwd",
                                              "flash_attention_bwd"]
    want = [W.flash_attention(B, S, H, KV, hd, window=window, itemsize=item,
                              with_lse=True),
            W.flash_attention_bwd(B, S, H, KV, hd, window=window,
                                  itemsize=item)]
    assert [RL.kernel_work(r) for r in kernels] == want
    # nothing of the plain version (its scores are (B, H, S, S))
    assert not any("bmm" in r["op"] for r in train.records)


def test_scan_kernels_booked_as_one_op():
    B, S, D, N = 2, 40, 64, 16
    with FakeTensorMode():
        dt = torch.empty(B, S, D)
        bt = torch.empty(B, S, N)
        a = torch.empty(D, N)
        with RL.record_ops() as fwd:
            SS.ssm_scan(dt, bt, bt, dt, a)
        dt.requires_grad_()
        with RL.record_ops() as train:
            y, h = SS.ssm_scan(dt, bt, bt, dt, a)
            (y.sum() + h.sum()).backward()
    # FP32-pipe instructions, booked apart from the tensor-core flops
    costs = RL.analyze(fwd)
    assert costs.flops == 0
    assert costs.fp32_flops == W.ssm_scan(B, S, D, N).flops
    assert costs.hbm_bytes == W.ssm_scan(B, S, D, N).bytes
    kernels = [r for r in train.records if r["kind"] == "kernel"]
    assert [RL.kernel_work(r) for r in kernels] == [
        W.ssm_scan(B, S, D, N, keep_chunks=W.n_chunks(S)),
        W.ssm_scan_bwd(B, S, D, N, n_chunk=W.n_chunks(S), dh_last=True)]
    # no step-by-step recurrence
    assert sum(r["kind"] != "view" for r in train.records) < 12


def test_visible_pairs():
    S = 10
    for causal in (True, False):
        for window in (0, 1, 3, 10, 12):
            want = sum(1 for i in range(S) for j in range(S)
                       if not (causal and j > i) and not (window and i - j >= window))
            assert W.visible_pairs(S, causal, window) == want, (causal, window)
