"""Roofline analysis of the dry-run's per-device programs, on H100 peaks.

The reference prices XLA's optimized per-device HLO: it parses the HLO text
(``parse_hlo``) and walks it (``analyze``).  The port produces no HLO, so it
needs no HLO parser.  Its dry-run (``launch/dryrun.py``) runs the step
itself on fake tensors, sharded with DTensor over a fake process group, and
``OpTrace`` -- a ``TorchDispatchMode`` -- records every op the per-device
program dispatches, with its local shapes.  ``analyze(trace)`` prices that
record into the reference's ``HloCosts`` fields (``OpCosts``):

  * flops: matrix products and convolutions, as PyTorch's
    ``torch.utils.flop_counter`` counts them, plus the tensor-core work of
    each hand-written kernel (flash attention's); the reference counts dot
    and convolution flops alone;
  * fp32 flops: the FP32-pipe instructions of the kernels that run outside
    the tensor cores (the selective scan's), priced apart at the FP32 rate;
  * HBM bytes: operands plus outputs of every op that is not a view or
    metadata -- in eager PyTorch each op is its own kernel, so that is what
    crosses HBM (the reference's fusion boundaries).  In-place writes into a
    slice (``copy_``, ``index_put_``, ``index_copy_``, ``scatter_``) move
    twice the slice, as the reference's dynamic-update-slice rules;
  * collective bytes and counts: operand bytes of each ``c10d_functional``
    collective (and of each collective of a ``BookingMesh``, the
    ``launch/mesh.py`` mesh the federated step's dry-run runs on, which
    books its own), under the reference's kind names;
  * ``max_while_trip``: the layer count walked, since the port loops in
    Python where the reference scans.

The kernels are booked, never expanded: flash attention, the selective scan
and their backward kernels are ``torch.library`` operators
(``repro_torch::flash_attention`` and the rest), each traced as one op that
carries the work ``kernels/work.py`` counts for it.

A program that holds every shard of a mesh on one device (the federation
step, ``launch/mesh.py``) records the whole mesh's ops; ``OpTrace.shards``
divides its flops and bytes back to one shard's, while its collectives book
one shard's operands already.

The three roofline terms divide by one H100 SXM's published peaks at its
700 W limit (NVIDIA's data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s of HBM,
80 GB):

    compute_s    = flops_per_dev / 989e12 + fp32_flops_per_dev / 67e12
    memory_s     = hbm_bytes_per_dev / 3.35e12
    collective_s = coll_bytes_per_dev / 50e9

(67 TFLOP/s: float32 outside the tensor cores, the same data sheet; the
two compute terms add, as the kernels run one after another.)

Both production meshes have axes of 16 cards, so every collective on them
leaves an 8-card NVLink host (450 GB/s each way inside it): the collective
term divides by the host network's rate per card, one 400 Gb/s ConnectX-7
port per GPU as in NVIDIA's DGX H100 (50 GB/s).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import work as W
from repro_torch.launch.mesh import Mesh

PEAK_FLOPS = 989e12       # bf16 dense, one H100 SXM at 700 W
PEAK_FP32 = 67e12         # float32 outside the tensor cores, the same card
HBM_BW = 3.35e12          # bytes/s, HBM3
HBM_CAP = 80e9            # bytes of HBM
LINK_BW = 50e9            # bytes/s/card over the host network (ConnectX-7)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d_functional collectives (native and legacy names) -> reference kind
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",     # permute_tensor too
    "shard_dim_alltoall": "all-to-all",     # DTensor's shard-to-shard move
}
_FUNCOL_NS = ("_c10d_functional", "c10d_functional", "_dtensor")
# ops that allocate or describe without moving data
_METADATA = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_unsafe_view", "_local_scalar_dense", "wait_tensor",
             "is_same_size", "set_", "resize_"}
# in-place writes into a slice, whose last tensor argument is the slice:
# twice the slice (read it, write it)
_SLICE_WRITES = {"copy_", "index_put_", "index_copy_", "scatter_",
                 "scatter_add_", "index_add_", "masked_scatter_"}
# in-place fills: the write only
_FILLS = {"fill_", "zero_", "normal_", "uniform_", "random_"}
_KERNEL_NS = "repro_torch"
# kernel ops whose work runs on the FP32 pipe, not the tensor cores
_FP32_KERNELS = ("ssm_scan",)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(xs) -> list:
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def _spec(t) -> list:
    return [list(t.shape), t.element_size()]


@dataclass
class OpTrace:
    """The ops of one per-device program: one record per op, a dict with
    ``op`` (name), ``kind`` (``compute``, ``view``, ``write``, ``fill``,
    ``kernel`` or ``collective``), ``in``/``out`` (``[shape, itemsize]`` of
    each tensor), ``flops`` for matrix products, ``coll`` and ``bytes`` for
    collectives, ``kernel`` and ``args`` (its scalars) for kernel ops.
    ``shards``: the mesh shards the program holds (1 for a per-device
    program); ``layers``: the layer count walked; ``peak_bytes``: the most
    local bytes live at once, ``base_bytes`` of them live before the
    program (its arguments)."""

    records: list = field(default_factory=list)
    shards: int = 1
    layers: int = 0
    peak_bytes: int = 0
    base_bytes: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "OpTrace":
        return cls(**d)


def lru_cached(fn):
    """``fn`` behind DTensor's own cache of sharding decisions (a
    per-thread LRU cache in the PyTorch releases that have one)."""
    try:
        from torch.distributed.tensor._sharding_prop import LocalLRUCache
    except ImportError:
        import functools

        return functools.lru_cache(None)(fn)
    return LocalLRUCache(fn)


_ACTIVE: list = []        # the recording modes entered, innermost last
_PAUSED = [0]             # > 0: ops run for bookkeeping, not by the program


@contextlib.contextmanager
def paused():
    """Ops dispatched inside are not the program's (bookkeeping on the side,
    such as DTensor's sharding propagation): they are not recorded."""
    _PAUSED[0] += 1
    try:
        yield
    finally:
        _PAUSED[0] -= 1


def book_collective(kind: str, nbytes: int) -> None:
    """Book one collective of ``kind`` moving ``nbytes`` operand bytes per
    shard into the trace being recorded, if any (``BookingMesh``'s
    collectives, which run as tensor permutations on one device)."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective kind {kind!r}")
    if _ACTIVE:
        _ACTIVE[-1].trace.records.append(
            {"op": f"mesh.{kind}", "kind": "collective", "coll": kind,
             "bytes": int(nbytes)})


class BookingMesh(Mesh):
    """A ``launch/mesh.py`` mesh whose collectives book what they would move
    between cards into the trace being recorded: their operand bytes per
    shard, under the reference's kind names, one axis at a time as the
    tiled collective moves the data (a gather over ``("model", "data")``
    moves a shard's block, then a block ``m`` times larger)."""

    @staticmethod
    def _shard_bytes(x: torch.Tensor, itemsize: "int | None" = None) -> int:
        """Bytes of one shard's block of ``x`` (its leading two dimensions
        index the shards)."""
        return x.numel() // (x.shape[0] * x.shape[1]) * (itemsize or x.element_size())

    def all_to_all(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        book_collective("all-to-all", self._shard_bytes(x))
        return super().all_to_all(x, axis)

    def all_gather(self, x: torch.Tensor, axes: tuple = ("model", "data")) -> torch.Tensor:
        block = self._shard_bytes(x)
        for a in axes:
            book_collective("all-gather", block)
            block *= self.shape[a]
        return super().all_gather(x, axes)

    def psum(self, x: torch.Tensor, axes: tuple = ("model", "data")) -> torch.Tensor:
        for _ in axes:              # an int32 sum
            book_collective("all-reduce", self._shard_bytes(x, 4))
        return super().psum(x, axes)


def book_op(func, args, kwargs, out) -> None:
    """Record ``func`` by hand into the trace being recorded, if any: an
    in-place write that fake tensors cannot run in some PyTorch releases,
    whose shapes are all the trace needs."""
    if _ACTIVE and not _PAUSED[0]:
        _ACTIVE[-1]._record(func, args, kwargs or {}, out)


class record_ops(TorchDispatchMode):
    """``with record_ops(shards=, base_bytes=) as trace:`` records every op
    dispatched inside into ``trace`` (an ``OpTrace``).  DTensor ops are let
    through (``NotImplemented``), so the mode sees what DTensor runs on each
    shard: the local ops and the collectives its redistributions insert.
    ``base_bytes``: one shard's bytes live before the block (params,
    optimizer state, inputs), counted into the peak."""

    def __init__(self, shards: int = 1, base_bytes: int = 0):
        super().__init__()
        self.trace = OpTrace(shards=shards)
        self._live = base_bytes
        self.trace.peak_bytes = self.trace.base_bytes = base_bytes

    def __enter__(self):
        from torch.distributed.tensor import DTensor

        # DTensor's sharding propagation runs each op once on global shapes
        # to learn its output: those runs are not the program's
        prop = DTensor._op_dispatcher.sharding_propagator
        self._prop = (prop, prop.propagate_op_sharding_non_cached,
                      prop.propagate_op_sharding)
        inner = prop.propagate_op_sharding_non_cached

        def propagate(op_schema):
            with paused():
                return inner(op_schema)

        prop.propagate_op_sharding_non_cached = propagate
        prop.propagate_op_sharding = lru_cached(propagate)
        _ACTIVE.append(self)
        super().__enter__()
        return self.trace

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)
            prop, *funcs = self._prop
            prop.propagate_op_sharding_non_cached, \
                prop.propagate_op_sharding = funcs

    def _alloc(self, outs) -> None:
        for t in outs:
            n = _nbytes(t) // self.trace.shards
            self._live += n
            weakref.finalize(t, self._free, n)
        self.trace.peak_bytes = max(self.trace.peak_bytes, self._live)

    def _free(self, n: int) -> None:
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.OpOverload) and not _PAUSED[0]:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors([out])
        rec = {"op": str(func), "in": [_spec(t) for t in ins],
               "out": [_spec(t) for t in outs]}
        if ns in _FUNCOL_NS:
            kind = _FUNCOL_KIND.get(name)
            if kind is None:
                return                      # wait_tensor, broadcast setup
            rec.update(kind="collective", coll=kind,
                       bytes=sum(_nbytes(t) for t in ins))
        elif ns == _KERNEL_NS:
            rec.update(kind="kernel", kernel=name,
                       args=[a for a in args
                             if isinstance(a, (bool, int, float))])
        elif func.is_view or name in _METADATA or ns == "prim":
            rec["kind"] = "view"
        elif name in _SLICE_WRITES:
            rec["kind"] = "write"
        elif name in _FILLS:
            rec["kind"] = "fill"
        else:
            rec["kind"] = "compute"
            from torch.utils.flop_counter import flop_registry

            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                rec["flops"] = int(count(*args, **kwargs, out_val=out))
        if rec["kind"] in ("compute", "kernel", "collective") \
                and not name.endswith("_"):
            self._alloc(outs)
        self.trace.records.append(rec)


# ---------------------------------------------------------------------------
# pricing a trace
# ---------------------------------------------------------------------------

@dataclass
class OpCosts:
    """The reference's ``HloCosts`` fields, per device, ``by_op``: each op
    name's (flops, HBM bytes) summed over the trace (a kernel's flops on
    whichever pipe it runs), and ``fp32_flops``: the FP32-pipe kernels'
    work, not in ``flops``."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    by_collective: dict = field(default_factory=dict)
    collective_count: dict = field(default_factory=dict)
    max_while_trip: int = 0
    by_op: dict = field(default_factory=dict)
    fp32_flops: float = 0.0


def _spec_bytes(spec) -> int:
    shape, itemsize = spec
    return math.prod(shape) * itemsize


def kernel_work(rec: dict) -> W.Work:
    """The work of one kernel op of a trace, by ``kernels/work.py``."""
    name = rec["kernel"]
    if name.startswith("flash_attention"):
        (qs, item), (ks, _) = rec["in"][0], rec["in"][1]
        B, S, H, hd = qs
        KV = ks[2]
        causal, window = bool(rec["args"][0]), int(rec["args"][1])
        if name == "flash_attention_bwd":
            return W.flash_attention_bwd(B, S, H, KV, hd, causal=causal,
                                         window=window, itemsize=item)
        return W.flash_attention(B, S, H, KV, hd, causal=causal,
                                 window=window, itemsize=item,
                                 with_lse=name == "flash_attention_fwd")
    if name.startswith("ssm_scan"):
        B, S, N = rec["in"][1][0]
        D = rec["in"][3][0][2]
        if name == "ssm_scan_bwd":
            return W.ssm_scan_bwd(B, S, D, N, n_chunk=rec["in"][5][0][1],
                                  dh_last=len(rec["in"]) > 7)
        keep = W.n_chunks(S) if name == "ssm_scan_fwd" else 0
        return W.ssm_scan(B, S, D, N, keep_chunks=keep)
    raise ValueError(f"no work count for kernel op {rec['op']}")


def analyze(trace: OpTrace) -> OpCosts:
    costs = OpCosts(max_while_trip=trace.layers)
    per = float(trace.shards)
    for rec in trace.records:
        kind = rec["kind"]
        if kind == "collective":
            b = rec["bytes"]
            c = rec["coll"]
            costs.collective_bytes += b
            costs.by_collective[c] = costs.by_collective.get(c, 0.0) + b
            costs.collective_count[c] = costs.collective_count.get(c, 0) + 1
            continue
        if kind == "view":
            continue
        flops = 0
        if kind == "kernel":
            w = kernel_work(rec)
            flops, nbytes = w.flops, w.bytes
        elif kind == "write":
            nbytes = 2 * _spec_bytes(rec["in"][-1])
        elif kind == "fill":
            nbytes = sum(_spec_bytes(s) for s in rec["out"])
        else:
            flops = rec.get("flops", 0)
            nbytes = (sum(_spec_bytes(s) for s in rec["in"])
                      + sum(_spec_bytes(s) for s in rec["out"]))
        if kind == "kernel" and rec["kernel"].startswith(_FP32_KERNELS):
            costs.fp32_flops += flops / per
        else:
            costs.flops += flops / per
        costs.hbm_bytes += nbytes / per
        row = costs.by_op.setdefault(rec["op"], [0.0, 0.0])
        row[0] += flops / per
        row[1] += nbytes / per
    return costs


def counter_flops(trace: OpTrace) -> float:
    """Per-device flops that PyTorch's flop counter alone sees in the
    trace: matrix products, the kernels not booked."""
    return sum(r.get("flops", 0) for r in trace.records) / trace.shards


def top_ops(costs: OpCosts, n: int = 8) -> dict:
    """The ``n`` ops with the most HBM bytes and the ``n`` with the most
    flops: ``{"bytes": {op: bytes}, "flops": {op: flops}}``."""
    by = costs.by_op
    return {"bytes": {k: by[k][1] for k in sorted(by, key=lambda k: -by[k][1])[:n]},
            "flops": {k: by[k][0] for k in sorted(by, key=lambda k: -by[k][0])[:n]
                      if by[k][0]}}


# ---------------------------------------------------------------------------
# roofline report (the reference's, line for line)
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    """One cell's roofline.  ``xla_flops_reported`` / ``xla_bytes_reported``
    keep the reference's keys: no compiler reports costs in the port, so
    the dry-run sets the flops to what PyTorch's flop counter alone sees
    (``counter_flops``: matrix products, the kernels not booked) and the
    bytes to 0.  ``fp32_flops_per_dev`` (the port's own key, 0 where no
    kernel runs on the FP32 pipe) adds its time at ``PEAK_FP32`` to the
    compute term; the useful-flops fraction counts ``flops_per_dev``
    alone, as the reference's."""

    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_dev: float
    hbm_bytes_per_dev: float
    collective_bytes_per_dev: float
    model_flops_total: float
    xla_flops_reported: float
    xla_bytes_reported: float
    by_collective: dict[str, float]
    memory_per_dev_bytes: float = 0.0
    max_while_trip: int = 0
    fp32_flops_per_dev: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS + self.fp32_flops_per_dev / PEAK_FP32

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_dev / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_dev / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        hw = self.flops_per_dev * self.n_chips
        return self.model_flops_total / hw if hw else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-time / dominant-term-time: how close the traced
        program runs to the pure-compute roofline of the useful math."""
        ideal = self.model_flops_total / (self.n_chips * PEAK_FLOPS)
        actual = max(self.compute_s, self.memory_s, self.collective_s)
        return ideal / actual if actual else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_chips": self.n_chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "flops_per_dev": self.flops_per_dev,
            "hbm_bytes_per_dev": self.hbm_bytes_per_dev,
            "collective_bytes_per_dev": self.collective_bytes_per_dev,
            "model_flops_total": self.model_flops_total,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "xla_flops_reported": self.xla_flops_reported,
            "xla_bytes_reported": self.xla_bytes_reported,
            "by_collective": self.by_collective,
            "memory_per_dev_bytes": self.memory_per_dev_bytes,
            "max_while_trip": self.max_while_trip,
            "fp32_flops_per_dev": self.fp32_flops_per_dev,
        }


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs: 6·N_active·tokens for training, 2·N_active·tokens
    (+ KV-cache attention reads) for decode/prefill."""
    n_act = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        flops = 6.0 * n_act * B * S
        flops += _attn_flops(cfg, B, S, train=True) * 3  # fwd + bwd(2x)
    elif shape.kind == "prefill":
        flops = 2.0 * n_act * B * S + _attn_flops(cfg, B, S, train=False)
    else:  # decode: one token against S_ctx cache
        flops = 2.0 * n_act * B
        flops += _attn_decode_flops(cfg, B, S)
    return flops


def _attn_layers(cfg) -> int:
    return sum(1 for i in range(cfg.n_layers) if cfg.mixer_of(i) in ("g", "l"))


def _attn_flops(cfg, B, S, train: bool) -> float:
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.mixer_of(i)
        if kind not in ("g", "l"):
            continue
        ctx = min(S, cfg.local_window) if (kind == "l" and cfg.local_window) else S
        # qk^T and att@v: 2 * 2 * B * S * ctx * H * hd, causal halves it
        total += 2.0 * B * S * ctx * cfg.n_heads * cfg.hd
    return total


def _attn_decode_flops(cfg, B, S_ctx) -> float:
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.mixer_of(i)
        if kind not in ("g", "l"):
            continue
        ctx = min(S_ctx, cfg.local_window) if (kind == "l" and cfg.local_window) else S_ctx
        total += 4.0 * B * ctx * cfg.n_heads * cfg.hd
    return total
