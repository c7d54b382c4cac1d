"""Multi-pod dry-run: lay out every (architecture × input shape) on the
production meshes and price the per-device program on an H100 roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both \\
        --out results/dryrun_torch.json

The reference lowers each step with XLA's SPMD partitioner on 256 or 512
fake devices.  The port shards each step with DTensor over a fake process
group (``torch.testing._internal.distributed.fake_pg``: one process, no
memory, collectives that move nothing) on fake tensors: params by
``models/sharding.param_specs``, the batch by ``batch_spec``, decode caches
by ``cache_specs``, over a ``(16, 16)`` or ``(2, 16, 16)`` ``DeviceMesh``.
DTensor's sharding propagation inserts the collectives; tensors the model
makes inside (positions, masks, rope tables) count as replicated
(``implicit_replication``).  ``launch/roofline.record_ops`` records the ops
each shard runs and ``roofline.analyze`` prices them.  The federated query
step (``engine/distributed.fed_dryrun_lower``) runs on the port's own
one-device mesh instead, whose collectives book themselves.

The output is the reference's schema, key for key (``Roofline.to_dict()``
plus ``status``, ``compile_s``, ``memory_analysis``, ``param_bytes_per_dev``,
``collective_counts``, ``hlo_bytes``), so ``benchmarks/roofline_bench.run``
reads it; here ``compile_s`` is the trace's time and ``hlo_bytes`` the
size of the op trace, cached gzipped under ``results/optrace/`` for
``--reanalyze``.  Each cell also carries ``top_ops``, the ops with the most
bytes and flops, ``fp32_flops_per_dev`` (the scan kernels' FP32-pipe work,
in the compute term), ``torch`` (the release it ran on) and, for the
models, ``replicated_ops`` and ``dtensor_patches`` (``DryRunLog``): DTensor
differs between releases, and so may a cell's layout.  The process group
is set up per mesh inside ``lower_cell``, never on import.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import itertools
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common.tree import (get_path, leaves, named_leaves,
                                     tree_from_paths, tree_map)
from repro_torch.config.base import SHAPES, PerfFlags
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import roofline as RL
from repro_torch.models import model as MDL
from repro_torch.models import sharding as SH

_TRACE_DIR = "results/optrace"


def _tag(arch: str, shape: str, mesh: str, optimized: bool) -> str:
    return f"{arch}__{shape}__{mesh}{'__opt' if optimized else ''}"


def _cache_trace(tag: str, trace: RL.OpTrace) -> int:
    """Persist the op trace (gzip) so analyzer changes re-analyze without
    tracing again (see --reanalyze); returns its size in bytes."""
    os.makedirs(_TRACE_DIR, exist_ok=True)
    text = json.dumps(trace.to_json())
    with gzip.open(f"{_TRACE_DIR}/{tag}.json.gz", "wt") as f:
        f.write(text)
    return len(text)


def _row(arch: str, shape: str, mesh: str, n_chips: int, trace: RL.OpTrace,
         model_flops_total: float) -> dict:
    """The cell's priced terms: ``Roofline.to_dict()`` plus the collective
    counts and the ops with the most bytes and flops."""
    costs = RL.analyze(trace)
    rf = RL.Roofline(
        arch=arch, shape=shape, mesh=mesh, n_chips=n_chips,
        flops_per_dev=costs.flops,
        hbm_bytes_per_dev=costs.hbm_bytes,
        collective_bytes_per_dev=costs.collective_bytes,
        model_flops_total=model_flops_total,
        xla_flops_reported=RL.counter_flops(trace),
        xla_bytes_reported=0.0,
        by_collective=costs.by_collective,
        memory_per_dev_bytes=float(trace.peak_bytes),
        max_while_trip=costs.max_while_trip,
        fp32_flops_per_dev=costs.fp32_flops,
    )
    return {**rf.to_dict(), "collective_counts": costs.collective_count,
            "top_ops": RL.top_ops(costs)}


def reanalyze(out_path: str) -> None:
    """Recompute roofline terms from cached op traces into an existing
    results json (after analyzer refinements)."""
    with open(out_path) as f:
        results = json.load(f)
    opt = out_path.endswith("_opt.json")
    for key, r in results.items():
        if r.get("status") != "ok":
            continue
        path = f"{_TRACE_DIR}/{_tag(*key.split('|'), opt)}.json.gz"
        if not os.path.exists(path):
            continue
        with gzip.open(path, "rt") as f:
            trace = RL.OpTrace.from_json(json.load(f))
        r.update(_row(r["arch"], r["shape"], r["mesh"], r["n_chips"], trace,
                      r["model_flops_total"]))
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"reanalyzed {out_path}")


def cell_skip_reason(arch_id: str, shape_name: str) -> str | None:
    cfg = get_arch(arch_id)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return "full attention is quadratic at 500k (DESIGN.md §4)"
    return None


def optimized_flags(cfg, shape):
    """Per-cell beyond-baseline switches (EXPERIMENTS.md §Perf)."""
    return PerfFlags(
        chunked_attention=shape.kind != "decode",
        attn_chunk=1024,
        chunked_loss=shape.kind == "train",
        loss_chunk=512,
        mamba_chunk=512 if cfg.ssm is not None else 0,
        mla_absorb=cfg.mla is not None,
        seq_parallel=shape.kind != "decode",
        kv_quant_int8=shape.kind == "decode" and cfg.mla is None,
    )


def production_mesh_shape(multi_pod: bool) -> "tuple[tuple, tuple]":
    """(sizes, axis names) of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


@contextlib.contextmanager
def fake_mesh(sizes: tuple, names: tuple):
    """A ``DeviceMesh`` of ``sizes`` over a fake process group of that many
    ranks, this process rank 0; torn down on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", rank=0, world_size=math.prod(sizes),
                            store=FakeStore())
    try:
        yield init_device_mesh("cpu", tuple(sizes), mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class DryRunLog:
    """What ``dtensor_dry_run`` did in one cell: ``replicated``, each op
    that ran on replicated inputs and how often (once for each layout of
    its inputs: DTensor caches the decision); ``patches``, each DTensor
    internal it replaces, under ``Owner.name``, and whether the installed
    release has it (releases differ, and so may a cell's layout)."""

    replicated: dict = dataclasses.field(default_factory=dict)
    patches: dict = dataclasses.field(default_factory=dict)


def _patch(stack: contextlib.ExitStack, log: DryRunLog, obj, name: str, make,
           required: bool = False) -> None:
    """Replace ``obj.name`` by ``make(old)`` until ``stack`` closes, where
    ``obj`` has it, and record in ``log.patches`` whether it had; a
    ``required`` one that the release lacks raises."""
    owner = getattr(obj, "__name__", type(obj).__name__).rsplit(".", 1)[-1]
    key = f"{owner}.{name}"
    old = getattr(obj, name, None)
    log.patches[key] = old is not None
    if old is None:
        if required:
            raise RuntimeError(f"torch {torch.__version__}: DTensor has no "
                               f"{key}, which the dry-run needs")
        return
    setattr(obj, name, make(old))
    stack.callback(setattr, obj, name, old)


def _mesh_of(op_schema):
    for a in op_schema.args_schema:
        for x in (a if isinstance(a, (list, tuple)) else (a,)):
            if hasattr(x, "mesh") and hasattr(x, "placements"):
                return x.mesh
    raise ValueError(f"no DTensor argument in {op_schema}")


def _output_sharding(spec, schema, use_val: bool = False):
    """An ``OutputSharding`` of ``spec`` that redistributes the inputs to
    ``schema`` first."""
    from torch.distributed.tensor._op_schema import OutputSharding

    kw = {"redistribute_schema": schema, "needs_redistribute": True}
    if "use_val_from_redistribute_schema" in {
            f.name for f in dataclasses.fields(OutputSharding)}:
        kw["use_val_from_redistribute_schema"] = use_val
    return OutputSharding(spec, **kw)


@contextlib.contextmanager
def dtensor_dry_run(log: DryRunLog):
    """DTensor set up as the dry-run needs it on a fake CPU mesh, what it
    did recorded in ``log``.

    * Where DTensor has no sharding strategy for an op on its inputs'
      placements (a sharded dimension split unevenly into heads, an op
      with no rule, a view whose propagated shard would not hold its
      input's elements), the op runs on replicated inputs instead: always
      valid, and it shows up honestly as the collectives that replicate
      them, on as few mesh dimensions as it takes.  An in-place op keeps
      its target's placements (each shard writes its part, the indices and
      values replicated).  ``log.replicated`` counts each such op.
    * A shard-to-shard move is one all-to-all, as on the card's NCCL mesh
      (DTensor would take an all-gather on a CPU mesh, for Gloo).
    * The index arithmetic of a strided shard runs on real tensors: on
      fake ones DTensor's own helper asks for their values.
    * A vocabulary-parallel gather's mask (values only, which fake tensors
      do not have) is skipped where DTensor applies it to a view of the
      gather's output of another rank (its ``MaskBuffer`` fails there).
    """
    import importlib

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    from torch.distributed.tensor._op_schema import OpSchema

    prop = DTensor._op_dispatcher.sharding_propagator
    orig = prop.propagate_op_sharding_non_cached
    tensor_meta = (getattr(prop, "_propagate_tensor_meta_non_cached", None)
                   or prop._propagate_tensor_meta)

    def replicated(x, dims):
        """``x`` with every DTensorSpec replicated on the mesh ``dims``."""
        if isinstance(x, DTensorSpec):
            pl = tuple(Replicate() if i in dims else p
                       for i, p in enumerate(x.placements))
            return DTensorSpec(x.mesh, pl, tensor_meta=x.tensor_meta)
        if isinstance(x, (list, tuple)):
            return type(x)(replicated(v, dims) for v in x)
        if isinstance(x, dict):
            return {k: replicated(v, dims) for k, v in x.items()}
        return x

    def replicated_out(meta, mesh):
        if meta is None:
            return None
        if isinstance(meta, TensorMeta):
            return DTensorSpec(mesh, (Replicate(),) * mesh.ndim,
                               tensor_meta=meta)
        return tuple(replicated_out(m, mesh) for m in meta)

    def decomposes(op) -> bool:
        # DTensor runs such an op by its decomposition when it has no rule
        return torch._C._dispatch_has_kernel_for_dispatch_key(
            op.name(), torch._C.DispatchKey.CompositeImplicitAutograd)

    def local_numel(spec) -> int:
        """Elements of rank 0's shard of ``spec``."""
        n = 1
        for d, size in enumerate(spec.tensor_meta.shape):
            shards = math.prod(spec.mesh.size(i)
                               for i, p in enumerate(spec.placements)
                               if getattr(p, "dim", None) == d
                               and not p.is_replicate() and not p.is_partial())
            n *= -(-size // shards)
        return n

    def sound(op_schema, res) -> bool:
        """A view's shard holds as many elements as its input's: some
        releases propagate a view over two mesh dimensions of one tensor
        dimension to a layout that does not."""
        if op_schema.op.name().split("::")[-1] not in ("view", "_unsafe_view"):
            return True
        src = (res.redistribute_schema or op_schema).args_schema[0]
        out = res.output_spec
        if src.tensor_meta is None or getattr(out, "tensor_meta", None) is None:
            return True
        return local_numel(src) == local_numel(out)

    def propagate(op_schema):
        try:
            res = orig(op_schema)
        except NotImplementedError:
            if decomposes(op_schema.op):
                raise
            return fallback(op_schema)
        # repro: ignore[RPR102] -- DTensor's strategy functions raise many
        # types (RuntimeError, AssertionError, ValueError, IndexError) for a
        # layout they cannot propagate; the op then runs on replicated
        # inputs, and a fallback that fails as well raises
        except Exception:
            return fallback(op_schema)
        return res if sound(op_schema, res) else fallback(op_schema)

    def partial_dims(x) -> set:
        if isinstance(x, DTensorSpec):
            return {i for i, p in enumerate(x.placements) if p.is_partial()}
        if isinstance(x, (list, tuple)):
            return set().union(*(partial_dims(v) for v in x)) if x else set()
        return set()

    def replicated_schema(op_schema, dims, inplace):
        args = replicated(op_schema.args_schema, dims)
        if inplace:             # each shard writes its part of the target
            args = (op_schema.args_schema[0],) + tuple(args[1:])
        return OpSchema(op_schema.op, args,
                        replicated(op_schema.kwargs_schema, dims),
                        schema_info=op_schema.schema_info)

    def fallback(op_schema):
        """Reduce partial sums, then replicate the inputs on as few mesh
        dimensions as it takes, the last (``model``) first."""
        name = str(op_schema.op)
        log.replicated[name] = log.replicated.get(name, 0) + 1
        mesh = _mesh_of(op_schema)
        inplace = op_schema.is_inplace_op()
        order = list(range(mesh.ndim))[::-1]
        partial = partial_dims(op_schema.args_schema)
        tries = [partial | set(c) for k in range(mesh.ndim + 1)
                 for c in itertools.combinations(order, k)
                 if k or partial]
        for dims in tries:
            rep = replicated_schema(op_schema, dims, inplace)
            try:
                res = orig(rep)
            except NotImplementedError:     # no strategy at all
                break
            # repro: ignore[RPR102] -- as in ``propagate``: this replication
            # cannot be propagated either, so the next, wider one is tried
            except Exception:
                continue
            if not sound(rep, res):
                continue
            return _output_sharding(
                res.output_spec, res.redistribute_schema or rep,
                getattr(res, "use_val_from_redistribute_schema", False))
        rep = replicated_schema(op_schema, set(range(mesh.ndim)), inplace)
        out = (op_schema.args_schema[0] if inplace
               else replicated_out(tensor_meta(rep), mesh))
        return _output_sharding(out, rep)

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    def apply_mask(orig_mask):
        def apply(self, tensor):
            if tensor.dim() in (self.data.dim(), self.data.dim() + 1):
                return orig_mask(self, tensor)
        return apply

    def offsets(orig_offsets):
        memo: dict = {}       # pure in its integer arguments

        def local(self, *args, **kwargs):
            key = (self, args, tuple(sorted(kwargs.items())))
            if key not in memo:
                with unset_fake_temporarily(), RL.paused():
                    memo[key] = orig_offsets(self, *args, **kwargs)
            return memo[key]
        return local

    with contextlib.ExitStack() as stack:
        _patch(stack, log, prop, "propagate_op_sharding_non_cached",
               lambda _: propagate, required=True)
        _patch(stack, log, prop, "propagate_op_sharding",
               lambda _: RL.lru_cached(propagate), required=True)
        for mod in ("placement_types", "_redistribute"):   # its importers
            mod = importlib.import_module(f"torch.distributed.tensor.{mod}")
            _patch(stack, log, mod, "shard_dim_alltoall", lambda _: alltoall)
        strided = getattr(importlib.import_module(
            "torch.distributed.tensor.placement_types"), "_StridedShard", None)
        if strided is None:
            log.patches["_StridedShard.local_shard_size_and_offset"] = False
        else:
            _patch(stack, log, strided, "local_shard_size_and_offset", offsets)
        mask = None
        for mod in ("_mask_buffer", "_embedding_ops"):
            try:
                mask = importlib.import_module(
                    f"torch.distributed.tensor._ops.{mod}").MaskBuffer
                break
            except (ImportError, AttributeError):
                continue
        if mask is None:
            log.patches["MaskBuffer.apply_mask"] = False
        else:
            _patch(stack, log, mask, "apply_mask", apply_mask)
        yield log


class _FakeProgramOps(TorchDispatchMode):
    """Three kinds of op that fake tensors and DTensor do not run as the
    model needs, answered here:

    * ``bincount`` of the MoE's expert ids, whose output size depends on
      their values: they are below its ``minlength`` (the expert count) by
      construction, so it has ``minlength`` entries;
    * an in-place write into a tensor the model made inside (replicated,
      not a DTensor) from DTensors: those are gathered whole first (their
      all-gathers are booked), as replicating the target needs;
    * an indexed write into a DTensor (a decode cache's new row): each
      shard writes its part, the indices and values gathered whole, outside
      DTensor's own rule for it, which some releases cannot run on fake
      tensors.

    And an in-place write that a PyTorch release's fake tensors cannot run
    (an indexed write whose meta function asks for values) is booked by
    hand and leaves its target as it is: fake tensors hold no values.
    """

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensors = any(issubclass(t, DTensor) for t in types)
        if func is torch.ops.aten.bincount.default and not dtensors:
            n = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
            return torch.zeros(n, dtype=torch.int64, device=args[0].device)
        if not dtensors:
            return self._run(func, args, kwargs)
        whole = lambda x: x.full_tensor() if isinstance(x, DTensor) else x  # noqa: E731
        if func._schema.is_mutable and not isinstance(args[0], DTensor):
            return self._run(func, tree_map(whole, list(args)),
                             {k: tree_map(whole, v) for k, v in kwargs.items()})
        if func is torch.ops.aten.index_put_.default:
            # a cache write: each shard writes its part of the target
            self._run(func, [args[0].to_local()] + tree_map(whole, list(args[1:])),
                      {k: tree_map(whole, v) for k, v in kwargs.items()})
            return args[0]
        return NotImplemented

    @staticmethod
    def _run(func, args, kwargs):
        try:
            return func(*args, **kwargs)
        except RuntimeError as exc:
            if not (func._schema.is_mutable and is_fake(args[0])):
                raise RuntimeError(f"{func} on fake tensors: {exc}") from exc
            RL.book_op(func, args, kwargs, args[0])
            return args[0]


def _local_bytes(tree) -> int:
    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
    return total


def _shard(t, mesh, placements):
    """``t`` as a DTensor of ``placements``, each shard cut locally (no
    scatter from rank 0 where the release can skip it)."""
    from torch.distributed.tensor import distribute_tensor

    try:
        return distribute_tensor(t, mesh, placements, src_data_rank=None)
    except TypeError:           # a release without ``src_data_rank``
        return distribute_tensor(t, mesh, placements)


def _distribute(tree, specs, mesh):
    return tree_map(lambda t, s: _shard(t, mesh, SH.to_placements(mesh, s)),
                    tree, specs)


def _state_specs(state, params, p_specs):
    """Optimizer states mirror their parameter's spec where the shapes
    match (AdamW's moments); the rest (Adafactor's factored rows and
    columns, the step) are replicated, as the reference's."""
    by_param = {path: (leaf.shape, get_path(p_specs, path))
                for path, leaf in named_leaves(params)}
    out = {}
    for path, leaf in named_leaves(state):
        spec = SH.P(*([None] * leaf.dim()))
        for start in range(len(path)):
            hit = by_param.get(path[start:])
            if hit is not None and tuple(hit[0]) == tuple(leaf.shape):
                spec = hit[1]
                break
        out[path] = spec
    return tree_from_paths(state, out)


def _in_param_layout(update):
    """The optimizer's update with each gradient first moved to its
    parameter's placements (a reduce-scatter of a partial sum, as data
    parallel training reduces gradients), where the state mirrors them."""

    def update_(grads, state, params):
        grads = tree_map(lambda g, p: g.redistribute(p.device_mesh,
                                                     p.placements),
                         grads, params)
        return update(grads, state, params)

    return update_


def _fake_like(meta: torch.Tensor) -> torch.Tensor:
    return torch.empty(meta.shape, dtype=meta.dtype)


def trace_cell(cfg, shape, mesh, optimized: bool = False):
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (a ``DeviceMesh``
    over a fake process group): ``(op trace, param bytes in all,
    DryRunLog)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step

    SH.register_kernel_rules()
    sizes = SH.axis_sizes(mesh)
    dtype = torch.bfloat16
    if optimized:
        cfg = dataclasses.replace(cfg, perf=optimized_flags(cfg, shape))
        if cfg.perf.seq_parallel and shape.seq_len % sizes["model"] == 0:
            dp = SH.batch_spec(mesh, shape)[0]
            sp = SH.to_placements(mesh, SH.P(dp, "model", None))

            def policy(x, kind):
                if (kind == "residual" and x.dim() == 3
                        and x.shape[1] == shape.seq_len):
                    return x.redistribute(mesh, sp)
                return x

            MDL.set_activation_policy(policy)
    try:
        with FakeTensorMode():
            params = MDL.init_params(cfg, torch.Generator(), dtype, "cpu")
            param_bytes = sum(t.numel() * t.element_size()
                              for t in leaves(params))
            p_specs = SH.param_specs(cfg, params, mesh_sizes=sizes)
            bspec = SH.batch_spec(mesh, shape)
            batch = {}
            for k, v in MDL.input_specs(cfg, shape, dtype).items():
                spec = bspec if v.dim() == 2 else SH.P(bspec[0], None, "model")
                batch[k] = _shard(_fake_like(v), mesh,
                                  SH.to_placements(mesh, spec))
            if shape.kind == "train":
                opt = make_optimizer("adafactor" if cfg.param_count() > 1e11
                                     else "adamw", cfg)
                state = opt.init(params)
                opt = dataclasses.replace(opt, update=_in_param_layout(
                    opt.update))
                state = _distribute(state, _state_specs(state, params, p_specs),
                                    mesh)
                params = _distribute(params, p_specs, mesh)
                step = make_train_step(cfg, opt)
                args = (params, state, batch)
            elif shape.kind == "prefill":
                params = _distribute(params, p_specs, mesh)
                step = lambda p, b: MDL.forward(cfg, p, b)[0]  # noqa: E731
                args = (params, batch)
            else:
                caches = MDL.init_decode_caches(cfg, shape.global_batch,
                                                shape.seq_len, dtype, "cpu")
                caches = _distribute(
                    caches, SH.cache_specs(cfg, mesh, shape, caches), mesh)
                params = _distribute(params, p_specs, mesh)
                pos = _shard(torch.zeros((), dtype=torch.int32), mesh,
                             [Replicate()] * len(sizes))

                def step(p, c, b, pos):
                    return MDL.decode_step(cfg, p, c, b["tokens"], pos)[0]

                args = (params, caches, batch, pos)
            grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
            log = DryRunLog()
            with implicit_replication(), grad, dtensor_dry_run(log), \
                    RL.record_ops(base_bytes=_local_bytes(args)) as trace, \
                    _FakeProgramOps():
                step(*args)
    finally:
        MDL.set_activation_policy(None)
    trace.layers = cfg.n_layers
    return trace, param_bytes, log


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool,
               optimized: bool = False) -> dict:
    """Trace and price one cell; with the torch release it ran on and
    ``DryRunLog``'s record (``replicated_ops``, ``dtensor_patches``)."""
    cfg = get_arch(arch_id)
    shape = SHAPES[shape_name]
    sizes, names = production_mesh_shape(multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n_chips = math.prod(sizes)
    t0 = time.time()
    with fake_mesh(sizes, names) as dmesh:
        trace, param_bytes, log = trace_cell(cfg, shape, dmesh, optimized)
    compile_s = time.time() - t0
    size = _cache_trace(_tag(arch_id, shape_name,
                             "multi" if multi_pod else "single", optimized),
                        trace)
    out = _row(arch_id, shape_name, mesh_name, n_chips, trace,
               RL.model_flops(cfg, shape))
    out.update({
        "status": "ok",
        "compile_s": compile_s,
        "memory_analysis": {"argument_bytes": trace.base_bytes,
                            "output_bytes": None,
                            "temp_bytes": trace.peak_bytes - trace.base_bytes,
                            "peak_bytes": trace.peak_bytes},
        "param_bytes_per_dev": param_bytes // n_chips,
        "hlo_bytes": size,
        "torch": torch.__version__,
        "replicated_ops": log.replicated,
        "dtensor_patches": log.patches,
    })
    return out


def lower_fed_cell(multi_pod: bool, optimized: bool = False) -> dict:
    """The paper's own system: canonical federated query step."""
    from repro_torch.engine.distributed import fed_dryrun_lower
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    n_chips = math.prod(mesh.shape.values())
    t0 = time.time()
    trace = fed_dryrun_lower(mesh, cap=8192, table_cap=1 << 20,
                             optimized=optimized)
    compile_s = time.time() - t0
    size = _cache_trace(_tag("odyssey-fed", "fed_query",
                             "multi" if multi_pod else "single", optimized),
                        trace)
    out = _row("odyssey-fed", "fed_query", "2x16x16" if multi_pod else "16x16",
               n_chips, trace, 0.0)
    out.update({"status": "ok", "compile_s": compile_s, "hlo_bytes": size,
                "torch": torch.__version__})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all', or 'odyssey-fed'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present in --out")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the §Perf beyond-baseline flags")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute terms from cached op traces, no tracing")
    args = ap.parse_args(argv)
    if args.reanalyze:
        reanalyze(args.out)
        return

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results: dict[str, dict] = {}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    def save():
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    cells = []
    for mp in meshes:
        for a in archs:
            if a == "odyssey-fed":
                cells.append((a, "fed_query", mp))
                continue
            for s in shapes:
                cells.append((a, s, mp))
        if args.arch == "all":
            cells.append(("odyssey-fed", "fed_query", mp))

    for (a, s, mp) in cells:
        key = f"{a}|{s}|{'multi' if mp else 'single'}"
        if args.resume and key in results and results[key].get("status") in ("ok", "skipped"):
            continue
        if a != "odyssey-fed":
            reason = cell_skip_reason(a, s)
            if reason:
                results[key] = {"status": "skipped", "reason": reason,
                                "arch": a, "shape": s}
                save()
                print(f"SKIP {key}: {reason}", flush=True)
                continue
        print(f"LOWER {key} ...", flush=True)
        try:
            if a == "odyssey-fed":
                results[key] = lower_fed_cell(mp, optimized=args.optimized)
            else:
                results[key] = lower_cell(a, s, mp, optimized=args.optimized)
            r = results[key]
            print(f"  ok in {r['compile_s']:.1f}s: bottleneck={r['bottleneck']} "
                  f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
                  f"collective={r['collective_s']:.4f}s", flush=True)
        # repro: ignore[RPR102] -- per-cell record-and-continue boundary: a
        # long sweep must not die on one (arch, shape, mesh) cell; the error
        # and its traceback are kept in --out and counted in the summary
        except Exception as exc:
            results[key] = {"status": "error", "error": str(exc)[:2000],
                            "trace": traceback.format_exc()[-2000:],
                            "arch": a, "shape": s}
            print(f"  ERROR {key}: {exc}", flush=True)
        save()

    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_err = sum(1 for r in results.values() if r.get("status") == "error")
    n_skip = sum(1 for r in results.values() if r.get("status") == "skipped")
    print(f"dryrun: {n_ok} ok, {n_skip} skipped, {n_err} errors", flush=True)


if __name__ == "__main__":
    main()
