"""Sharding rules: parameter/cache/batch partition specs for the production
meshes (Megatron-style TP over ``model``, optional FSDP over ``data``, DP
over ``pod`` × ``data``), the reference's ``models/sharding.py`` over the
port's trees, and their DTensor form.

A ``PartitionSpec`` is plain data, as the reference's: per tensor
dimension an axis name, a tuple of axis names (sharded over their product,
the first outermost) or ``None`` (replicated).  The rules are the
reference's, line for line, over the port's per-layer params
(``params["layers"][i]``: no leading group dimension, so the reference's
``groups`` branch becomes "no leading ``None``") and its list of per-layer
decode caches (the enc-dec ``{"enc_out"}`` entry last).

``to_placements(mesh, spec)`` turns a spec into DTensor placements over a
``DeviceMesh`` (the counterpart of ``NamedSharding``): ``Shard(dim)`` on
each mesh dimension that shards tensor dimension ``dim``, ``Replicate()``
on the rest.  DTensor splits a dimension sharded over several mesh
dimensions in mesh order, the first outermost; the specs here always list
their axes in mesh order, so the layouts agree (``to_placements`` raises on
one that does not).  Where a dimension does not divide, DTensor shards it
unevenly (the first shards one row longer) where GSPMD pads.

``register_kernel_rules()`` gives DTensor the hand-written kernels'
sharding rules: flash attention shards over batch or over query heads (each
shard with its query heads' KV heads, so only where both head counts
divide), the selective scan over batch or channels (``bt``/``ct``
replicated, their gradients partial sums).  Replicating every input is
always valid and is offered too.
"""
from __future__ import annotations

from repro_torch.common.tree import named_leaves, path_name, tree_from_paths
from repro_torch.config.base import ArchConfig, ShapeConfig

MODEL = "model"


class PartitionSpec:
    """``PartitionSpec("model", None)``: one entry per tensor dimension,
    iterable and indexable like the tuple of its entries.  Not a tuple
    itself, so a tree of specs keeps each spec as one leaf."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self.axes == other.axes

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.axes!r}"


P = PartitionSpec


def _rule(path: str, shape: tuple[int, ...], fsdp: str | None) -> P:
    """PartitionSpec for one parameter leaf (without the scan group dim)."""
    nd = len(shape)
    f = fsdp

    def has(*names: str) -> bool:
        return any(n in path for n in names)

    if has("embed") and nd == 2:
        return P(MODEL, None)
    if has("lm_head"):
        return P(None, MODEL)
    if has("pos", "enc_pos") and nd == 2:
        return P(None, None)
    if has("router"):
        return P(None, None)
    # MoE experts: EP over the expert dim
    if nd == 3 and has("ffn"):
        if has("wo"):
            return P(MODEL, None, f)
        return P(MODEL, f, None)
    if has("shared_wo"):
        return P(MODEL, f)
    if has("shared_wi", "shared_wg"):
        return P(f, MODEL)
    # MLA
    if has("wdq", "wdkv"):
        return P(f, None)
    if has("wkr"):
        return P(None, None)
    if has("wuq", "wuk", "wuv"):
        return P(None, MODEL)
    # Mamba
    if has("in_proj"):
        return P(f, MODEL)
    if has("conv_w"):
        return P(None, MODEL)
    if has("x_proj", "A_log", "out_proj") and nd == 2:
        return P(MODEL, f if has("out_proj") else None)
    if has("dt_proj"):
        return P(None, MODEL)
    if has("conv_b", "dt_bias") and nd == 1:
        return P(MODEL)
    if path.endswith("D") and nd == 1:
        return P(MODEL)
    # attention / dense mlp
    if has("wq", "wk", "wv", "wi", "wg") and nd == 2:
        return P(f, MODEL)
    if has("wo") and nd == 2:
        return P(MODEL, f)
    if has("bq", "bk", "bv") and nd == 1:
        return P(MODEL)
    return P(*([None] * nd))  # norms, scalars


def _drop_indivisible(spec: P, shape: tuple[int, ...], mesh_sizes: dict | None) -> P:
    """Explicitly-sharded jit arguments must divide evenly; drop axes that
    don't (e.g. whisper's 51865 vocab over 16-way model)."""
    if mesh_sizes is None:
        return spec
    out = []
    for dim, axes in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            out.append(None)
            continue
        ax_tuple = axes if isinstance(axes, tuple) else (axes,)
        size = 1
        for a in ax_tuple:
            size *= mesh_sizes.get(a, 1)
        out.append(axes if shape[dim] % size == 0 else None)
    return P(*out)


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a DTensor ``DeviceMesh`` or of a mesh with a
    ``shape`` dict (``launch/mesh.py``'s)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def param_specs(cfg: ArchConfig, params, fsdp: bool = True,
                mesh_sizes: dict | None = None):
    """Tree of PartitionSpecs matching the port's params (or a tree laid
    out like them: gradients, AdamW's moments)."""
    f = "data" if fsdp else None
    by_path = {path: _drop_indivisible(_rule(path_name(path), tuple(leaf.shape), f),
                                       tuple(leaf.shape), mesh_sizes)
               for path, leaf in named_leaves(params)}
    return tree_from_paths(params, by_path)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in _axis_names(mesh) if a in ("pod", "data"))


def batch_spec(mesh, shape: ShapeConfig) -> P:
    """Token batches shard over the DP axes (pod × data)."""
    dp = dp_axes(mesh)
    sizes = axis_sizes(mesh)
    B = shape.global_batch
    usable = []
    size = 1
    for a in dp:
        if B % (size * sizes[a]) == 0:
            usable.append(a)
            size *= sizes[a]
    return P(tuple(usable) if usable else None, None)


def activation_spec(mesh, shape: ShapeConfig) -> P:
    dp = batch_spec(mesh, shape)[0]
    return P(dp, None, MODEL)


def cache_specs(cfg: ArchConfig, mesh, shape: ShapeConfig, caches):
    """Decode-cache specs over the port's list of per-layer cache dicts:
    batch over DP axes when divisible, sequence over the model axis (plus
    idle DP axes for tiny batches -- long_500k's B=1 spreads its
    512k-token cache over every chip)."""
    dp = batch_spec(mesh, shape)[0]            # tuple | None
    idle = tuple(a for a in dp_axes(mesh) if dp is None or a not in dp)
    seq_axes = idle + (MODEL,)                 # axes available for seq/feature

    def spec_of(ps: str, nd: int) -> P:
        if "enc_out" in ps:
            return P(dp, None, MODEL)
        if "latent" in ps:                     # (B, S, kv_lora)
            return P(dp, seq_axes, None)
        if "k_rope" in ps:                     # (B, S, 1, rope)
            return P(dp, seq_axes, None, None)
        if "k_scale" in ps or "v_scale" in ps:  # (B, S, KV)
            return P(dp, seq_axes, None)
        if "conv" in ps and nd == 3:           # (B, d_conv-1, d_inner)
            return P(dp, None, seq_axes)
        if "state" in ps:                      # (B, d_inner, N)
            return P(dp, seq_axes, None)
        if nd == 4:                            # attention k/v (B, S, KV, hd)
            return P(dp, seq_axes, None, None)
        return P(*([None] * nd))

    return tree_from_paths(caches, {
        path: spec_of(path_name(path), leaf.dim())
        for path, leaf in named_leaves(caches)})


def to_placements(mesh, spec: P) -> list:
    """DTensor placements of ``spec`` over the ``DeviceMesh`` ``mesh``: per
    mesh dimension ``Shard(d)`` for the tensor dimension ``d`` it shards,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    owner: dict = {}
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        ax_tuple = axes if isinstance(axes, tuple) else (axes,)
        order = [names.index(a) for a in ax_tuple]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: the axes of dimension {dim} are "
                             f"not in mesh order {names}")
        for a in ax_tuple:
            owner[a] = dim
    return [Shard(owner[a]) if a in owner else Replicate() for a in names]


# ---------------------------------------------------------------------------
# the hand-written kernels' sharding rules for DTensor
# ---------------------------------------------------------------------------

def _even(input_specs) -> bool:
    """Every input shards evenly: each sharded dimension divides by the
    product of the mesh dimensions that shard it."""
    for spec in input_specs:
        shape = spec.tensor_meta.shape if spec.tensor_meta is not None else None
        if shape is None:
            continue
        shards = [1] * len(shape)
        for i, p in enumerate(spec.placements):
            if p.is_shard():
                shards[p.dim] *= spec.mesh.size(i)
        if any(s % n for s, n in zip(shape, shards)):
            return False
    return True


def _kernel_strategies():
    """op -> (number of outputs, single-mesh-dim placement lists [outputs...,
    inputs...] as a function of the optional ``dh_last``'s presence)."""
    import torch
    from torch.distributed.tensor import Partial, Replicate, Shard

    R, S0, S1, S2, Pa = Replicate(), Shard(0), Shard(1), Shard(2), Partial()
    ops = torch.ops.repro_torch
    opts = [None, None, None]                  # causal, window, scale
    return {
        ops.flash_attention.default: (1, lambda _: [
            [R, R, R, R] + opts, [S0, S0, S0, S0] + opts,
            [S2, S2, S2, S2] + opts]),
        ops.flash_attention_fwd.default: (2, lambda _: [
            [R, R, R, R, R] + opts, [S0, S0, S0, S0, S0] + opts,
            [S2, S1, S2, S2, S2] + opts]),
        ops.flash_attention_bwd.default: (3, lambda _: [
            [R] * 9 + opts, [S0] * 9 + opts,
            [S2, S2, S2, S2, S2, S2, S2, S2, S1] + opts]),
        ops.ssm_scan.default: (2, lambda _: [
            [R] * 7, [S0, S0, S0, S0, S0, S0, R],
            [S2, S1, S2, R, R, S2, S0]]),
        ops.ssm_scan_fwd.default: (3, lambda _: [
            [R] * 8, [S0, S0, S0, S0, S0, S0, S0, R],
            [S2, S1, S2, S2, R, R, S2, S0]]),
        ops.ssm_scan_bwd.default: (5, lambda has_dh: [
            [R] * 12 + [R if has_dh else None],
            [S0, S0, S0, S0, Pa, S0, S0, S0, S0, R, S0, S0]
            + [S0 if has_dh else None],
            [S2, Pa, Pa, S2, S0, S2, R, R, S2, S0, S2, S2]
            + [S1 if has_dh else None]]),
    }


_REGISTERED: list = []


def register_kernel_rules() -> None:
    """Register the kernels' sharding rules with DTensor (once)."""
    if _REGISTERED:
        return
    import repro_torch.kernels  # noqa: F401  (defines the operators)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops.utils import \
        expand_to_full_mesh_op_strategy

    prop = DTensor._op_dispatcher.sharding_propagator
    for op, (n_out, lists) in _kernel_strategies().items():
        args = op._schema.arguments
        scalars = [i for i, a in enumerate(args)
                   if str(a.type) in ("bool", "int", "float")]

        def strategy(op_schema, n_out=n_out, lists=lists):
            has_dh = (len(op_schema.args_schema) > 7
                      and op_schema.args_schema[7] is not None)
            mesh = next(a.mesh for a in op_schema.args_schema
                        if hasattr(a, "mesh"))
            st = expand_to_full_mesh_op_strategy(
                mesh, op_schema, lists(has_dh), input_index=n_out)
            even = [s for s in st.strategies if _even(s.input_specs)]
            st.strategies = even or st.strategies
            return st

        prop.register_op_strategy(op, strategy, RuntimeSchemaInfo(
            min(scalars) if scalars else 100, needs_pytree=True))
    _REGISTERED.append(True)
