"""The port's sharding rules (``repro_torch.models.sharding``) and the
dry-run's ``input_specs`` against the reference's, at full published
widths: every architecture's parameter specs (the port's leaf of layer
``i`` against the reference's stacked leaf without its group axis) and
decode-cache specs under the sizes of both production meshes, the batch and
activation specs, every architecture's and shape's input specs; then
``to_placements`` on a 2 x 2 fake DTensor mesh against the local shapes a
DTensor gets.  Shapes only: no weights are drawn (the port's trees are fake
tensors, the reference's ``eval_shape`` structs).  Exact."""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.config.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import model as RMDL  # noqa: E402
from repro.models import sharding as RSH  # noqa: E402
from repro_torch.common.tree import named_leaves, path_name  # noqa: E402
from repro_torch.config.base import SHAPES  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch.dryrun import fake_mesh  # noqa: E402
from repro_torch.models import model as MDL  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402

MESHES = {"single": SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": 16, "model": 16}),
          "multi": SimpleNamespace(axis_names=("pod", "data", "model"),
                                   shape={"pod": 2, "data": 16, "model": 16})}
DECODE = [s for s in SHAPES if SHAPES[s].kind == "decode"]


def _ref_leaves(tree) -> dict:
    """``{"a/b/c": leaf}`` of a reference tree (PartitionSpecs as leaves)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        out["/".join(str(getattr(k, "key", k)) for k in path)] = leaf
    return out


def _canon(spec) -> tuple:
    """A spec's entries with one-axis tuples written as the axis (JAX's
    ``PartitionSpec`` iterates them so)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _ref_layer_path(cfg, li: int, rest: str) -> "tuple[str, bool]":
    """The reference's path of layer ``li``'s leaf ``rest``, and whether it
    carries a leading group axis."""
    prelude, _, pat = MDL.group_structure(cfg)
    if li in prelude:
        return f"prelude_{li}/{rest}", False
    return f"groups/slot_{(li - len(prelude)) % pat}/{rest}", True


def _port_params(cfg):
    with FakeTensorMode():
        return MDL.init_params(cfg, torch.Generator(), torch.bfloat16, "cpu")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh):
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    sizes = dict(MESHES[mesh].shape)
    ref_shapes = jax.eval_shape(
        lambda k: RMDL.init_params(rcfg, k, jnp.bfloat16), jax.random.PRNGKey(0))
    ref = _ref_leaves(RSH.param_specs(rcfg, ref_shapes, mesh_sizes=sizes))
    ref_shape = {k: tuple(v.shape) for k, v in _ref_leaves(ref_shapes).items()}
    params = _port_params(cfg)
    specs = dict(named_leaves(SH.param_specs(cfg, params, mesh_sizes=sizes)))
    seen = set()
    for path, leaf in named_leaves(params):
        if path[0] == "layers":
            key, grouped = _ref_layer_path(cfg, path[1], path_name(path[2:]))
        else:
            key, grouped = path_name(path), False
        want = _canon(ref[key])[1:] if grouped else _canon(ref[key])
        want_shape = ref_shape[key][1:] if grouped else ref_shape[key]
        assert tuple(leaf.shape) == want_shape, key
        assert _canon(specs[path]) == want, (path, key)
        seen.add(key)
    assert seen == set(ref)            # every reference leaf has its match


@pytest.mark.parametrize("shape", DECODE)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, shape):
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    sh, rsh = SHAPES[shape], REF_SHAPES[shape]
    B, S = sh.global_batch, sh.seq_len
    ref_caches = jax.eval_shape(
        lambda: RMDL.init_decode_caches(rcfg, B, S, jnp.bfloat16))
    with FakeTensorMode():
        caches = MDL.init_decode_caches(cfg, B, S, torch.bfloat16, "cpu")
    for mesh in MESHES.values():
        ref = _ref_leaves(RSH.cache_specs(rcfg, mesh, rsh, ref_caches))
        specs = dict(named_leaves(SH.cache_specs(cfg, mesh, sh, caches)))
        assert {p for p, _ in named_leaves(caches)} == set(specs)
        for path, leaf in named_leaves(caches):
            if "enc_out" in path:
                key, grouped = "enc_out", False
            else:
                key, grouped = _ref_layer_path(cfg, path[0], path_name(path[1:]))
            want = _canon(ref[key])[1:] if grouped else _canon(ref[key])
            assert _canon(specs[path]) == want, (path, key)
        assert len(named_leaves(caches)) >= len(ref)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_activation_specs_equal_reference(mesh):
    m = MESHES[mesh]
    assert SH.dp_axes(m) == RSH.dp_axes(m)
    for name in SHAPES:
        assert _canon(SH.batch_spec(m, SHAPES[name])) == \
            _canon(RSH.batch_spec(m, REF_SHAPES[name]))
        assert _canon(SH.activation_spec(m, SHAPES[name])) == \
            _canon(RSH.activation_spec(m, REF_SHAPES[name]))


_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch):
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    for name in SHAPES:
        ref = RMDL.input_specs(rcfg, REF_SHAPES[name], jnp.bfloat16)
        got = MDL.input_specs(cfg, SHAPES[name])
        assert list(got) == list(ref), name
        for k, v in ref.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(v.shape), (name, k)
            assert got[k].dtype == _DTYPES[jnp.dtype(v.dtype)], (name, k)


SPECS = [((8, 6), SH.P("data", None)), ((8, 6), SH.P(None, "model")),
         ((8, 6), SH.P("model", "data")), ((8, 6, 4), SH.P(("data", "model"))),
         ((8, 6), SH.P(None, None)), ((4, 8, 2), SH.P("data", "model", None))]


def test_to_placements_on_a_fake_mesh():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_mesh((2, 2), ("data", "model")) as mesh:
        for shape, spec in SPECS:
            pl = SH.to_placements(mesh, spec)
            assert len(pl) == 2
            want = list(shape)
            for dim, axes in enumerate(spec):
                for _ in (axes if isinstance(axes, tuple) else
                          () if axes is None else (axes,)):
                    want[dim] //= 2
            with FakeTensorMode():
                t = distribute_tensor(torch.empty(shape), mesh, pl,
                                      src_data_rank=None)
                assert tuple(t.to_local().shape) == tuple(want), spec
        assert SH.to_placements(mesh, SH.P(("data", "model"), None)) == \
            [Shard(0), Shard(0)]
        assert SH.to_placements(mesh, SH.P(None, None)) == \
            [Replicate(), Replicate()]
        with pytest.raises(ValueError):      # not in mesh order
            SH.to_placements(mesh, SH.P(("model", "data"), None))
