"""Meshes for the SPMD federation executor (``engine/distributed.py``).

A mesh names the axes of the engine's layout: ``data`` (one federation
endpoint per index), ``model`` (each endpoint's triples hash-partitioned by
subject) and, on the multi-pod production mesh, ``pod`` (independent query
streams, replicated).  Here every shard of a mesh lives on one device: a
tensor of the engine carries the ``(data, model)`` axes as its two leading
dimensions, and the four collectives the engine uses are the tensor
permutations and reductions they are on one device.  So a mesh needs no
device count, and the reference's "need N devices" error has no
counterpart: ``make_production_mesh`` builds its 256 (or 512) shards on
whatever single device it is given.

The collectives are exact: they only move and sum integers.  A collective's
result is the same on every shard of the axes it gathered or summed over, so
it keeps those axes at size 1, and it broadcasts against the ``(d, m)``
tensors (the engine never materializes the copies).  A later multi-card
mesh implements the same four methods with ``torch.distributed``; nothing
else in the engine knows where the shards are.

Building a mesh is a function call, never an import side effect.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

SHARD_AXES = ("data", "model")   # the leading dimensions of a sharded tensor


@dataclass(frozen=True)
class Mesh:
    """``shape`` maps each axis name to its size, in ``axis_names`` order.
    Sharded tensors carry the ``SHARD_AXES`` as their leading dimensions; a
    ``pod`` axis replicates and has no dimension."""

    shape: dict
    axis_names: tuple
    device: str = "cuda"

    def __post_init__(self) -> None:
        if tuple(self.shape) != tuple(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not follow the "
                             f"axis order {self.axis_names}")
        missing = [a for a in SHARD_AXES if a not in self.shape]
        if missing:
            raise ValueError(f"a mesh needs the axes {SHARD_AXES}; "
                             f"{missing} missing")
        if torch.device(self.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"a mesh on {self.device!r} needs a CUDA card, "
                               "and none is available (pass device='cpu')")

    def _dim(self, axis: str) -> int:
        if axis not in SHARD_AXES:
            raise ValueError(f"axis {axis!r} has no dimension in a sharded "
                             f"tensor (those are {SHARD_AXES})")
        return SHARD_AXES.index(axis)

    # -- the four collectives -----------------------------------------------
    def all_to_all(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """Tiled ``all_to_all`` over ``axis`` with split and concat axis 0
        of each shard's block: shard ``j`` receives block ``j`` of every
        shard ``i`` of the axis, in order of ``i``.  With ``axis="model"``,
        ``(d, m_src, m_dst, ...)`` becomes ``(d, m_dst, m_src, ...)``."""
        n = len(SHARD_AXES)
        if x.shape[n] != self.shape[axis]:
            raise ValueError(f"all_to_all over {axis!r} needs {self.shape[axis]} "
                             f"blocks a shard, got {x.shape[n]}")
        return x.transpose(self._dim(axis), n)

    def all_gather(self, x: torch.Tensor, axes: tuple = ("model", "data")) -> torch.Tensor:
        """Tiled ``all_gather`` over each of ``axes`` in turn: every shard
        gets the concatenation of its peers' rows (axis 0 of a shard's
        block), the axis gathered last outermost; ``("model", "data")``
        concatenates in data-major, model-minor order.  The gathered axes
        come back at size 1."""
        n = len(SHARD_AXES)
        dims = [self._dim(a) for a in axes]
        keep = [i for i in range(n) if i not in dims]
        major = dims[::-1]
        y = x.permute(*keep, *major, *range(n, x.dim()))
        sizes = [x.shape[i] for i in keep]
        y = y.reshape(*sizes, -1, *x.shape[n + 1:])
        for i in sorted(dims):
            y = y.unsqueeze(i)
        return y

    def psum(self, x: torch.Tensor, axes: tuple = ("model", "data")) -> torch.Tensor:
        """``psum`` over ``axes`` in int32 (JAX's integer sum without x64);
        the summed axes come back at size 1."""
        return x.sum(dim=tuple(self._dim(a) for a in axes), keepdim=True,
                     dtype=torch.int32)

    def axis_index(self, axis: str) -> torch.Tensor:
        """Each shard's index along ``axis``, shaped to broadcast against
        the leading ``(d, m)`` dimensions."""
        shape = [1] * len(SHARD_AXES)
        shape[self._dim(axis)] = self.shape[axis]
        return torch.arange(self.shape[axis], dtype=torch.int32,
                            device=self.device).reshape(shape)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> Mesh:
    """The reference's production layout, ``(16, 16)`` over
    ``(data, model)``, or ``(2, 16, 16)`` with a leading ``pod`` axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)), axes, device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device: str = "cuda") -> Mesh:
    """A small mesh, every shard on ``device``."""
    return Mesh(dict(zip(axes, shape)), tuple(axes), device)
