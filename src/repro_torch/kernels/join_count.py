"""Per-probe weighted match counts against a sorted build side.

``join_count`` returns, for every probe key, the int32 ``sum of build_w[j]
over build[j] == probe[i]`` (``build`` sorted ascending, duplicate keys
allowed).  Sums wrap as int32.

The kernel, ``csrc/join_count.cu``, replaces the reference's Pallas
``join_count`` (all-pairs equality over 256 x 256 tiles): one thread per
probe binary-searches the build and walks its run of equal keys.  It is
bound by bytes.  No block padding: the kernel takes any extent.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from repro_torch.kernels.build import P, I, check, launch, register, route
from repro_torch.kernels.sorted_intersect import range_weights, wrap_int32

register("join_count", "join_count.cu", "join_count", [P] * 4 + [I] * 2)


def _check_args(probe, build, build_w):
    import torch

    dev = probe.device
    check("probe", probe, torch.int32, (probe.shape[0],), dev)
    check("build", build, torch.int32, (build.shape[0],), dev)
    check("build_w", build_w, torch.int32, (build.shape[0],), dev)
    return dev


def join_count(probe, build, build_w):
    """``(NP,)`` int32 match multiplicities of ``probe`` ``(NP,)`` against
    the sorted ``build`` ``(NB,)`` weighted by ``build_w`` ``(NB,)``."""
    import torch

    dev = _check_args(probe, build, build_w)
    if route(dev) == "plain":
        return join_count_plain(probe, build, build_w)
    out = torch.empty(probe.shape[0], dtype=torch.int32, device=dev)
    if probe.shape[0]:
        launch("join_count", probe.data_ptr(), build.data_ptr(),
               build_w.data_ptr(), out.data_ptr(), probe.shape[0],
               build.shape[0])
    return out


def join_count_plain(probe, build, build_w):
    """Plain PyTorch version of ``join_count`` (same arguments)."""
    _check_args(probe, build, build_w)
    return wrap_int32(range_weights(probe, build, build_w))
