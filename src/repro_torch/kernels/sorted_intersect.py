"""Weighted intersection count (Algorithm 1's inner intersection).

``sorted_intersect`` returns the int32 ``sum over a[i] == b[j] of aw[i] *
bw[j]`` for int32 id lists with ``b`` sorted ascending (``a`` may be in any
order; duplicates on either side count every pair).  Sums wrap as int32.

The kernel, ``csrc/sorted_intersect.cu``, replaces the reference's Pallas
``sorted_intersect_weighted`` (all-pairs equality over 256 x 256 tiles): one
thread per ``a[i]`` binary-searches ``b``, a block sum and one integer
``atomicAdd`` per block.  It is bound by bytes.  The reference's block
padding (``-1``/``-2`` sentinels of weight 0) is gone: the kernel takes any
extent.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from repro_torch.kernels.build import P, I, check, launch, register, route

register("sorted_intersect", "sorted_intersect.cu", "sorted_intersect",
         [P] * 5 + [I] * 2)


def _check_lists(a, aw, b, bw):
    import torch

    dev = a.device
    check("a", a, torch.int32, (a.shape[0],), dev)
    check("aw", aw, torch.int32, (a.shape[0],), dev)
    check("b", b, torch.int32, (b.shape[0],), dev)
    check("bw", bw, torch.int32, (b.shape[0],), dev)
    return dev


def sorted_intersect(a, aw, b, bw):
    """0-dim int32 tensor on the inputs' device: ``sum over a[i] == b[j] of
    aw[i] * bw[j]``.  ``a``, ``aw`` ``(NA,)``, ``b``, ``bw`` ``(NB,)`` int32,
    ``b`` sorted ascending."""
    import torch

    dev = _check_lists(a, aw, b, bw)
    if route(dev) == "plain":
        return sorted_intersect_plain(a, aw, b, bw)
    out = torch.zeros((), dtype=torch.int32, device=dev)
    if a.shape[0] and b.shape[0]:
        launch("sorted_intersect", a.data_ptr(), aw.data_ptr(), b.data_ptr(),
               bw.data_ptr(), out.data_ptr(), a.shape[0], b.shape[0])
    return out


def range_weights(keys, b, bw):
    """int64 ``sum of bw[j] over b[j] == keys[i]`` per key, from the two
    ``searchsorted`` bounds of each key in the sorted ``b`` and a prefix sum
    of ``bw`` (shared with ``join_count``'s plain version)."""
    import torch

    lo = torch.searchsorted(b, keys, right=False)
    hi = torch.searchsorted(b, keys, right=True)
    csum = torch.zeros(b.shape[0] + 1, dtype=torch.int64, device=b.device)
    torch.cumsum(bw.to(torch.int64), 0, out=csum[1:])
    return csum[hi] - csum[lo]


def wrap_int32(x):
    """An int64 tensor reduced modulo 2^32 into int32 (two's complement):
    the wrapping of the kernels' int32 sums."""
    import torch

    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def sorted_intersect_plain(a, aw, b, bw):
    """Plain PyTorch version of ``sorted_intersect`` (same arguments)."""
    import torch

    _check_lists(a, aw, b, bw)
    return wrap_int32((aw.to(torch.int64) * range_weights(a, b, bw)).sum())
