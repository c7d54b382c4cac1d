"""(segment, predicate bucket) counts for per-subject predicate bitmaps.

``seg_bitmap`` returns the ``(n_seg, 128)`` float32 count of rows per
(segment, bucket); ``ops.predicate_bitmaps`` takes ``> 0`` for the OR of a
subject's predicate bits.  Rows with a segment below 0 are padding, and rows
whose segment is not below ``n_seg`` or whose bucket lies outside
``[0, 128)`` count nothing (they match no one-hot column of the reference).

The kernel, ``csrc/seg_bitmap.cu``, replaces the reference's Pallas
``seg_bitmap`` (a one-hot matmul on the MXU): a scatter count, one
``atomicAdd`` of 1.0 per row into a zeroed plane, exact while every count
stays below 2^24.  It is bound by bytes.  No block padding: the kernel takes
any extent.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from repro_torch.kernels.build import P, I, check, launch, register, route

register("seg_bitmap", "seg_bitmap.cu", "seg_bitmap", [P] * 3 + [I] * 2)

NBUCKETS = 128      # predicate hash buckets


def _check_rows(seg, bucket):
    import torch

    dev = seg.device
    check("seg", seg, torch.int32, (seg.shape[0],), dev)
    check("bucket", bucket, torch.int32, (seg.shape[0],), dev)
    return dev


def seg_bitmap(seg, bucket, n_seg: int):
    """``(n_seg, 128)`` float32 counts of the ``(N,)`` int32 rows
    ``(seg, bucket)``."""
    import torch

    dev = _check_rows(seg, bucket)
    if route(dev) == "plain":
        return seg_bitmap_plain(seg, bucket, n_seg)
    out = torch.zeros((n_seg, NBUCKETS), dtype=torch.float32, device=dev)
    if seg.shape[0] and n_seg:
        launch("seg_bitmap", seg.data_ptr(), bucket.data_ptr(), out.data_ptr(),
               seg.shape[0], n_seg)
    return out


def seg_bitmap_plain(seg, bucket, n_seg: int):
    """Plain PyTorch version of ``seg_bitmap`` (same arguments):
    ``index_put_`` with accumulation over the rows that land in the plane."""
    import torch

    _check_rows(seg, bucket)
    out = torch.zeros((n_seg, NBUCKETS), dtype=torch.float32, device=seg.device)
    ok = (seg >= 0) & (seg < n_seg) & (bucket >= 0) & (bucket < NBUCKETS)
    ones = torch.ones(int(ok.sum()), dtype=torch.float32, device=seg.device)
    out.index_put_((seg[ok].long(), bucket[ok].long()), ones, accumulate=True)
    return out
