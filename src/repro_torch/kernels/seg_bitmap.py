"""(segment, predicate bucket) counts for per-subject predicate bitmaps.

``seg_bitmap`` returns the ``(n_seg, 128)`` float32 count of rows per
(segment, bucket); ``ops.predicate_bitmaps`` takes ``> 0`` for the OR of a
subject's predicate bits.  The function is total, as the reference's is:
rows with a segment below 0 are padding, rows whose segment is not below
``n_seg`` or whose bucket lies outside ``[0, 128)`` count nothing (they
match no one-hot column of the reference), and such rows may sit anywhere;
any row order gives the same counts.

The kernel, ``csrc/seg_bitmap.cu``, replaces the reference's Pallas
``seg_bitmap`` (a one-hot matmul on the MXU).  It is one persistent
cooperative launch.  Its blocks count tiles of rows as if the rows were
*ordered* (``seg`` does not decrease over the in-plane rows, as the
statistics path lays them out), checking that they are: each segment is
counted on chip by the tile that holds its first row, and its 512-byte
output row written once, missing segment ids as zero rows.  A grid barrier
then settles the verdict.  On ordered rows that plane stands: no memset and
no global atomics, so the plane comes from ``torch.empty``.  Otherwise the
kernel zeroes the plane itself and adds 1.0 per row with global atomics,
exact while every count stays below 2^24.  Either way it is bound by
bytes, nearly all of them the plane's single write.  Nothing syncs with the
host.  ``seg_bitmap_path`` also reads back which path ran.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from repro_torch.kernels.build import P, I, check, launch, register, route
from repro_torch.kernels.dp_layer import sm_count

register("seg_bitmap", "seg_bitmap.cu", "seg_bitmap", [P] * 4 + [I] * 3)

NBUCKETS = 128      # predicate hash buckets
TILE_ROWS = 1024    # rows of a block's tile (csrc/seg_bitmap.cu kTile)
MAX_BLOCKS_PER_SM = 4   # the kernel's grid, at most (kMaxBlocksPerSm)


def _check_rows(seg, bucket):
    import torch

    dev = seg.device
    check("seg", seg, torch.int32, (seg.shape[0],), dev)
    check("bucket", bucket, torch.int32, (seg.shape[0],), dev)
    return dev


def seg_bitmap(seg, bucket, n_seg: int):
    """``(n_seg, 128)`` float32 counts of the ``(N,)`` int32 rows
    ``(seg, bucket)``, in any order."""
    return _run(seg, bucket, n_seg)[0]


def seg_bitmap_path(seg, bucket, n_seg: int):
    """``seg_bitmap`` on CUDA tensors, and which path of the kernel ran:
    ``"ordered"`` or ``"unordered"`` (``None`` where nothing launched).
    Reading the kernel's verdict word back waits for the card."""
    out, scratch = _run(seg, bucket, n_seg)
    if scratch is None:
        return out, None
    return out, ("ordered" if int(scratch[0]) == 1 else "unordered")


def _run(seg, bucket, n_seg: int):
    """The plane, and the kernel's scratch (``None`` without a launch):
    the verdict word (1 when the ordered path's plane stands), then one
    word per block of the grid; the kernel writes all it reads."""
    import torch

    dev = _check_rows(seg, bucket)
    if route(dev) == "plain":
        return seg_bitmap_plain(seg, bucket, n_seg), None
    n = seg.shape[0]
    if n == 0 or n_seg == 0:
        return torch.zeros((n_seg, NBUCKETS), dtype=torch.float32,
                           device=dev), None
    sms = sm_count(dev)
    out = torch.empty((n_seg, NBUCKETS), dtype=torch.float32, device=dev)
    scratch = torch.empty(1 + MAX_BLOCKS_PER_SM * sms, dtype=torch.int32,
                          device=dev)
    launch("seg_bitmap", seg.data_ptr(), bucket.data_ptr(), out.data_ptr(),
           scratch.data_ptr(), n, n_seg, sms)
    return out, scratch


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
