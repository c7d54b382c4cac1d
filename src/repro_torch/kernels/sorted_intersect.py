"""Weighted intersection count (Algorithm 1's inner intersection).

``sorted_intersect`` returns the int32 ``sum over a[i] == b[j] of aw[i] *
bw[j]`` for int32 id lists with ``b`` sorted ascending (``a`` may be in any
order; duplicates on either side count every pair).  Sums wrap as int32.
``sorted_intersect_segments`` computes it for K list pairs at once, each a
segment ``[off, off + len)`` of shared base arrays: Algorithm 1's exact
checks of one source pair are slices of two sources' exports.

The kernel, ``csrc/sorted_intersect.cu``, replaces the reference's Pallas
``sorted_intersect_weighted`` (all-pairs equality over 256 x 256 tiles, one
call per list pair): one launch per batch of segments, one block per tile
of ``TILE`` probes of a segment, each probe binary-searching its segment's
``b`` window (staged in shared memory when it holds at most ``SMEM_KEYS``
keys), a block sum and one integer ``atomicAdd`` per tile (see
``csrc/segments.cuh``).  Its work is one search per probe of every
segment.  The reference's block padding (``-1``/``-2`` sentinels of weight
0) is gone: the kernel takes any extent.  The single-list
``sorted_intersect``, and a batch of one, launch the same kernel with no
table: its tiles follow from the block index.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.build import (P, L, check, launch, register, route,
                                       upload)

TILE = 512           # probes per block (csrc/segments.cuh kTile)
SMEM_KEYS = 8192     # b keys a block stages (csrc/segments.cuh kSmemKeys)
INT32_MAX = 2**31 - 1

register("sorted_intersect", "sorted_intersect.cu", "sorted_intersect",
         [P] * 5 + [L] * 4 + [P])


def _check_lists(a, aw, b, bw):
    import torch

    dev = a.device
    check("a", a, torch.int32, (a.shape[0],), dev)
    check("aw", aw, torch.int32, (a.shape[0],), dev)
    check("b", b, torch.int32, (b.shape[0],), dev)
    check("bw", bw, torch.int32, (b.shape[0],), dev)
    return dev


def segments(name: str, off, length, extent: int):
    """``(off, length)`` as int64 numpy arrays of one length K, every
    segment ``[off, off + length)`` inside ``[0, extent)`` and shorter than
    2^31; raises otherwise."""
    off, length = np.asarray(off), np.asarray(length)
    for x in (off, length):
        if x.size and not np.issubdtype(x.dtype, np.integer):
            raise TypeError(f"{name}: segment bounds of dtype {x.dtype}")
    off, length = off.astype(np.int64), length.astype(np.int64)
    if off.ndim != 1 or off.shape != length.shape:
        raise ValueError(f"{name}: offsets {off.shape} and lengths "
                         f"{length.shape} must be one (K,) pair")
    if ((off < 0) | (length < 0) | (off + length > extent)
            | (length > INT32_MAX)).any():
        raise ValueError(f"{name}: a segment lies outside [0, {extent})")
    return off, length


def _check_segments(a, aw, a_off, a_len, b, bw, b_off, b_len):
    dev = _check_lists(a, aw, b, bw)
    a_off, a_len = segments("a", a_off, a_len, a.shape[0])
    b_off, b_len = segments("b", b_off, b_len, b.shape[0])
    if a_off.shape != b_off.shape:
        raise ValueError(f"{len(a_off)} a segments, {len(b_off)} b segments")
    return dev, a_off, a_len, b_off, b_len


def tile_list(length, keep):
    """``(segment, start)`` int64 of every ``TILE``-probe tile of the
    segments where ``keep``; a segment of ``n`` probes has ``ceil(n /
    TILE)`` tiles."""
    n = np.where(keep, -(-length // TILE), 0)
    seg = np.repeat(np.arange(len(length), dtype=np.int64), n)
    first = np.repeat(np.cumsum(n) - n, n)
    return seg, (np.arange(len(seg), dtype=np.int64) - first) * TILE


def segment_table(a_off, a_len, b_off, b_len, keep, device, out_off=None):
    """The launch table of ``csrc/segments.cuh`` on ``device`` and its
    tile count: int64 rows ``a_off``, ``a_len``, ``b_off``, ``b_len`` (and
    ``out_off`` where given), then the segment and start of every tile of
    the segments where ``keep``."""
    seg, start = tile_list(a_len, keep)
    rows = [a_off, a_len, b_off, b_len, *([] if out_off is None else [out_off]),
            seg, start]
    return upload(np.concatenate(rows), device), len(seg)


def sorted_intersect_segments(a, aw, a_off, a_len, b, bw, b_off, b_len):
    """``(K,)`` int32 on the inputs' device: ``sorted_intersect`` of every
    segment k, ``a[a_off[k]:][:a_len[k]]`` (and ``aw`` alike) against
    ``b[b_off[k]:][:b_len[k]]`` (and ``bw``), each ``b`` segment sorted
    ascending.  ``a``, ``aw`` ``(NA,)``, ``b``, ``bw`` ``(NB,)`` int32; the
    offsets and lengths are host integer arrays."""
    import torch

    dev, a_off, a_len, b_off, b_len = _check_segments(
        a, aw, a_off, a_len, b, bw, b_off, b_len)
    if route(dev) == "plain":
        return sorted_intersect_segments_plain(a, aw, a_off, a_len, b, bw,
                                               b_off, b_len)
    if len(a_off) == 1:
        (o, n), (p, m) = (int(a_off[0]), int(a_len[0])), (int(b_off[0]),
                                                          int(b_len[0]))
        return sorted_intersect(a[o:o + n], aw[o:o + n], b[p:p + m],
                                bw[p:p + m]).reshape(1)
    out = torch.zeros(len(a_off), dtype=torch.int32, device=dev)
    keep = (a_len > 0) & (b_len > 0)
    if keep.any():
        table, n_tiles = segment_table(a_off, a_len, b_off, b_len, keep, dev)
        launch("sorted_intersect", a.data_ptr(), aw.data_ptr(), b.data_ptr(),
               bw.data_ptr(), table.data_ptr(), len(a_off), n_tiles, 0, 0,
               out.data_ptr())
    return out


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
               bw.data_ptr(), None, 1, 0, a.shape[0], b.shape[0],
               out.data_ptr())
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


def sorted_intersect_segments_plain(a, aw, a_off, a_len, b, bw, b_off, b_len):
    """Plain PyTorch version of ``sorted_intersect_segments`` (same
    arguments): ``sorted_intersect_plain`` of each segment in turn."""
    import torch

    dev, a_off, a_len, b_off, b_len = _check_segments(
        a, aw, a_off, a_len, b, bw, b_off, b_len)
    out = [sorted_intersect_plain(a[o:o + n], aw[o:o + n], b[p:p + m],
                                  bw[p:p + m])
           for o, n, p, m in zip(a_off.tolist(), a_len.tolist(),
                                 b_off.tolist(), b_len.tolist())]
    return (torch.stack(out) if out
            else torch.zeros(0, dtype=torch.int32, device=dev))
