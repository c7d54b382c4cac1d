"""Per-probe weighted match counts against a sorted build side.

``join_count`` returns, for every probe key, the int32 ``sum of build_w[j]
over build[j] == probe[i]`` (``build`` sorted ascending, duplicate keys
allowed).  Sums wrap as int32.  ``join_count_segments`` computes it for K
(probe, build) list pairs at once, each a segment of shared base arrays,
and concatenates the segments' counts.

The kernel, ``csrc/join_count.cu``, replaces the reference's Pallas
``join_count`` (all-pairs equality over 256 x 256 tiles, one call per list
pair): one launch per batch of segments, one block per tile of
``sorted_intersect.TILE`` probes of a segment, each probe binary-searching
its segment's build window (staged in shared memory when it holds at most
``sorted_intersect.SMEM_KEYS`` keys) and walking its run of equal keys (see
``csrc/segments.cuh``).  Its work is one search per probe of every
segment.  No block padding: the kernel takes any extent.  The single-list
``join_count``, and a batch of one, launch the same kernel with no table:
its tiles follow from the block index.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.build import P, L, check, launch, register, route
from repro_torch.kernels.sorted_intersect import (range_weights, segment_table,
                                                  segments, wrap_int32)

register("join_count", "join_count.cu", "join_count", [P] * 4 + [L] * 4 + [P])


def _check_args(probe, build, build_w):
    import torch

    dev = probe.device
    check("probe", probe, torch.int32, (probe.shape[0],), dev)
    check("build", build, torch.int32, (build.shape[0],), dev)
    check("build_w", build_w, torch.int32, (build.shape[0],), dev)
    return dev


def _check_segments(probe, p_off, p_len, build, build_w, b_off, b_len):
    dev = _check_args(probe, build, build_w)
    p_off, p_len = segments("probe", p_off, p_len, probe.shape[0])
    b_off, b_len = segments("build", b_off, b_len, build.shape[0])
    if p_off.shape != b_off.shape:
        raise ValueError(f"{len(p_off)} probe segments, {len(b_off)} build "
                         f"segments")
    return dev, p_off, p_len, b_off, b_len


def join_count_segments(probe, p_off, p_len, build, build_w, b_off, b_len):
    """``(sum(p_len),)`` int32 on the inputs' device: ``join_count`` of
    every segment k, ``probe[p_off[k]:][:p_len[k]]`` against the sorted
    ``build[b_off[k]:][:b_len[k]]`` weighted by ``build_w`` alike, the
    segments' counts concatenated in order.  ``probe`` ``(NP,)``,
    ``build``, ``build_w`` ``(NB,)`` int32; the offsets and lengths are host
    integer arrays."""
    import torch

    dev, p_off, p_len, b_off, b_len = _check_segments(
        probe, p_off, p_len, build, build_w, b_off, b_len)
    if route(dev) == "plain":
        return join_count_segments_plain(probe, p_off, p_len, build, build_w,
                                         b_off, b_len)
    if len(p_off) == 1:
        (o, n), (p, m) = (int(p_off[0]), int(p_len[0])), (int(b_off[0]),
                                                          int(b_len[0]))
        return join_count(probe[o:o + n], build[p:p + m], build_w[p:p + m])
    out = torch.empty(int(p_len.sum()), dtype=torch.int32, device=dev)
    keep = p_len > 0
    if keep.any():
        table, n_tiles = segment_table(p_off, p_len, b_off, b_len, keep, dev,
                                       out_off=np.cumsum(p_len) - p_len)
        launch("join_count", probe.data_ptr(), build.data_ptr(),
               build_w.data_ptr(), table.data_ptr(), len(p_off), n_tiles, 0,
               0, out.data_ptr())
    return out


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
               build_w.data_ptr(), None, 1, 0, probe.shape[0], build.shape[0],
               out.data_ptr())
    return out


def join_count_plain(probe, build, build_w):
    """Plain PyTorch version of ``join_count`` (same arguments)."""
    _check_args(probe, build, build_w)
    return wrap_int32(range_weights(probe, build, build_w))


def join_count_segments_plain(probe, p_off, p_len, build, build_w, b_off,
                              b_len):
    """Plain PyTorch version of ``join_count_segments`` (same arguments):
    ``join_count_plain`` of each segment in turn."""
    import torch

    dev, p_off, p_len, b_off, b_len = _check_segments(
        probe, p_off, p_len, build, build_w, b_off, b_len)
    out = [join_count_plain(probe[o:o + n], build[p:p + m],
                            build_w[p:p + m])
           for o, n, p, m in zip(p_off.tolist(), p_len.tolist(),
                                 b_off.tolist(), b_len.tolist())]
    return (torch.cat(out) if out
            else torch.zeros(0, dtype=torch.int32, device=dev))
