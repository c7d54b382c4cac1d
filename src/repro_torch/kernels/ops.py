"""Host entry points of the kernels.

The statistics kernels take arrays and return numpy or int: the port's
counterpart of the reference's ``kernels/ops.py`` statistics wrappers.  Each takes numpy arrays (or tensors, which stay where they are
when already on ``device``), moves them to ``device`` as int32, runs the
kernel wrapper, and returns host values.  ``device`` is ``"cuda"`` unless
the caller asks for the CPU, where the wrappers run their plain versions.
``intersect_counts`` and ``match_counts_segments`` are ``intersect_count``
and ``match_counts`` over K segments of shared base arrays in one launch
(a batch axis written out); their results stay on ``device``, so that a
caller brings several back in one copy.

What the reference needed only for its TPU blocks is gone: the block
padding (``_pad_to``, ``_pad2`` and the ``-1``/``-2`` sentinels), since the
kernels take any extent, and ``set_interpret``.

The LM kernels take and return tensors on their own device:
``flash_attention_gqa`` (prefill and training attention) and
``selective_scan`` (the Mamba prefill and training), the reference's
``kernels/ops.py:84-104``.  Both are differentiable: on the card through
the kernels' autograd Functions (``FlashAttentionFn``, ``SSMScanFn``),
whose backward passes are kernels too, on the CPU through the plain
versions.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.join_count import join_count, join_count_segments
from repro_torch.kernels.seg_bitmap import seg_bitmap
from repro_torch.kernels.sorted_intersect import (sorted_intersect,
                                                  sorted_intersect_segments)
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.kernels.summary_probe import summary_probe

DEFAULT_DEVICE = "cuda"


def _i32(x, device):
    """``x`` as a contiguous int32 tensor on ``device``."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)


def intersect_count(a, aw, b, bw, device=DEFAULT_DEVICE) -> int:
    """Weighted intersection count ``sum over a[i] == b[j] of aw[i] * bw[j]``
    of id lists, ``b`` sorted ascending (int32, wrapping)."""
    return int(sorted_intersect(_i32(a, device), _i32(aw, device),
                                _i32(b, device), _i32(bw, device)))


def intersect_counts(a, aw, a_off, a_len, b, bw, b_off, b_len,
                     device=DEFAULT_DEVICE):
    """``(K,)`` int32 tensor on ``device``: ``intersect_count`` of each
    segment k, ``a[a_off[k]:][:a_len[k]]`` (``aw`` alike) against the sorted
    ``b[b_off[k]:][:b_len[k]]`` (``bw`` alike), in one launch.  Offsets and
    lengths are host integer arrays."""
    return sorted_intersect_segments(_i32(a, device), _i32(aw, device), a_off,
                                     a_len, _i32(b, device), _i32(bw, device),
                                     b_off, b_len)


def predicate_bitmaps(seg, bucket, n_seg: int, device=DEFAULT_DEVICE) -> np.ndarray:
    """``(n_seg, 128)`` bool predicate-presence bitmaps of the rows
    ``(seg, bucket)``; rows with ``seg < 0`` are padding."""
    counts = seg_bitmap(_i32(seg, device), _i32(bucket, device), int(n_seg))
    return (counts > 0).cpu().numpy()


def match_counts(probe, build, build_w, device=DEFAULT_DEVICE) -> np.ndarray:
    """``(len(probe),)`` int32 match multiplicities against the sorted
    ``build`` weighted by ``build_w``."""
    return join_count(_i32(probe, device), _i32(build, device),
                      _i32(build_w, device)).cpu().numpy()


def match_counts_segments(probe, p_off, p_len, build, build_w, b_off, b_len,
                          device=DEFAULT_DEVICE):
    """``(sum(p_len),)`` int32 tensor on ``device``: ``match_counts`` of
    each probe segment against its sorted build segment, concatenated in
    segment order, in one launch.  Offsets and lengths are host integer
    arrays."""
    return join_count_segments(_i32(probe, device), p_off, p_len,
                               _i32(build, device), _i32(build_w, device),
                               b_off, b_len)


def signature_overlap(a_sig, b_sig, device=DEFAULT_DEVICE) -> np.ndarray:
    """``(nA, nB)`` int32 popcounts of pairwise signature ANDs.  Takes the
    host layout (uint64 words) and converts it to int32 words."""
    a32 = _u64_to_i32(np.asarray(a_sig))
    b32 = _u64_to_i32(np.asarray(b_sig))
    return summary_probe(_i32(a32, device), _i32(b32, device)).cpu().numpy()


def flash_attention_gqa(q, k, v, *, causal: bool = True, window: int = 0):
    """Grouped-query attention of ``q`` ``(B, S, H, hd)`` over ``k``, ``v``
    ``(B, S, KV, hd)`` with the ``hd ** -0.5`` scale, on the tensors'
    device: ``(B, S, H, hd)`` in ``q``'s type.  The KV heads are indexed per
    query head inside the kernel, not repeated as the reference's wrapper
    does."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)


def selective_scan(dt, bt, ct, x, a):
    """Mamba selective scan (see ``kernels/ssm_scan.py``) on the tensors'
    device: ``(y (B, S, D), h_last (B, D, N))``.  Unlike the reference's
    wrapper it returns the final state too, and has no ``chunk``: the
    kernel walks the whole sequence."""
    return ssm_scan(dt.contiguous(), bt.contiguous(), ct.contiguous(),
                    x.contiguous(), a.contiguous())


def _u64_to_i32(x: np.ndarray) -> np.ndarray:
    """int32 words of uint64 signature rows, low half first (the host's
    little-endian layout).  Unlike the reference's copy it takes zero rows."""
    if x.dtype == np.uint64:
        x = np.ascontiguousarray(x)
        return x.view(np.uint32).astype(np.int32).reshape(x.shape[0], 2 * x.shape[-1])
    return x.astype(np.int32)
