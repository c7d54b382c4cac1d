"""Pairwise popcount of the AND of entity-summary signatures (paper §3.3).

``summary_probe`` returns the ``(nA, nB)`` int32 ``sum over words of
popcount(a[i] & b[j])`` of int32 signature words; zero means the two
signatures share no bit, so the (objects row, subjects row) pair cannot
link.  Any extents, word counts of any parity and rows at any 4-byte
boundary (a row slice of a larger block) are taken.

The kernel, ``csrc/summary_probe.cu``, replaces the reference's Pallas
``summary_probe`` (128 x 128 output tiles, SWAR popcount on the VPU).  Its
C entry picks one of two forms by shape (``form`` mirrors the rule): below
one 32 x 32 tile per SM, every statistics-path call, one warp per output
reads both rows with 16-byte loads in one round and sums ``__popc`` of
the AND across its lanes, so the time is one round of load latency and the
launch; above it, 32 x 32 output tiles walk the words through shared
memory, bound by the popcounts.  Both write every output once, so the
output comes from ``torch.empty``.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from repro_torch.kernels.build import P, I, check, launch, register, route
from repro_torch.kernels.dp_layer import sm_count

register("summary_probe", "summary_probe.cu", "summary_probe", [P] * 3 + [I] * 4)

_PLAIN_CHUNK = 1 << 22        # (i, j, word) elements per step of the plain form
_TILE = 32                    # the tiled form's output tile (csrc kTile)


def _check_sigs(a_sig, b_sig):
    import torch

    dev = a_sig.device
    w = a_sig.shape[1] if a_sig.dim() == 2 else -1
    check("a_sig", a_sig, torch.int32, (a_sig.shape[0], w), dev)
    check("b_sig", b_sig, torch.int32, (b_sig.shape[0], w), dev)
    return dev


def summary_probe(a_sig, b_sig):
    """``(nA, nB)`` int32 popcounts of the pairwise AND of ``a_sig``
    ``(nA, W)`` and ``b_sig`` ``(nB, W)`` int32 words."""
    import torch

    dev = _check_sigs(a_sig, b_sig)
    if route(dev) == "plain":
        return summary_probe_plain(a_sig, b_sig)
    na, w = a_sig.shape
    nb = b_sig.shape[0]
    if not (na and nb and w):
        return torch.zeros((na, nb), dtype=torch.int32, device=dev)
    out = torch.empty((na, nb), dtype=torch.int32, device=dev)
    launch("summary_probe", a_sig.data_ptr(), b_sig.data_ptr(),
           out.data_ptr(), na, nb, w, sm_count(dev))
    return out


def form(na: int, nb: int, sms: int) -> str:
    """The kernel's form for an ``(na, nb)`` output on a card of ``sms``
    SMs, as its C entry picks it: ``"warp"`` below one 32 x 32 tile per
    SM, else ``"tiled"``."""
    tiles = -(-na // _TILE) * -(-nb // _TILE)
    return "warp" if tiles < sms else "tiled"


def popcount32(v):
    """int64 bit counts of int32 words: the reference's SWAR popcount, with
    the words widened to int64 and masked to 32 bits so that ``>>`` (an
    arithmetic shift in PyTorch) acts as the logical shift it needs."""
    import torch

    x = v.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def summary_probe_plain(a_sig, b_sig):
    """Plain PyTorch version of ``summary_probe`` (same arguments), a few
    rows of ``a_sig`` at a time."""
    import torch

    _check_sigs(a_sig, b_sig)
    na, w = a_sig.shape
    nb = b_sig.shape[0]
    out = torch.zeros((na, nb), dtype=torch.int32, device=a_sig.device)
    step = max(1, _PLAIN_CHUNK // max(1, nb * w))
    for i in range(0, na, step):
        both = a_sig[i:i + step, None, :] & b_sig[None, :, :]
        out[i:i + step] = popcount32(both).sum(-1).to(torch.int32)
    return out
