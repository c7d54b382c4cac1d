"""Mamba-1 selective scan with its final state.

``ssm_scan(dt, bt, ct, x, a)`` returns ``(y, h_last)``: per batch row and
channel, ``h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t * bt_t`` from ``h_0 =
0`` and ``y_t = ct_t . h_t``; ``h_last`` is the state after the last step.
``dt``, ``x``: ``(B, S, D)``; ``bt``, ``ct``: ``(B, S, N)``; ``a``: ``(D,
N)`` (negative); ``y``: ``(B, S, D)``; ``h_last``: ``(B, D, N)``; all
float32.

The kernel, ``csrc/ssm_scan.cu``, replaces the reference's Pallas
``ssm_scan`` (a sequential grid of 64-step chunks with the carry in VMEM,
``BLOCK_D`` channels per block).  A block covers 32 channels of one batch
row over the whole sequence, lanes along the channels; its four warps
split a channel's states (4 each, 8 above 16 states), each thread sums its
share of ``y_t`` and the warps' partial sums meet in shared memory; chunks
of 32 steps are staged through a ``cp.async`` ring.  It also writes
``h_last``, which the serving prefill needs for the decode cache and the
TPU kernel leaves in its scratch.  Any ``S`` and ``D`` (the reference
asserts ``S % 64 == 0`` and ``D % 256 == 0``); ``N <= MAX_STATE``.  It is
bound by its bytes, and nearly as much by its exponentials, one per (b, t,
d, n) on the special-function units.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from repro_torch.kernels.build import P, I, check, launch, register, route

register("ssm_scan", "ssm_scan.cu", "ssm_scan", [P] * 7 + [I] * 4)

MAX_STATE = 32                 # state width the kernel takes


def _check_args(dt, bt, ct, x, a):
    import torch

    if x.dim() != 3 or bt.dim() != 3:
        raise ValueError(f"ssm_scan: x {tuple(x.shape)} and bt "
                         f"{tuple(bt.shape)} must be (B, S, width)")
    B, S, D = x.shape
    N = bt.shape[2]
    dev = x.device
    f32 = torch.float32
    check("dt", dt, f32, (B, S, D), dev)
    check("bt", bt, f32, (B, S, N), dev)
    check("ct", ct, f32, (B, S, N), dev)
    check("x", x, f32, (B, S, D), dev)
    check("a", a, f32, (D, N), dev)
    return dev, (B, S, D, N)


def ssm_scan(dt, bt, ct, x, a):
    """``(y (B, S, D), h_last (B, D, N))`` float32 (see the module
    docstring)."""
    import torch

    dev, (B, S, D, N) = _check_args(dt, bt, ct, x, a)
    if route(dev) == "plain":
        return ssm_scan_plain(dt, bt, ct, x, a)
    if N > MAX_STATE:
        raise ValueError(f"ssm_scan: state width {N} above {MAX_STATE}")
    # at N = 0 the kernel does not run and y is the empty sum, zeros
    y = (torch.empty if N else torch.zeros)((B, S, D), dtype=torch.float32,
                                             device=dev)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    if h_last.numel():
        launch("ssm_scan", dt.data_ptr(), bt.data_ptr(), ct.data_ptr(),
               x.data_ptr(), a.data_ptr(), y.data_ptr(), h_last.data_ptr(),
               B, S, D, N)
    return y, h_last


def ssm_scan_plain(dt, bt, ct, x, a):
    """Plain PyTorch version of ``ssm_scan`` (same arguments): the
    recurrence, one step at a time."""
    import torch

    _, (B, S, D, N) = _check_args(dt, bt, ct, x, a)
    h = torch.zeros((B, D, N), dtype=torch.float32, device=x.device)
    y = torch.empty((B, S, D), dtype=torch.float32, device=x.device)
    dtx = dt * x
    for t in range(S):
        h = h * torch.exp(dt[:, t, :, None] * a) + dtx[:, t, :, None] * bt[:, t, None, :]
        y[:, t] = (h * ct[:, t, None, :]).sum(-1)
    return y, h
