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

Training differentiates the kernel through ``SSMScanFn``: its forward
launches the kernel keeping the state after every ``CHUNK``-step chunk
(``ssm_scan_fwd``), its backward the hand-written ``csrc/ssm_scan_bwd.cu``
(``ssm_scan_bwd``), which walks the chunks in reverse, recomputing each
chunk's states from the kept one (the next chunk's inputs prefetched
through a ``cp.async`` ring, ``d bt`` and ``d ct`` summed over a block's
channels once a chunk), and gives ``d dt``, ``d bt``, ``d ct``, ``d x`` and
``d a`` from ``dy`` and ``d h_last`` (deterministic: per-block partials,
added in a fixed order by a second launch).
``ssm_scan`` goes through it whenever gradients are on and an input
requires one.  The reference has no backward kernel; its training
differentiates the associative scan with ``jax.grad``.

Each launch is a ``torch.library`` operator of its own
(``repro_torch::ssm_scan``, ``::ssm_scan_fwd`` and ``::ssm_scan_bwd``), with
a CUDA kernel and a shape-only form (``register_fake``), so the dry-run
books each as one op with the work ``kernels/work.py`` counts (the plain
recurrence, a Python loop over the steps, is never traced).  A wrapper runs
its plain version only for tensors on the CPU that hold data (the
backward's is autograd through ``ssm_scan_plain``); for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (P, I, check, launch, plain, register,
                                      wants_grad)

register("ssm_scan", "ssm_scan.cu", "ssm_scan", [P] * 8 + [I] * 4)
register("ssm_scan_bwd", "ssm_scan_bwd.cu", "ssm_scan_bwd",
         [P] * 16 + [I] * 4)

MAX_STATE = 32                 # state width the kernel takes
CHUNK = 16                     # steps between the states the forward keeps
CHANNELS = 32                  # channels of a kernel block


def _check_args(dt, bt, ct, x, a):
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


def _n_chunks(S: int) -> int:
    return -(-S // CHUNK)


def _launch_fwd(dt, bt, ct, x, a, keep_chunks: bool):
    B, S, D = x.shape
    N = bt.shape[2]
    if N > MAX_STATE:
        raise ValueError(f"ssm_scan: state width {N} above {MAX_STATE}")
    dev = x.device
    # at N = 0 the kernel does not run and y is the empty sum, zeros
    y = (torch.empty if N else torch.zeros)((B, S, D), dtype=torch.float32,
                                             device=dev)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    hc = (torch.empty((B, _n_chunks(S), D, N), dtype=torch.float32,
                      device=dev) if keep_chunks else None)
    if h_last.numel():
        launch("ssm_scan", dt.data_ptr(), bt.data_ptr(), ct.data_ptr(),
               x.data_ptr(), a.data_ptr(), y.data_ptr(), h_last.data_ptr(),
               0 if hc is None else hc.data_ptr(), B, S, D, N)
    return y, h_last, hc


def ssm_scan(dt, bt, ct, x, a):
    """``(y (B, S, D), h_last (B, D, N))`` float32 (see the module
    docstring); differentiable on both devices."""
    _check_args(dt, bt, ct, x, a)
    if plain(x):
        return ssm_scan_plain(dt, bt, ct, x, a)
    if wants_grad(dt, bt, ct, x, a):
        return SSMScanFn.apply(dt, bt, ct, x, a)
    return torch.ops.repro_torch.ssm_scan(dt, bt, ct, x, a)


def ssm_scan_fwd(dt, bt, ct, x, a):
    """``(y, h_last, h_chunks)``: ``ssm_scan``'s outputs and the state after
    every ``CHUNK``-step chunk, ``(B, ceil(S / CHUNK), D, N)``."""
    _check_args(dt, bt, ct, x, a)
    if plain(x):
        return ssm_scan_chunks_plain(dt, bt, ct, x, a)
    return torch.ops.repro_torch.ssm_scan_fwd(dt, bt, ct, x, a)


def ssm_scan_bwd(dt, bt, ct, x, a, h_chunks, dy, dh_last=None):
    """``(d dt, d bt, d ct, d x, d a)`` of ``ssm_scan`` for the gradients
    ``dy`` of ``y`` and ``dh_last`` of the final state (``None``: zero);
    ``h_chunks`` is ``ssm_scan_fwd``'s.  On the CPU the plain version
    ignores ``h_chunks``."""
    dev, (B, S, D, N) = _check_args(dt, bt, ct, x, a)
    check("h_chunks", h_chunks, torch.float32, (B, _n_chunks(S), D, N), dev)
    check("dy", dy, torch.float32, (B, S, D), dev)
    if dh_last is not None:
        check("dh_last", dh_last, torch.float32, (B, D, N), dev)
    if plain(x):
        return ssm_scan_bwd_plain(dt, bt, ct, x, a, dy, dh_last)
    return torch.ops.repro_torch.ssm_scan_bwd(dt, bt, ct, x, a, h_chunks, dy,
                                              dh_last)


def _launch_bwd(dt, bt, ct, x, a, h_chunks, dy, dh_last):
    B, S, D = x.shape
    N = bt.shape[2]
    dev = x.device
    if N > MAX_STATE:
        raise ValueError(f"ssm_scan: state width {N} above {MAX_STATE}")
    grads = [torch.empty_like(t) for t in (dt, bt, ct, x, a)]
    if not (S and N):       # nothing flows: y is zero, h_last constant
        return tuple(g.zero_() for g in grads)
    ddt, dbt, dct, dx, da = grads
    nbd = -(-D // CHANNELS)
    db_part = torch.empty((nbd, B, S, N), dtype=torch.float32, device=dev)
    dc_part = torch.empty_like(db_part)
    da_part = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    launch("ssm_scan_bwd", dt.data_ptr(), bt.data_ptr(), ct.data_ptr(),
           x.data_ptr(), a.data_ptr(), h_chunks.data_ptr(), dy.data_ptr(),
           0 if dh_last is None else dh_last.data_ptr(), ddt.data_ptr(),
           dbt.data_ptr(), dct.data_ptr(), dx.data_ptr(), da.data_ptr(),
           db_part.data_ptr(), dc_part.data_ptr(), da_part.data_ptr(), B, S,
           D, N)
    return ddt, dbt, dct, dx, da


# the three launches as operators: a CUDA kernel each and a shape-only form
_ARGS = "Tensor dt, Tensor bt, Tensor ct, Tensor x, Tensor a"
_scan_op = torch.library.custom_op(
    "repro_torch::ssm_scan",
    lambda dt, bt, ct, x, a: _launch_fwd(dt, bt, ct, x, a, False)[:2],
    mutates_args=(), device_types="cuda",
    schema=f"({_ARGS}) -> (Tensor, Tensor)")
_scan_fwd_op = torch.library.custom_op(
    "repro_torch::ssm_scan_fwd",
    lambda dt, bt, ct, x, a: _launch_fwd(dt, bt, ct, x, a, True),
    mutates_args=(), device_types="cuda",
    schema=f"({_ARGS}) -> (Tensor, Tensor, Tensor)")
_scan_bwd_op = torch.library.custom_op(
    "repro_torch::ssm_scan_bwd", _launch_bwd, mutates_args=(),
    device_types="cuda",
    schema=(f"({_ARGS}, Tensor h_chunks, Tensor dy, Tensor? dh_last) -> "
            f"(Tensor, Tensor, Tensor, Tensor, Tensor)"))


def _fake_outputs(bt, x, keep_chunks: bool):
    B, S, D = x.shape
    N = bt.shape[2]
    out = (torch.empty_like(x), x.new_empty((B, D, N)))
    return out + (x.new_empty((B, _n_chunks(S), D, N)),) if keep_chunks else out


@_scan_op.register_fake
def _(dt, bt, ct, x, a):
    return _fake_outputs(bt, x, False)


@_scan_fwd_op.register_fake
def _(dt, bt, ct, x, a):
    return _fake_outputs(bt, x, True)


@_scan_bwd_op.register_fake
def _(dt, bt, ct, x, a, h_chunks, dy, dh_last):
    return tuple(torch.empty_like(t) for t in (dt, bt, ct, x, a))


class SSMScanFn(torch.autograd.Function):
    """``ssm_scan`` with the backward kernel: the forward keeps the chunk
    states for it (``ssm_scan_fwd`` / ``ssm_scan_bwd``)."""

    @staticmethod
    def forward(ctx, dt, bt, ct, x, a):
        y, h_last, hc = ssm_scan_fwd(dt, bt, ct, x, a)
        ctx.save_for_backward(dt, bt, ct, x, a, hc)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, bt, ct, x, a, hc = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        return ssm_scan_bwd(dt, bt, ct, x, a, hc, dy, dh_last)


def ssm_scan_plain(dt, bt, ct, x, a):
    """Plain PyTorch version of ``ssm_scan`` (same arguments): the
    recurrence, one step at a time."""
    return ssm_scan_chunks_plain(dt, bt, ct, x, a)[:2]


def ssm_scan_chunks_plain(dt, bt, ct, x, a):
    """Plain PyTorch version of ``ssm_scan_fwd``: ``(y, h_last,
    h_chunks)``."""
    _, (B, S, D, N) = _check_args(dt, bt, ct, x, a)
    h = torch.zeros((B, D, N), dtype=torch.float32, device=x.device)
    ys, hc = [], []
    dtx = dt * x
    for t in range(S):
        h = h * torch.exp(dt[:, t, :, None] * a) + dtx[:, t, :, None] * bt[:, t, None, :]
        ys.append((h * ct[:, t, None, :]).sum(-1))
        if t % CHUNK == CHUNK - 1 or t == S - 1:
            hc.append(h)
    y = (torch.stack(ys, 1) if ys else
         torch.zeros((B, S, D), dtype=torch.float32, device=x.device))
    hc = (torch.stack(hc, 1) if hc else
          torch.zeros((B, 0, D, N), dtype=torch.float32, device=x.device))
    return y, h, hc


def ssm_scan_bwd_plain(dt, bt, ct, x, a, dy, dh_last=None):
    """Plain PyTorch version of ``ssm_scan_bwd``: autograd through
    ``ssm_scan_plain``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (dt, bt, ct, x, a)]
        y, h_last = ssm_scan_plain(*leaves)
        outs, grads = [y], [dy]
        if dh_last is not None:
            outs.append(h_last)
            grads.append(dh_last)
        got = torch.autograd.grad(outs, leaves, grads, allow_unused=True)
        return tuple(torch.zeros_like(t) if g is None else g
                     for g, t in zip(got, leaves))
