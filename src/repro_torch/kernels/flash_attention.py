"""Flash attention with grouped KV heads (online softmax, float32 state).

``flash_attention(q, k, v, causal=, window=, scale=)`` returns, for ``q``
``(B, S, H, hd)`` and ``k``, ``v`` ``(B, S, KV, hd)`` (``H % KV == 0``, query
head ``h`` reads KV head ``h // (H // KV)``), the attention output ``(B, S,
H, hd)`` in ``q``'s type: ``softmax(scale * q k^T + mask) v`` with the
causal mask (key after query) and/or the sliding window (``query - key >=
window``) set to ``-1e30``, as the reference's kernel adds it.  ``scale``
defaults to ``hd ** -0.5``; the reference's own kernel leaves scaling to its
caller, which ``scale=1.0`` reproduces.  float32 and bfloat16 inputs; the
scores, softmax and accumulator are float32.

The kernel, ``csrc/flash_attention.cu``, replaces the reference's Pallas
``flash_attention`` (and the ``jnp.repeat`` of KV heads in its
``flash_attention_gqa`` wrapper): one block of 4 warps per (batch * head,
query tile) loops over key tiles brought into a 2-stage shared-memory ring
by asynchronous copies, skipping tiles that are wholly masked; both products
run on the tensor cores (``mma.sync``: 3xTF32 for float32, bf16 for
bfloat16) with the online softmax on the accumulators in registers.  It
takes any ``S`` (the reference asserts ``S % 128 == 0``) and ``hd`` in
``HEAD_DIMS``.  It is bound by operations.

Training differentiates the kernel through ``FlashAttentionFn``: its
forward launches the kernel with the row log-sum-exp ``lse`` ``(B, H, S)``
(``flash_attention_fwd``), its backward the hand-written
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``: ``dq``, ``dk``,
``dv`` from ``q, k, v, out, dout, lse``, deterministic), on the tensor cores
as the forward: a ``dq`` pass per query tile, a ``dk``/``dv`` pass per
(query head, 64-key tile) into float32 scratch ``(2, B, S, H, hd)`` that
the wrapper allocates when ``H > KV``, and a last launch that sums each KV
head's group in head order.  ``flash_attention`` goes through it whenever
gradients are on and an input requires one.  The reference has no backward
kernel; its training differentiates plain attention with ``jax.grad``.

Each launch is a ``torch.library`` operator of its own
(``repro_torch::flash_attention``, ``::flash_attention_fwd`` and
``::flash_attention_bwd``), with a CUDA kernel and a shape-only form
(``register_fake``): so the dry-run (``launch/dryrun.py``) traces each
kernel as one op, on fake tensors and DTensors, and books the work that
``kernels/work.py`` counts for it, never the plain version's.  A wrapper
runs its plain version only for tensors on the CPU that hold data (the
backward's is autograd through ``flash_attention_plain``); for CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (D, P, I, check, launch, plain,
                                      register, wants_grad)

register("flash_attention", "flash_attention.cu", "flash_attention",
         [P] * 5 + [I] * 8 + [D])
register("flash_attention_bwd", "flash_attention_bwd.cu",
         "flash_attention_bwd", [P] * 11 + [I] * 8 + [D])

HEAD_DIMS = (64, 128, 256)     # head widths the kernel is instantiated for
MASK_VALUE = -1e30


def _check_args(q, k, v):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must be (B, S, heads, hd)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype {q.dtype}, expected float32 "
                        f"or bfloat16")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    dev = q.device
    check("q", q, q.dtype, (B, S, H, hd), dev)
    check("k", k, q.dtype, (B, S, KV, hd), dev)
    check("v", v, q.dtype, (B, S, KV, hd), dev)
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {KV} KV heads")
    return dev, (B, S, H, KV, hd)


def _dtype_code(t) -> int:
    return 0 if t.dtype == torch.float32 else 1


def _launch_fwd(q, k, v, causal, window, scale, with_lse: bool):
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {hd} not in "
                         f"{HEAD_DIMS}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel():
        launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), 0 if lse is None else lse.data_ptr(), B, S, H,
               KV, hd, _dtype_code(q), int(bool(causal)), int(window), scale)
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: "float | None" = None):
    """Attention output ``(B, S, H, hd)`` in ``q``'s type (see the module
    docstring); differentiable on both devices."""
    dev, (B, S, H, KV, hd) = _check_args(q, k, v)
    scale = hd ** -0.5 if scale is None else float(scale)
    if plain(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, bool(causal), int(window),
                                      scale)
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal),
                                                 int(window), scale)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: "float | None" = None):
    """``(out, lse)``: the attention output and each row's log-sum-exp of
    the scaled, masked scores, ``(B, H, S)`` float32 (natural log)."""
    dev, (B, S, H, KV, hd) = _check_args(q, k, v)
    scale = hd ** -0.5 if scale is None else float(scale)
    if plain(q):
        return flash_attention_lse_plain(q, k, v, causal=causal,
                                         window=window, scale=scale)
    return torch.ops.repro_torch.flash_attention_fwd(q, k, v, bool(causal),
                                                     int(window), scale)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: int = 0, scale: "float | None" = None):
    """``(dq, dk, dv)`` of ``flash_attention`` for the output gradient
    ``dout``, in the inputs' type; ``out`` and ``lse`` are
    ``flash_attention_fwd``'s.  On the CPU the plain version ignores
    ``out`` and ``lse``."""
    dev, (B, S, H, KV, hd) = _check_args(q, k, v)
    scale = hd ** -0.5 if scale is None else float(scale)
    check("dout", dout, q.dtype, (B, S, H, hd), dev)
    if plain(q):
        return flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                         window=window, scale=scale)
    check("out", out, q.dtype, (B, S, H, hd), dev)
    check("lse", lse, torch.float32, (B, H, S), dev)
    return torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, out, dout, lse, bool(causal), int(window), scale)


def _launch_bwd(q, k, v, out, dout, lse, causal: bool, window: int,
                scale: float):
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {hd} not in "
                         f"{HEAD_DIMS}")
    dev = q.device
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dl = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    # each query head's dk and dv in float32, summed over a KV head's group
    # by the kernel's last launch (none when every KV head has one)
    scratch = (torch.empty((2, B, S, H, hd), dtype=torch.float32, device=dev)
               if H > KV else None)
    if dq.numel():
        launch("flash_attention_bwd", q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
               dl.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, KV, hd,
               _dtype_code(q), int(bool(causal)), int(window), scale)
    return dq, dk, dv


# the three launches as operators: a CUDA kernel each and a shape-only form
_OPTS = "bool causal, int window, float scale"
_fwd_op = torch.library.custom_op(
    "repro_torch::flash_attention",
    lambda q, k, v, causal, window, scale: _launch_fwd(
        q, k, v, causal, window, scale, False)[0],
    mutates_args=(), device_types="cuda",
    schema=f"(Tensor q, Tensor k, Tensor v, {_OPTS}) -> Tensor")
_fwd_lse_op = torch.library.custom_op(
    "repro_torch::flash_attention_fwd",
    lambda q, k, v, causal, window, scale: _launch_fwd(
        q, k, v, causal, window, scale, True),
    mutates_args=(), device_types="cuda",
    schema=f"(Tensor q, Tensor k, Tensor v, {_OPTS}) -> (Tensor, Tensor)")
_bwd_op = torch.library.custom_op(
    "repro_torch::flash_attention_bwd", _launch_bwd, mutates_args=(),
    device_types="cuda",
    schema=(f"(Tensor q, Tensor k, Tensor v, Tensor out, Tensor dout, "
            f"Tensor lse, {_OPTS}) -> (Tensor, Tensor, Tensor)"))


@_fwd_op.register_fake
def _(q, k, v, causal, window, scale):
    return torch.empty_like(q)


@_fwd_lse_op.register_fake
def _(q, k, v, causal, window, scale):
    B, S, H, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, H, S), dtype=torch.float32))


@_bwd_op.register_fake
def _(q, k, v, out, dout, lse, causal, window, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with the backward kernel: the forward keeps
    ``lse`` for it (``flash_attention_fwd`` / ``flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         **ctx.opts)
        return dq, dk, dv, None, None, None


def _masked_scores(q, k, causal: bool, window: int, scale: float):
    """float32 scores ``(B, KV, G, S, S)`` with masked entries set to
    ``MASK_VALUE``."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    masked = torch.zeros((S, S), dtype=torch.bool, device=q.device)
    if causal:
        masked |= j > i
    if window:
        masked |= i - j >= window
    # setting -1e30 equals the reference's adding it: it absorbs any finite
    # float32 score below 2**75
    return s.masked_fill(masked, MASK_VALUE)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: "float | None" = None):
    """Plain PyTorch version of ``flash_attention`` (same arguments): the
    whole masked softmax in float32."""
    _, (B, S, H, KV, hd) = _check_args(q, k, v)
    scale = hd ** -0.5 if scale is None else float(scale)
    w = torch.softmax(_masked_scores(q, k, causal, window, scale), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_lse_plain(q, k, v, *, causal: bool = True,
                              window: int = 0, scale: "float | None" = None):
    """Plain PyTorch version of ``flash_attention_fwd``: ``(out, lse)``."""
    _, (B, S, H, KV, hd) = _check_args(q, k, v)
    scale = hd ** -0.5 if scale is None else float(scale)
    lse = torch.logsumexp(_masked_scores(q, k, causal, window, scale),
                          dim=-1).reshape(B, H, S)
    out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                scale=scale)
    return out, lse


def flash_attention_bwd_plain(q, k, v, dout, *, causal: bool = True,
                              window: int = 0, scale: "float | None" = None):
    """Plain PyTorch version of ``flash_attention_bwd``: autograd through
    ``flash_attention_plain``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal, window=window,
                                    scale=scale)
        return torch.autograd.grad(out, leaves, dout)
