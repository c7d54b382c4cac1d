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

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from repro_torch.kernels.build import D, P, I, check, launch, register, route

register("flash_attention", "flash_attention.cu", "flash_attention",
         [P] * 4 + [I] * 8 + [D])

HEAD_DIMS = (64, 128, 256)     # head widths the kernel is instantiated for
MASK_VALUE = -1e30


def _check_args(q, k, v):
    import torch

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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: "float | None" = None):
    """Attention output ``(B, S, H, hd)`` in ``q``'s type (see the module
    docstring)."""
    import torch

    dev, (B, S, H, KV, hd) = _check_args(q, k, v)
    scale = hd ** -0.5 if scale is None else float(scale)
    if route(dev) == "plain":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {hd} not in "
                         f"{HEAD_DIMS}")
    out = torch.empty_like(q)
    if out.numel():
        launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), B, S, H, KV, hd,
               0 if q.dtype == torch.float32 else 1, int(bool(causal)),
               int(window), scale)
    return out


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: "float | None" = None):
    """Plain PyTorch version of ``flash_attention`` (same arguments): the
    whole masked softmax in float32."""
    import torch

    _, (B, S, H, KV, hd) = _check_args(q, k, v)
    scale = hd ** -0.5 if scale is None else float(scale)
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
    w = torch.softmax(s.masked_fill(masked, MASK_VALUE), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
