"""Shared transformer layers: RMSNorm, RoPE, GQA attention (global/local,
qk-norm, bias), SwiGLU MLP.  Functional style over dicts of tensors, as the
reference's ``models/layers.py``; every function takes the activation dtype
from its inputs.

Full-sequence attention (``attention``, ``attention_prefill``) goes through
``kernels.ops.flash_attention_gqa``: the flash kernel on the card (and in
training its backward kernel), its plain masked softmax on the CPU.  The reference computes the same function as a
naive masked softmax with a ``-1e9`` mask; the kernel's ``-1e30`` gives the
same result on every row with a visible key, which causal attention always
has.  Decode attention over the cache stays plain, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ArchConfig
from repro_torch.kernels import ops

NEG_INF = -1e9  # additive mask value of the plain decode attention


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd) (hd even); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = theta ** (-ar / half)
    ang = positions[..., None].float() * freqs                    # (..., S, half)
    # cos and sin through torch.polar, not torch.cos / torch.sin: on the
    # CPU those go to MKL's vector math, whose first call in a process now
    # and then returns float32 values up to 1.5e-4 off (ROADMAP queue 3,
    # F2); polar's CPU kernel is the scalar libm, exact to float32 rounding
    rot = torch.polar(torch.ones_like(ang), ang)[..., None, :]     # (..., S, 1, half)
    cos = rot.real.to(x.dtype)
    sin = rot.imag.to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _normal(shape, generator, dtype, device, scale: float) -> torch.Tensor:
    """Standard normal draws on ``device`` (float32, then cast) times
    ``scale``."""
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=device)
    return out.mul_(scale).to(dtype)


def init_attention(cfg: ArchConfig, generator, dtype, device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = d ** -0.5
    p = {
        "wq": _normal((d, h * hd), generator, dtype, device, scale),
        "wk": _normal((d, kv * hd), generator, dtype, device, scale),
        "wv": _normal((d, kv * hd), generator, dtype, device, scale),
        "wo": _normal((h * hd, d), generator, dtype, device, scale),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, use_rope: bool = True):
    B, S = x.shape[0], x.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kv, hd)
    v = v.reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if use_rope and cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, hd), k: (B, Sk, KV, hd) -> (B, KV, G, Sq, Sk)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    return torch.einsum("bqkgd,bskd->bkgqs", qg, k) / (hd ** 0.5)


def gqa_output(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w: (B, KV, G, Sq, Sk), v: (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    B, KV, G, Sq, Sk = w.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, KV * G, -1)


def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :]


def attention(p: dict, cfg: ArchConfig, x: torch.Tensor, *, local: bool,
              causal: bool = True,
              positions: "torch.Tensor | None" = None) -> torch.Tensor:
    """Full-sequence (training/prefill) attention, through the flash
    kernel."""
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(S, x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    window = cfg.local_window if local else 0
    out = ops.flash_attention_gqa(q, k, v, causal=causal, window=window)
    return out.reshape(B, S, -1) @ p["wo"]


def decode_positions(pos: torch.Tensor, B: int) -> torch.Tensor:
    """pos: () shared or (B,) per-slot -> (B, 1) positions."""
    if pos.dim() == 0:
        return pos.long().expand(B)[:, None]
    return pos[:, None].long()


def cache_insert(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Write new (B, 1, ...) at per-row (or shared) position along axis 1,
    in place (the reference returns an updated copy); returns ``cache``."""
    B = cache.shape[0]
    rows = torch.arange(B, device=cache.device)
    idx = pos.long().expand(B) if pos.dim() == 0 else pos.long()
    cache[rows, idx] = new[:, 0].to(cache.dtype)
    return cache


def _quant_kv(t: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """t: (B, T, KV, hd) -> int8 values and per-(token, head) float32
    scales.  ``torch.round`` rounds half to even, as ``jnp.round``."""
    tf = t.float()
    s = torch.clamp(tf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(tf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _dequant(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """int8 cache values times their scales, multiplied in ``dtype``."""
    return q.to(dtype) * s[..., None].to(dtype)


def attention_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, *, local: bool) -> "tuple[torch.Tensor, dict]":
    """One-token decode against a preallocated KV cache (plain, as in the
    reference).

    cache: {"k": (B, S_ctx, KV, hd), "v": same} (+ "k_scale"/"v_scale"
    (B, S_ctx, KV) float32 when the cache is int8,
    ``PerfFlags.kv_quant_int8``), written in place at ``pos`` (() shared or
    (B,) per-slot, the index the new token writes to); attends to [0, pos].
    """
    B = x.shape[0]
    positions = decode_positions(pos, B)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    if cfg.perf.kv_quant_int8:
        for name, new in (("k", k_new), ("v", v_new)):
            qv, sc = _quant_kv(new)
            cache_insert(cache[name], qv, pos)
            cache_insert(cache[name + "_scale"], sc, pos)
        k = _dequant(cache["k"], cache["k_scale"], x.dtype)
        v = _dequant(cache["v"], cache["v_scale"], x.dtype)
    else:
        k = cache_insert(cache["k"], k_new, pos)
        v = cache_insert(cache["v"], v_new, pos)
    S_ctx = k.shape[1]
    scores = gqa_scores(q, k).float()                 # (B, KV, G, 1, S_ctx)
    j = torch.arange(S_ctx, device=x.device)[None, None, None, None, :]
    pb = positions[:, 0][:, None, None, None, None]   # (B,1,1,1,1)
    mask = torch.where(j > pb, NEG_INF, 0.0)
    if local and cfg.local_window:
        mask = mask + torch.where(pb - j >= cfg.local_window, NEG_INF, 0.0)
    w = torch.softmax(scores + mask, dim=-1).to(x.dtype)
    out = gqa_output(w, v).reshape(B, 1, -1) @ p["wo"]
    return out, cache


def attention_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor, *, local: bool,
                      positions: "torch.Tensor | None" = None
                      ) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """Full-sequence causal attention through the flash kernel that also
    returns the rope'd (k, v) for seeding a decode cache (serving prefill
    path)."""
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(S, x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    window = cfg.local_window if local else 0
    out = ops.flash_attention_gqa(q, k, v, causal=True, window=window)
    return out.reshape(B, S, -1) @ p["wo"], k, v


def init_mlp(d: int, f: int, generator, dtype, device) -> dict:
    return {
        "wi": _normal((d, f), generator, dtype, device, d ** -0.5),
        "wg": _normal((d, f), generator, dtype, device, d ** -0.5),
        "wo": _normal((f, d), generator, dtype, device, f ** -0.5),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
