"""Multi-head Latent Attention (DeepSeek-V2), as the reference's
``models/mla.py``: queries through a low-rank projection, keys and values
decompressed from a shared latent, and a decoupled rope key shared by every
head.  Decode caches only the latent and the rope key per token.

The reference's MLA is plain einsums, so this is plain ``torch`` too: it
does not go through the flash kernel, whose q, k and v share one head width
(MLA's q/k width, nope + rope, differs from its v width).
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ArchConfig
from repro_torch.models.layers import (NEG_INF, _normal, _positions,
                                       cache_insert, decode_positions,
                                       rmsnorm, rope)


def init_mla(cfg: ArchConfig, generator, dtype, device) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    s = d ** -0.5
    return {
        "wdq": _normal((d, m.q_lora), generator, dtype, device, s),
        "q_norm": torch.ones((m.q_lora,), dtype=dtype, device=device),
        "wuq": _normal((m.q_lora, h * (m.nope_dim + m.rope_dim)), generator,
                       dtype, device, m.q_lora ** -0.5),
        "wdkv": _normal((d, m.kv_lora), generator, dtype, device, s),
        "kv_norm": torch.ones((m.kv_lora,), dtype=dtype, device=device),
        "wkr": _normal((d, m.rope_dim), generator, dtype, device, s),
        "wuk": _normal((m.kv_lora, h * m.nope_dim), generator, dtype, device,
                       m.kv_lora ** -0.5),
        "wuv": _normal((m.kv_lora, h * m.v_dim), generator, dtype, device,
                       m.kv_lora ** -0.5),
        "wo": _normal((h * m.v_dim, d), generator, dtype, device,
                      (h * m.v_dim) ** -0.5),
    }


def _mla_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor):
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.n_heads
    q = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps) @ p["wuq"]
    q = q.reshape(B, S, h, m.nope_dim + m.rope_dim)
    q_nope, q_rope = q[..., : m.nope_dim], q[..., m.nope_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    latent = rmsnorm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)  # (B, S, kv_lora)
    k_rope = rope((x @ p["wkr"])[:, :, None, :], positions,
                  cfg.rope_theta)                                # (B, S, 1, r)
    return q_nope, q_rope, latent, k_rope


def _softmax_weights(cfg: ArchConfig, scores: torch.Tensor, mask, dtype):
    m = cfg.mla
    scores = scores.float() / ((m.nope_dim + m.rope_dim) ** 0.5)
    return torch.softmax(scores + mask, dim=-1).to(dtype)


def _mla_attend(p, cfg, q_nope, q_rope, latent, k_rope, mask):
    """Attention given (possibly cached) latent and rope keys."""
    m = cfg.mla
    B, S, h, _ = q_nope.shape
    T = latent.shape[1]
    k_nope = (latent @ p["wuk"]).reshape(B, T, h, m.nope_dim)
    v = (latent @ p["wuv"]).reshape(B, T, h, m.v_dim)
    scores = (torch.einsum("bqhd,bthd->bhqt", q_nope, k_nope)
              + torch.einsum("bqhr,btxr->bhqt", q_rope, k_rope))
    w = _softmax_weights(cfg, scores, mask, v.dtype)
    out = torch.einsum("bhqt,bthd->bqhd", w, v).reshape(B, S, h * m.v_dim)
    return out @ p["wo"]


def _causal_mask(S: int, device) -> torch.Tensor:
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    return torch.where(j > i, NEG_INF, 0.0)


def mla_attention(p: dict, cfg: ArchConfig, x: torch.Tensor,
                  positions: "torch.Tensor | None" = None) -> torch.Tensor:
    return mla_prefill(p, cfg, x, positions)[0]


def mla_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: "torch.Tensor | None" = None
                ) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """Full-sequence MLA that also returns (latent, k_rope) for the decode
    cache."""
    S = x.shape[1]
    if positions is None:
        positions = _positions(S, x.device)
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, cfg, x, positions)
    out = _mla_attend(p, cfg, q_nope, q_rope, latent, k_rope,
                      _causal_mask(S, x.device))
    return out, latent, k_rope


def mla_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
               pos: torch.Tensor) -> "tuple[torch.Tensor, dict]":
    """cache: {"latent": (B, S_ctx, kv_lora), "k_rope": (B, S_ctx, 1, rope)},
    written in place at ``pos``."""
    B = x.shape[0]
    positions = decode_positions(pos, B)
    q_nope, q_rope, latent_new, k_rope_new = _mla_qkv(p, cfg, x, positions)
    latent = cache_insert(cache["latent"], latent_new, pos)
    k_rope = cache_insert(cache["k_rope"], k_rope_new, pos)
    T = latent.shape[1]
    pb = positions[:, 0][:, None, None, None]                    # (B,1,1,1)
    mask = torch.where(torch.arange(T, device=x.device)[None, None, None, :]
                       > pb, NEG_INF, 0.0)
    attend = _mla_attend_absorbed if cfg.perf.mla_absorb else _mla_attend
    out = attend(p, cfg, q_nope, q_rope, latent, k_rope, mask)
    return out, {"latent": latent, "k_rope": k_rope}


def _mla_attend_absorbed(p, cfg, q_nope, q_rope, latent, k_rope, mask):
    """Decode with the absorption trick: W_uk folded into the query and W_uv
    into the output, so attention runs in latent space and the cache is
    never expanded to per-head keys and values."""
    m = cfg.mla
    B, S, h, _ = q_nope.shape
    wuk_h = p["wuk"].reshape(m.kv_lora, h, m.nope_dim)
    q_lat = torch.einsum("bqhn,khn->bqhk", q_nope, wuk_h)       # (B,S,h,kv_lora)
    scores = (torch.einsum("bqhk,btk->bhqt", q_lat, latent)
              + torch.einsum("bqhr,btxr->bhqt", q_rope, k_rope))
    w = _softmax_weights(cfg, scores, mask, latent.dtype)
    o_lat = torch.einsum("bhqt,btk->bqhk", w, latent)           # (B,S,h,kv_lora)
    wuv_h = p["wuv"].reshape(m.kv_lora, h, m.v_dim)
    out = torch.einsum("bqhk,khv->bqhv", o_lat, wuv_h).reshape(B, S, h * m.v_dim)
    return out @ p["wo"]
