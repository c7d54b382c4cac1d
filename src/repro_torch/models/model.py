"""Decoder LM over the arch zoo: the dense (GQA attention + SwiGLU) and SSM
(Mamba-1) families, for training and serving.

The reference's ``models/model.py`` stacks each repeating group's params and
runs them with ``jax.lax.scan``; here the params are one dict per layer
(``params["layers"][i]``, the reference's group slots unstacked in layer
order, see ``convert.params_from_jax``) and a Python loop walks them.
Decode caches are one dict per layer as well, updated in place.  Training
(``forward_hidden`` / ``forward`` with ``remat``) recomputes each layer in
the backward pass (``torch.utils.checkpoint``), where the reference wraps
each scanned group in ``jax.checkpoint``; the flash attention and selective
scan kernels are differentiated by their own backward kernels.

Entry points: ``init_params`` / ``forward_hidden`` / ``forward`` /
``decode_step`` / ``init_decode_caches`` / ``prefill_with_caches``.  Not
ported yet: the MoE FFN (``models/moe.py``), MLA attention
(``models/mla.py``), the encoder-decoder path and the VLM patch-embedding
prefix (all four raise ``NotImplementedError``), the int8 KV cache
(raises), the reference's activation-sharding hook
(``set_activation_policy``) and the dry-run's ``input_specs``.
"""
from __future__ import annotations

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M

_ROADMAP = "ROADMAP.md queue item 9"


def _refuse_unported(cfg: ArchConfig) -> None:
    """Raise for the configurations whose modules are not ported yet."""
    for what, present in (("MoE FFN layers (models/moe.py)", cfg.moe),
                          ("MLA attention (models/mla.py)", cfg.mla),
                          ("the encoder-decoder path", cfg.encdec),
                          ("the VLM patch-embedding prefix", cfg.vlm_prefix)):
        if present:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet ({_ROADMAP})")


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def group_structure(cfg: ArchConfig) -> "tuple[list[int], int, int]":
    """(prelude layer indices, n_groups, pattern_len) of the reference's
    stacked layout; the port uses it only to map that layout onto layers."""
    prelude = list(range(cfg.moe.first_k_dense)) if cfg.moe else []
    body = cfg.n_layers - len(prelude)
    pat = cfg.pattern_len
    if body % pat != 0:  # fall back to unscanned prelude remainder
        extra = body % pat
        prelude = prelude + list(range(len(prelude), len(prelude) + extra))
        body -= extra
    return prelude, body // pat, pat


def _layer_kinds(cfg: ArchConfig, layer_idx: int) -> "tuple[str, str]":
    """(mixer kind, ffn kind) for an absolute layer index."""
    mixer = cfg.mixer_of(layer_idx)
    if cfg.d_ff == 0 and not (cfg.moe and cfg.ffn_is_moe(layer_idx)):
        ffn = "none"
    elif cfg.ffn_is_moe(layer_idx):
        ffn = "moe"
    else:
        ffn = "dense"
    return mixer, ffn


def init_layer(cfg: ArchConfig, layer_idx: int, generator, dtype, device) -> dict:
    mixer, ffn = _layer_kinds(cfg, layer_idx)
    p: dict = {"mixer_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if mixer == "m":
        p["mixer"] = M.init_mamba(cfg, generator, dtype, device)
    else:
        p["mixer"] = L.init_attention(cfg, generator, dtype, device)
    if ffn == "dense":
        p["ffn"] = L.init_mlp(cfg.d_model, cfg.d_ff, generator, dtype, device)
        p["ffn_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return p


def _apply_layer(cfg: ArchConfig, lp: dict, layer_idx: int, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    mixer, ffn = _layer_kinds(cfg, layer_idx)
    h = L.rmsnorm(x, lp["mixer_norm"], cfg.norm_eps)
    if mixer == "m":
        h = M.mamba_block(lp["mixer"], cfg, h)
    else:
        h = L.attention(lp["mixer"], cfg, h, local=(mixer == "l"),
                        positions=positions)
    x = x + h
    if ffn == "dense":
        x = x + L.swiglu(lp["ffn"], L.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps))
    return x


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """Random params drawn on ``device`` from ``generator`` (a generator of
    that device), with the reference's scales."""
    _refuse_unported(cfg)
    d = cfg.d_model
    p: dict = {"embed": L._normal((cfg.vocab, d), generator, dtype, device, 0.02),
               "final_norm": torch.ones((d,), dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L._normal((d, cfg.vocab), generator, dtype, device,
                                 d ** -0.5)
    p["layers"] = [init_layer(cfg, li, generator, dtype, device)
                   for li in range(cfg.n_layers)]
    return p


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def forward_hidden(cfg: ArchConfig, params: dict, batch: dict,
                   remat: bool = True
                   ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Final-norm hidden states (pre-head): (B, S, D), and the MoE aux loss
    (zero: no MoE layer is ported).  With ``remat`` and gradients on, each
    layer's activations are recomputed in the backward pass instead of
    kept."""
    _refuse_unported(cfg)
    x = params["embed"][batch["tokens"]]
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    remat = remat and torch.is_grad_enabled()
    for li, lp in enumerate(params["layers"]):
        if remat:
            x = checkpoint(_apply_layer, cfg, lp, li, x, positions,
                           use_reentrant=False)
        else:
            x = _apply_layer(cfg, lp, li, x, positions)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_head(cfg: ArchConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(cfg: ArchConfig, params: dict, batch: dict, remat: bool = True
            ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Returns (logits, moe_aux_loss)."""
    x, aux = forward_hidden(cfg, params, batch, remat)
    return x @ lm_head(cfg, params), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _init_layer_cache(cfg: ArchConfig, layer_idx: int, B: int, S_ctx: int,
                      dtype, device) -> dict:
    mixer, _ = _layer_kinds(cfg, layer_idx)
    if mixer == "m":
        d_inner, d_state, d_conv, _ = M._dims(cfg)
        return {"conv": torch.zeros((B, d_conv - 1, d_inner), dtype=dtype,
                                    device=device),
                "state": torch.zeros((B, d_inner, d_state),
                                     dtype=torch.float32, device=device)}
    L._refuse_int8(cfg)
    shape = (B, S_ctx, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_decode_caches(cfg: ArchConfig, B: int, S_ctx: int,
                       dtype=torch.bfloat16, device="cuda") -> list:
    """One cache dict per layer: {"k", "v"} (B, S_ctx, KV, hd) for attention,
    {"conv", "state"} for Mamba."""
    _refuse_unported(cfg)
    return [_init_layer_cache(cfg, li, B, S_ctx, dtype, device)
            for li in range(cfg.n_layers)]


def _decode_layer(cfg: ArchConfig, lp: dict, cache: dict, layer_idx: int,
                  x: torch.Tensor, pos: torch.Tensor
                  ) -> "tuple[torch.Tensor, dict]":
    mixer, ffn = _layer_kinds(cfg, layer_idx)
    h = L.rmsnorm(x, lp["mixer_norm"], cfg.norm_eps)
    if mixer == "m":
        h, cache = M.mamba_decode(lp["mixer"], cfg, h, cache)
    else:
        h, cache = L.attention_decode(lp["mixer"], cfg, h, cache, pos,
                                      local=(mixer == "l"))
    x = x + h
    if ffn == "dense":
        x = x + L.swiglu(lp["ffn"], L.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps))
    return x, cache


def decode_step(cfg: ArchConfig, params: dict, caches: list,
                tokens: torch.Tensor, pos: torch.Tensor
                ) -> "tuple[torch.Tensor, list]":
    """One new token per row against the caches. tokens: (B, 1); pos: ()
    shared or (B,) per-slot.  Returns (logits (B, 1, V), caches); the list
    is updated in place and returned."""
    _refuse_unported(cfg)
    x = params["embed"][tokens]
    for li, lp in enumerate(params["layers"]):
        x, caches[li] = _decode_layer(cfg, lp, caches[li], li, x, pos)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ lm_head(cfg, params), caches


# ---------------------------------------------------------------------------
# serving prefill: run the prompt full-seq and seed the decode caches
# ---------------------------------------------------------------------------

def _prefill_layer(cfg: ArchConfig, lp: dict, layer_idx: int, x: torch.Tensor,
                   positions: torch.Tensor, S_ctx: int, dtype
                   ) -> "tuple[torch.Tensor, dict]":
    mixer, ffn = _layer_kinds(cfg, layer_idx)
    B, T, _ = x.shape
    h = L.rmsnorm(x, lp["mixer_norm"], cfg.norm_eps)
    if mixer == "m":
        h, cache = M.mamba_prefill(lp["mixer"], cfg, h)
    else:
        L._refuse_int8(cfg)
        h, k, v = L.attention_prefill(lp["mixer"], cfg, h,
                                      local=(mixer == "l"), positions=positions)
        cache = _init_layer_cache(cfg, layer_idx, B, S_ctx, dtype, x.device)
        cache["k"][:, :T] = k.to(dtype)
        cache["v"][:, :T] = v.to(dtype)
    x = x + h
    if ffn == "dense":
        x = x + L.swiglu(lp["ffn"], L.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps))
    return x, cache


def prefill_with_caches(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                        S_ctx: int, dtype=torch.float32
                        ) -> "tuple[torch.Tensor, list]":
    """tokens: (B, T) prompt. Returns (last-token logits (B, 1, V), decode
    caches positioned at T). Decoder-only path (enc-dec admits via its
    encoder + token-by-token decode)."""
    if cfg.encdec:
        raise ValueError("enc-dec prefill goes through the encoder")
    _refuse_unported(cfg)
    x = params["embed"][tokens]
    T = x.shape[1]
    positions = torch.arange(T, device=x.device)[None, :]
    caches = []
    for li, lp in enumerate(params["layers"]):
        x, cache = _prefill_layer(cfg, lp, li, x, positions, S_ctx, dtype)
        caches.append(cache)
    x = L.rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return x @ lm_head(cfg, params), caches
