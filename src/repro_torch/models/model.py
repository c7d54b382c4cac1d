"""Unified decoder-LM / enc-dec model over the arch zoo, for training and
serving: dense GQA attention, Mamba-1, MoE FFNs, MLA attention, the
encoder-decoder (whisper) and VLM patch-embedding prefix (chameleon) paths,
and the int8 KV cache.

The reference's ``models/model.py`` stacks each repeating group's params and
runs them with ``jax.lax.scan``; here the params are one dict per layer
(``params["layers"][i]``, the reference's prelude layers and group slots
unstacked in layer order, see ``convert.params_from_jax``) and a Python
loop walks them; the enc-dec path's encoder, cross-attention and position
tables sit under ``params["encdec"]`` as in the reference.  Decode caches
are one dict per layer as well, updated in place; for enc-dec one more
dict, ``{"enc_out": (B, enc_seq, D)}``, follows the layers' (the encoder
states the decoder cross-attends to; ``init_decode_caches`` zeroes them, as
the reference's).  Training (``forward_hidden`` / ``forward`` with
``remat``) recomputes each decoder-only layer in the backward pass
(``torch.utils.checkpoint``), where the reference wraps each scanned group
in ``jax.checkpoint``; the flash attention and selective scan kernels are
differentiated by their own backward kernels.

Entry points: ``init_params`` / ``forward_hidden`` / ``forward`` /
``decode_step`` / ``init_decode_caches`` / ``prefill_with_caches`` /
``input_specs`` (meta tensors for the dry-run).  ``set_activation_policy``
installs the dry-run's hook on the residual stream, called after each layer
of the reference's scanned groups (``group_structure``).
"""
from __future__ import annotations

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ArchConfig, ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE


# ---------------------------------------------------------------------------
# activation-sharding policy (set by the launcher/dry-run; model code stays
# mesh-agnostic). kinds: "residual" (between blocks)
# ---------------------------------------------------------------------------

_ACT_POLICY = None


def set_activation_policy(fn) -> None:
    """fn(x, kind) -> x, e.g. a DTensor ``redistribute`` of the residual
    stream for sequence-parallel TP; ``None`` removes it."""
    global _ACT_POLICY
    _ACT_POLICY = fn


def _constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    if _ACT_POLICY is None:
        return x
    return _ACT_POLICY(x, kind)


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
    elif cfg.mla is not None:
        p["mixer"] = MLA.init_mla(cfg, generator, dtype, device)
    else:
        p["mixer"] = L.init_attention(cfg, generator, dtype, device)
    if ffn == "dense":
        d_ff = cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense) else cfg.d_ff
        p["ffn"] = L.init_mlp(cfg.d_model, d_ff, generator, dtype, device)
    elif ffn == "moe":
        p["ffn"] = MOE.init_moe(cfg, generator, dtype, device)
    if ffn != "none":
        p["ffn_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return p


def _ffn(cfg: ArchConfig, lp: dict, ffn: str, x: torch.Tensor
         ) -> "tuple[torch.Tensor, torch.Tensor | None]":
    """The layer's FFN residual step: (x, the MoE aux loss or None)."""
    if ffn == "dense":
        return x + L.swiglu(lp["ffn"], L.rmsnorm(x, lp["ffn_norm"],
                                                 cfg.norm_eps)), None
    if ffn == "moe":
        out, aux = MOE.moe_ffn(lp["ffn"], cfg,
                               L.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps))
        return x + out, aux
    return x, None


def _apply_layer(cfg: ArchConfig, lp: dict, layer_idx: int, x: torch.Tensor,
                 positions: "torch.Tensor | None"
                 ) -> "tuple[torch.Tensor, torch.Tensor]":
    """(x, the layer's MoE aux loss, zero without one)."""
    mixer, ffn = _layer_kinds(cfg, layer_idx)
    h = L.rmsnorm(x, lp["mixer_norm"], cfg.norm_eps)
    if mixer == "m":
        h = M.mamba_block(lp["mixer"], cfg, h)
    elif cfg.mla is not None:
        h = MLA.mla_attention(lp["mixer"], cfg, h, positions)
    else:
        h = L.attention(lp["mixer"], cfg, h, local=(mixer == "l"),
                        positions=positions)
    x, aux = _ffn(cfg, lp, ffn, x + h)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _init_encdec(cfg: ArchConfig, generator, dtype, device) -> dict:
    d = cfg.d_model
    ones = lambda: torch.ones((d,), dtype=dtype, device=device)  # noqa: E731
    ed: dict = {"pos": L._normal((8192, d), generator, dtype, device, 0.02),
                "enc_pos": L._normal((cfg.enc_seq, d), generator, dtype,
                                     device, 0.02),
                "enc_final_norm": ones()}
    for i in range(cfg.enc_layers):
        ed[f"enc_{i}"] = {
            "mixer_norm": ones(),
            "mixer": L.init_attention(cfg, generator, dtype, device),
            "ffn_norm": ones(),
            "ffn": L.init_mlp(d, cfg.d_ff, generator, dtype, device),
        }
    for i in range(cfg.n_layers):
        ed[f"cross_{i}"] = {"norm": ones(),
                            "attn": L.init_attention(cfg, generator, dtype,
                                                     device)}
    return ed


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """Random params drawn on ``device`` from ``generator`` (a generator of
    that device), with the reference's scales."""
    d = cfg.d_model
    p: dict = {"embed": L._normal((cfg.vocab, d), generator, dtype, device, 0.02),
               "final_norm": torch.ones((d,), dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L._normal((d, cfg.vocab), generator, dtype, device,
                                 d ** -0.5)
    p["layers"] = [init_layer(cfg, li, generator, dtype, device)
                   for li in range(cfg.n_layers)]
    if cfg.encdec:
        p["encdec"] = _init_encdec(cfg, generator, dtype, device)
    return p


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """Token embeddings, the first ``vlm_prefix`` positions replaced by
    ``batch["patch_embeds"]`` when given."""
    x = params["embed"][batch["tokens"]]
    if cfg.vlm_prefix and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, cfg.vlm_prefix:]], dim=1)
    return x


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """The enc-dec encoder (the reference's ``_encoder``): non-causal
    self-attention through the flash kernel over ``frames`` (B, T, D) plus
    the learned ``enc_pos``; returns the final-norm states (B, T, D)."""
    ed = params["encdec"]
    x = frames.to(params["embed"].dtype) + ed["enc_pos"][None, : frames.shape[1]]
    for i in range(cfg.enc_layers):
        lp = ed[f"enc_{i}"]
        h = L.rmsnorm(x, lp["mixer_norm"], cfg.norm_eps)
        x = x + L.attention(lp["mixer"], cfg, h, local=False, causal=False)
        x = x + L.swiglu(lp["ffn"], L.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps))
    return L.rmsnorm(x, ed["enc_final_norm"], cfg.norm_eps)


def _cross_attention(cfg: ArchConfig, cp: dict, x: torch.Tensor,
                     enc: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention, bidirectional over the encoder states
    (plain, as in the reference)."""
    p = cp["attn"]
    B, S, _ = x.shape
    T = enc.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (L.rmsnorm(x, cp["norm"], cfg.norm_eps) @ p["wq"]).reshape(B, S, h, hd)
    k = (enc @ p["wk"]).reshape(B, T, kv, hd)
    v = (enc @ p["wv"]).reshape(B, T, kv, hd)
    w = torch.softmax(L.gqa_scores(q, k).float(), dim=-1).to(x.dtype)
    return x + L.gqa_output(w, v).reshape(B, S, -1) @ p["wo"]


def _pos_rows(params: dict, positions: torch.Tensor) -> torch.Tensor:
    """Rows of the decoder's learned position table, indexed modulo its
    length."""
    table = params["encdec"]["pos"]
    return table[positions % table.shape[0]]


def _forward_encdec_hidden(cfg: ArchConfig, params: dict, batch: dict):
    enc = encode(cfg, params, batch["frames"])
    ed = params["encdec"]
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = params["embed"][tokens] + _pos_rows(
        params, torch.arange(S, device=tokens.device))[None]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, lp in enumerate(params["layers"]):
        x, a = _apply_layer(cfg, lp, li, x, None)
        aux = aux + a
        x = _cross_attention(cfg, ed[f"cross_{li}"], x, enc)
    return L.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def forward_hidden(cfg: ArchConfig, params: dict, batch: dict,
                   remat: bool = True
                   ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Final-norm hidden states (pre-head): (B, S, D), and the MoE aux loss
    summed over the MoE layers.  With ``remat`` and gradients on, each
    decoder-only layer's activations are recomputed in the backward pass
    instead of kept (the enc-dec path keeps them, as the reference's)."""
    if cfg.encdec:
        return _forward_encdec_hidden(cfg, params, batch)
    x = _embed_inputs(cfg, params, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    # the policy sees the layers the reference scans, not its prelude
    n_prelude = len(group_structure(cfg)[0])
    for li, lp in enumerate(params["layers"]):
        if remat:
            x, a = checkpoint(_apply_layer, cfg, lp, li, x, positions,
                              use_reentrant=False)
        else:
            x, a = _apply_layer(cfg, lp, li, x, positions)
        if li >= n_prelude:
            x = _constrain(x, "residual")
        aux = aux + a
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


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
    zeros = lambda shape, dt=dtype: torch.zeros(  # noqa: E731
        shape, dtype=dt, device=device)
    if mixer == "m":
        d_inner, d_state, d_conv, _ = M._dims(cfg)
        return {"conv": zeros((B, d_conv - 1, d_inner)),
                "state": zeros((B, d_inner, d_state), torch.float32)}
    if cfg.mla is not None:
        m = cfg.mla
        return {"latent": zeros((B, S_ctx, m.kv_lora)),
                "k_rope": zeros((B, S_ctx, 1, m.rope_dim))}
    shape = (B, S_ctx, cfg.n_kv_heads, cfg.hd)
    if cfg.perf.kv_quant_int8:
        return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                "k_scale": zeros(shape[:3], torch.float32),
                "v_scale": zeros(shape[:3], torch.float32)}
    return {"k": zeros(shape), "v": zeros(shape)}


def init_decode_caches(cfg: ArchConfig, B: int, S_ctx: int,
                       dtype=torch.bfloat16, device="cuda") -> list:
    """One cache dict per layer: {"k", "v"} (B, S_ctx, KV, hd) for attention
    (int8, with "k_scale"/"v_scale" (B, S_ctx, KV) float32, under
    ``PerfFlags.kv_quant_int8``), {"latent", "k_rope"} for MLA, {"conv",
    "state"} for Mamba; for enc-dec one more, {"enc_out": (B, enc_seq, D)},
    zeroed."""
    caches = [_init_layer_cache(cfg, li, B, S_ctx, dtype, device)
              for li in range(cfg.n_layers)]
    if cfg.encdec:
        caches.append({"enc_out": torch.zeros((B, cfg.enc_seq, cfg.d_model),
                                              dtype=dtype, device=device)})
    return caches


def _decode_layer(cfg: ArchConfig, lp: dict, cache: dict, layer_idx: int,
                  x: torch.Tensor, pos: torch.Tensor
                  ) -> "tuple[torch.Tensor, dict]":
    mixer, ffn = _layer_kinds(cfg, layer_idx)
    h = L.rmsnorm(x, lp["mixer_norm"], cfg.norm_eps)
    if mixer == "m":
        h, cache = M.mamba_decode(lp["mixer"], cfg, h, cache)
    elif cfg.mla is not None:
        h, cache = MLA.mla_decode(lp["mixer"], cfg, h, cache, pos)
    else:
        h, cache = L.attention_decode(lp["mixer"], cfg, h, cache, pos,
                                      local=(mixer == "l"))
    x, _ = _ffn(cfg, lp, ffn, x + h)
    return x, cache


def decode_step(cfg: ArchConfig, params: dict, caches: list,
                tokens: torch.Tensor, pos: torch.Tensor
                ) -> "tuple[torch.Tensor, list]":
    """One new token per row against the caches. tokens: (B, 1); pos: ()
    shared or (B,) per-slot.  Returns (logits (B, 1, V), caches); the list
    is updated in place and returned.  Enc-dec adds the learned position
    row and cross-attends to ``caches[-1]["enc_out"]`` after each layer."""
    x = params["embed"][tokens]
    if cfg.encdec:
        rows = L.decode_positions(pos, x.shape[0])[:, 0]
        x = x + _pos_rows(params, rows)[:, None]
    for li, lp in enumerate(params["layers"]):
        x, caches[li] = _decode_layer(cfg, lp, caches[li], li, x, pos)
        if cfg.encdec:
            x = _cross_attention(cfg, params["encdec"][f"cross_{li}"], x,
                                 caches[-1]["enc_out"])
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
    elif cfg.mla is not None:
        h, latent, k_rope = MLA.mla_prefill(lp["mixer"], cfg, h, positions)
        cache = _init_layer_cache(cfg, layer_idx, B, S_ctx, dtype, x.device)
        cache["latent"][:, :T] = latent.to(dtype)
        cache["k_rope"][:, :T] = k_rope.to(dtype)
    else:
        h, k, v = L.attention_prefill(lp["mixer"], cfg, h,
                                      local=(mixer == "l"), positions=positions)
        cache = _init_layer_cache(cfg, layer_idx, B, S_ctx, dtype, x.device)
        if cfg.perf.kv_quant_int8:
            # int8 values and their scales, so that a slot placement's cast
            # to the cache's type changes nothing
            for name, t in (("k", k), ("v", v)):
                cache[name][:, :T], cache[name + "_scale"][:, :T] = \
                    L._quant_kv(t)
        else:
            cache["k"][:, :T] = k.to(dtype)
            cache["v"][:, :T] = v.to(dtype)
    x, _ = _ffn(cfg, lp, ffn, x + h)
    return x, cache


def prefill_with_caches(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                        S_ctx: int, dtype=torch.float32
                        ) -> "tuple[torch.Tensor, list]":
    """tokens: (B, T) prompt. Returns (last-token logits (B, 1, V), decode
    caches positioned at T). Decoder-only path (enc-dec admits via its
    encoder + token-by-token decode)."""
    if cfg.encdec:
        raise ValueError("enc-dec prefill goes through the encoder")
    x = params["embed"][tokens]
    T = x.shape[1]
    positions = torch.arange(T, device=x.device)[None, :]
    caches = []
    for li, lp in enumerate(params["layers"]):
        x, cache = _prefill_layer(cfg, lp, li, x, positions, S_ctx, dtype)
        caches.append(cache)
    x = L.rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return x @ lm_head(cfg, params), caches


# ---------------------------------------------------------------------------
# dry-run input specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> dict:
    """``meta`` tensors standing in for every model input (no allocation),
    the reference's ``ShapeDtypeStruct``s."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def meta(shape_, dt):
        return torch.empty(shape_, dtype=dt, device="meta")

    if shape.kind == "train":
        batch = {"tokens": meta((B, S), i32), "labels": meta((B, S), i32)}
    elif shape.kind == "prefill":
        batch = {"tokens": meta((B, S), i32)}
    else:  # decode
        batch = {"tokens": meta((B, 1), i32)}
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["patch_embeds"] = meta((B, cfg.vlm_prefix, cfg.d_model), dtype)
    if cfg.encdec and shape.kind != "decode":
        batch["frames"] = meta((B, cfg.enc_seq, cfg.d_model), dtype)
    return batch
