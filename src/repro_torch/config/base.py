"""Architecture / shape / mesh configuration dataclasses.

Every assigned architecture is an ``ArchConfig`` in
``repro_torch.configs.<id>``; ``reduced_config`` shrinks any of them for CPU
smoke tests while preserving the structural features (layer pattern,
MoE/MLA/SSM blocks, GQA ratios).  A copy of the reference's
``config/base.py``: the same data, so both packages build the same models.

Of the ``PerfFlags``, the port's models read ``kv_quant_int8`` (the int8
KV cache) and ``mla_absorb`` (MLA's absorbed decode), and the training loss
``chunked_loss``/``loss_chunk``: its prefill attention is always the flash
kernel (``chunked_attention``/``attn_chunk`` have no effect) and its
selective scan walks the whole sequence in one kernel (``mamba_chunk`` has
no effect).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0           # always-on shared experts (DeepSeek)
    every: int = 1              # MoE FFN every k-th layer (Jamba: 2)
    first_k_dense: int = 0      # leading dense-FFN layers (DeepSeek: 1)
    capacity_factor: float = 1.25
    d_ff_dense: int = 0         # dense FFN width for non-MoE layers


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    nope_dim: int = 128
    rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0            # 0 => d_model // 16


@dataclass(frozen=True)
class PerfFlags:
    """Beyond-baseline performance switches (EXPERIMENTS.md §Perf records
    baseline=all-off vs optimized=per-cell choices)."""

    chunked_attention: bool = False   # flash-style online-softmax, O(S·c) mem
    attn_chunk: int = 1024
    chunked_loss: bool = False        # never materialize (B, S, V) logits
    loss_chunk: int = 512
    mamba_chunk: int = 0              # 0=off; else chunked selective scan
    mla_absorb: bool = False          # MLA decode via absorbed projections
    seq_parallel: bool = False        # residual stream sharded over 'model'
                                      # between blocks (reduce-scatter TP)
    kv_quant_int8: bool = False       # int8 KV cache w/ per-(token,head)
                                      # scales: ~2x decode memory term


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | vlm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    local_window: int = 0       # sliding-window size for 'l' layers
    layer_pattern: str = "g"    # mixer per layer, cycled: g=global attn,
                                # l=local attn, m=mamba
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    encdec: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500         # encoder frames (audio stub)
    vlm_prefix: int = 0         # leading positions fed by patch-embed stub
    norm_eps: float = 1e-6
    sub_quadratic: bool = False  # eligible for long_500k
    notes: str = ""
    perf: PerfFlags = PerfFlags()

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def mixer_of(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def ffn_is_moe(self, layer: int) -> bool:
        if self.moe is None:
            return False
        if layer < self.moe.first_k_dense:
            return False
        return (layer % self.moe.every) == (self.moe.every - 1) if self.moe.every > 1 else True

    @property
    def pattern_len(self) -> int:
        import math
        base = len(self.layer_pattern)
        if self.moe is not None and self.moe.every > 1:
            base = base * self.moe.every // math.gcd(base, self.moe.every)
        return base

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline accounting)."""
        d, hd = self.d_model, self.hd
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = self.mixer_of(i)
            if kind in ("g", "l"):
                if self.mla is not None:
                    m = self.mla
                    total += d * m.q_lora + m.q_lora * self.n_heads * (m.nope_dim + m.rope_dim)
                    total += d * (m.kv_lora + m.rope_dim)
                    total += m.kv_lora * self.n_heads * (m.nope_dim + m.v_dim)
                    total += self.n_heads * m.v_dim * d
                else:
                    total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    total += self.n_heads * hd * d
            elif kind == "m":
                s = self.ssm or SSMConfig()
                di = s.expand * d
                dt = s.dt_rank or d // 16
                total += d * 2 * di + di * s.d_conv + di * (dt + 2 * s.d_state) + dt * di + di * s.d_state + di * d
            if kind in ("g", "l", "m"):
                if self.ffn_is_moe(i):
                    m = self.moe
                    total += 3 * d * m.d_expert * (m.n_experts + m.n_shared) + d * m.n_experts
                else:
                    ff = (self.moe.d_ff_dense if (self.moe and self.moe.d_ff_dense) else self.d_ff)
                    if ff:
                        total += 3 * d * ff
            total += 2 * d  # norms
        if self.encdec:
            for _ in range(self.enc_layers):
                total += 4 * d * self.n_heads * hd + 3 * d * self.d_ff + 2 * d
                total += 4 * d * self.n_heads * hd  # cross attention in decoder
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE top-k) for MODEL_FLOPS = 6·N_act·D."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        # subtract inactive experts
        for i in range(self.n_layers):
            if self.ffn_is_moe(i):
                total -= 3 * d * m.d_expert * (m.n_experts - m.top_k)
        return int(total)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Shrink for CPU smoke tests, preserving family structure."""
    kv_ratio = max(1, cfg.n_heads // max(1, cfg.n_kv_heads))
    n_heads = 4
    small = dict(
        n_layers=min(cfg.n_layers, 2 * cfg.pattern_len) if cfg.pattern_len > 1 else 2,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=max(1, n_heads // kv_ratio),
        d_ff=128,
        vocab=256,
        head_dim=16,
        enc_layers=min(cfg.enc_layers, 2),
        enc_seq=32,
        local_window=min(cfg.local_window, 8) if cfg.local_window else 0,
        vlm_prefix=min(cfg.vlm_prefix, 8) if cfg.vlm_prefix else 0,
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_expert=64,
            d_ff_dense=128 if cfg.moe.d_ff_dense else 0)
    if cfg.mla is not None:
        small["mla"] = MLAConfig(q_lora=32, kv_lora=16, nope_dim=16, rope_dim=8, v_dim=16)
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(cfg.ssm, d_state=8)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
