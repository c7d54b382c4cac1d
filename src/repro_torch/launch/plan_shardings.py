"""Odyssey-style cost-based layout planning for the LM substrate
(beyond-paper, DESIGN.md §4), the reference's ``launch/plan_shardings.py``
over the port's roofline (``launch/roofline.py``: one H100 SXM's peaks,
80 GB of HBM).

The paper's optimizer enumerates plans and picks the argmin of a cost model
over intermediate-result/transfer sizes. This module applies the same
discipline to *sharding/execution layout*: enumerate the layout space
(TP collective mode × attention impl × loss impl × scan chunking), estimate
each candidate's three roofline terms analytically, and return the argmin
plan plus the ranked table.

It keeps the reference's 16 candidates, so its ranking can be held against
the reference's, but the port's model realizes only two of the four
choices (``config/base.py``): ``tp_mode`` (``seq_parallel``: the dry-run's
activation policy shards the residual stream over ``model``) and ``loss``
(``chunked_loss``, read by ``train/train_step.py``).  Its prefill and
training attention is always the flash kernel and its selective scan
always one kernel over the whole sequence, whatever ``attention`` and
``mamba`` say.

Estimates are per-device, bf16, for one step:
  * compute  : 6·N_active·tokens (+ attention) / peak
  * memory   : weights + boundary activations + impl-specific state traffic
  * collect. : TP mode bytes (all-reduce 2·B·S·D/dev per layer vs
               reduce-scatter+all-gather at 1/tp of that) + DP grad sync
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from itertools import product

from repro_torch.config.base import ArchConfig, PerfFlags, ShapeConfig
from repro_torch.launch import roofline as RL


@dataclass(frozen=True)
class LayoutChoice:
    tp_mode: str           # "allreduce" | "seq_parallel"
    attention: str         # "naive" | "chunked"
    loss: str              # "full" | "chunked"
    mamba: str             # "full" | "chunked"

    def to_flags(self, shape: ShapeConfig) -> PerfFlags:
        return PerfFlags(
            chunked_attention=self.attention == "chunked" and shape.kind != "decode",
            chunked_loss=self.loss == "chunked" and shape.kind == "train",
            mamba_chunk=512 if self.mamba == "chunked" else 0,
            mla_absorb=True,
            seq_parallel=self.tp_mode == "seq_parallel" and shape.kind != "decode",
        )


@dataclass
class LayoutPlan:
    choice: LayoutChoice
    compute_s: float
    memory_s: float
    collective_s: float
    peak_temp_bytes: float
    feasible: bool          # fits one card's HBM (HBM_CAP)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


HBM_CAP = RL.HBM_CAP     # 80 GB, one H100
DP_AXIS = 16
TP_AXIS = 16


def _terms(cfg: ArchConfig, shape: ShapeConfig, c: LayoutChoice, n_chips: int
           ) -> LayoutPlan:
    B, S = shape.global_batch, shape.seq_len
    tokens = B * (1 if shape.kind == "decode" else S)
    tokens_dev = max(1, tokens // min(n_chips, DP_AXIS * 2))
    d = cfg.d_model
    bytes_ = 2  # bf16

    n_act = cfg.active_param_count()
    mult = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd
    flops_dev = 2.0 * n_act * tokens * mult / n_chips
    flops_dev += RL._attn_flops(cfg, B, S, shape.kind == "train") * mult / n_chips \
        if shape.kind != "decode" else RL._attn_decode_flops(cfg, B, S) / n_chips

    # ---- memory traffic -------------------------------------------------
    w_dev = cfg.param_count() * bytes_ / n_chips
    mem = w_dev * (3.0 if shape.kind == "train" else 1.0)  # read + grad rw
    boundaries = 10.0  # fusion boundaries per layer (norms, residuals, proj IO)
    act = cfg.n_layers * tokens_dev * d * bytes_ * boundaries * (2 if shape.kind == "train" else 1)
    mem += act
    peak = w_dev * (3.0 if shape.kind == "train" else 1.0)
    # attention state
    attn_layers = RL._attn_layers(cfg)
    if shape.kind == "decode":
        kv_dev = attn_layers * B * S * (cfg.mla.kv_lora + cfg.mla.rope_dim if cfg.mla
                                        else 2 * cfg.n_kv_heads * cfg.hd) * bytes_ / n_chips
        mem += kv_dev
        peak += kv_dev
    elif c.attention == "naive":
        sc = attn_layers * tokens_dev * S * cfg.n_heads * 4.0  # f32 scores
        mem += sc * (2 if shape.kind == "train" else 1)
        peak += sc / max(1, cfg.n_layers)  # one layer live at a time (remat)
    else:  # chunked/flash: tiles live on chip (kernel); only QKVO traffic
        qkvo = attn_layers * tokens_dev * cfg.n_heads * cfg.hd * bytes_ * 4
        mem += qkvo
        peak += tokens_dev * d * bytes_ * 4
    # loss head: chunking keeps traffic (all chunks still computed) but
    # bounds the live logits to one chunk — a capacity lever, like flash
    if shape.kind == "train":
        logits = tokens_dev * cfg.vocab * 4.0 / TP_AXIS
        mem += 2 * logits
        peak += logits if c.loss == "full" else logits / max(1, S // 512)
    # mamba state
    if cfg.ssm is not None and shape.kind != "decode":
        di = cfg.ssm.expand * d
        state = cfg.n_layers * tokens_dev * di * cfg.ssm.d_state * 4.0
        if c.mamba == "full":
            mem += state * 2
            peak += state / cfg.n_layers
        else:
            mem += state * 2 / max(1, S // 512)
            peak += state / cfg.n_layers / max(1, S // 512)

    # ---- collectives ----------------------------------------------------
    act_bytes = tokens_dev * d * bytes_
    per_layer = 2 * act_bytes  # two TP syncs per block
    if c.tp_mode == "allreduce":
        coll = cfg.n_layers * 2 * per_layer            # ring all-reduce ~2x
        if shape.kind == "train":
            coll *= 2.0                                 # remat re-runs them
    else:
        coll = cfg.n_layers * 2 * per_layer / TP_AXIS  # rs+ag move 1/tp
    if shape.kind == "train":
        coll += 2 * w_dev                               # DP grad sync
    return LayoutPlan(c, flops_dev / RL.PEAK_FLOPS, mem / RL.HBM_BW,
                      coll / RL.LINK_BW, peak, peak < HBM_CAP)


def plan_layout(cfg: ArchConfig, shape: ShapeConfig, n_chips: int = 256
                ) -> tuple[LayoutPlan, list[LayoutPlan]]:
    """Enumerate layouts, rank by estimated step time among feasible ones."""
    cands = [LayoutChoice(tp, at, ls, mb)
             for tp, at, ls, mb in product(("allreduce", "seq_parallel"),
                                           ("naive", "chunked"),
                                           ("full", "chunked"),
                                           ("full", "chunked"))]
    plans = [_terms(cfg, shape, c, n_chips) for c in cands]
    # feasibility first, then step time, then peak memory (headroom = more
    # batch per chip — ties between equal-traffic layouts go to lower peak)
    ranked = sorted(plans, key=lambda p: (not p.feasible, p.step_s, p.peak_temp_bytes))
    return ranked[0], ranked
