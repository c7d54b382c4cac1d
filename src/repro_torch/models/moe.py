"""Mixture-of-Experts FFN with sort-based dispatch, as the reference's
``models/moe.py``.

The (token, k) assignments are sorted by expert id (stable), ranked within
their expert, and those ranked below the capacity ``C ≈ cf·T·K/E`` gathered
into an ``(E·C, D)`` buffer; the experts run as batched products over it
and each token takes back its ``K`` outputs weighted by its renormalised
gates.  Assignments ranked ``C`` or later are dropped, as the reference's
``.at[tgt].set(..., mode="drop")`` drops them.  Shared experts (DeepSeek)
run densely for every token.

The reference scatters the expert outputs back with ``.at[st].add``; a
CUDA ``index_add_`` would sum a token's ``K`` contributions in atomic
order.  Here each assignment's buffer row is found through the inverse of
the sort, so dispatch and combine are gathers, and a token's ``K``
contributions are summed in ``k`` order: no atomics, and two runs on the
same inputs give the same bits.  The products stay plain ``torch``, as the
reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config.base import ArchConfig
from repro_torch.models.layers import _normal


def init_moe(cfg: ArchConfig, generator, dtype, device) -> dict:
    m = cfg.moe
    d = cfg.d_model
    p = {
        "router": _normal((d, m.n_experts), generator, torch.float32, device,
                          d ** -0.5),
        "wi": _normal((m.n_experts, d, m.d_expert), generator, dtype, device,
                      d ** -0.5),
        "wg": _normal((m.n_experts, d, m.d_expert), generator, dtype, device,
                      d ** -0.5),
        "wo": _normal((m.n_experts, m.d_expert, d), generator, dtype, device,
                      m.d_expert ** -0.5),
    }
    if m.n_shared:
        f = m.n_shared * m.d_expert
        p["shared_wi"] = _normal((d, f), generator, dtype, device, d ** -0.5)
        p["shared_wg"] = _normal((d, f), generator, dtype, device, d ** -0.5)
        p["shared_wo"] = _normal((f, d), generator, dtype, device, f ** -0.5)
    return p


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens routed together: Python's
    ``round`` (half to even) on host numbers, as the reference."""
    m = cfg.moe
    return int(max(4, round(m.capacity_factor * n_tokens * m.top_k
                            / m.n_experts)))


def route(p: dict, cfg: ArchConfig, xt: torch.Tensor):
    """Router of ``xt`` (T, D): ``(probs (T, E) float32, gates (T, K)
    renormalised, expert ids (T, K), slot of each assignment (T·K,) in (t,
    k) order with ``E·C`` for a dropped one, C)``."""
    m = cfg.moe
    T = xt.shape[0]
    K, E = m.top_k, m.n_experts
    C = capacity(cfg, T)
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)      # (T, E)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)           # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat_e = gate_idx.reshape(-1)                                # (T·K,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    ar = torch.arange(T * K, device=xt.device)
    rank = ar - torch.searchsorted(se, se, side="left")
    tgt = torch.where(rank < C, se * C + rank, E * C)           # sorted order
    slot = torch.empty_like(tgt)
    slot[order] = tgt                                            # (t, k) order
    return probs, gate_vals, gate_idx, slot, C


def dropped(p: dict, cfg: ArchConfig, x: torch.Tensor) -> int:
    """Assignments of ``x`` (B, S, D) that capacity drops."""
    m = cfg.moe
    _, _, _, slot, C = route(p, cfg, x.reshape(-1, x.shape[-1]))
    return int((slot == m.n_experts * C).sum())


def moe_ffn(p: dict, cfg: ArchConfig, x: torch.Tensor
            ) -> "tuple[torch.Tensor, torch.Tensor]":
    """x: (B, S, D) -> (out, aux load-balance loss)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    K, E = m.top_k, m.n_experts
    xt = x.reshape(T, D)
    probs, gate_vals, gate_idx, slot, C = route(p, cfg, xt)

    # aux loss (Switch): density x mean router prob
    density = torch.bincount(gate_idx.reshape(-1), minlength=E).float() / (T * K)
    aux = (density * probs.mean(0)).sum() * E

    # dispatch: each kept slot gathers its assignment's token row (an empty
    # slot the zero row past the end)
    src = torch.full((E * C + 1,), T * K, dtype=torch.long, device=x.device)
    src[slot] = torch.arange(T * K, device=x.device)  # dropped -> row E*C
    xk = torch.cat([xt.repeat_interleave(K, dim=0), xt.new_zeros((1, D))])
    eb = xk[src[: E * C]].reshape(E, C, D)
    h = F.silu(torch.bmm(eb, p["wg"])) * torch.bmm(eb, p["wi"])
    out_e = torch.bmm(h, p["wo"]).reshape(E * C, D)

    # combine: each assignment's row (zero when dropped) times its gate,
    # a token's K contributions summed in k order
    out_e = torch.cat([out_e, out_e.new_zeros((1, D))])
    contrib = (out_e[slot] * gate_vals.reshape(-1, 1).to(x.dtype)
               ).reshape(T, K, D)
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]

    if m.n_shared:
        sh = F.silu(xt @ p["shared_wg"]) * (xt @ p["shared_wi"])
        out = out + sh @ p["shared_wo"]
    return out.reshape(B, S, D), aux
