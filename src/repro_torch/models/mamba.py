"""Mamba-1 block (selective SSM): in-proj -> causal conv -> selective scan ->
gated out-proj.  The full-sequence passes (``mamba_block``,
``mamba_prefill``) run the scan through ``kernels.ops.selective_scan`` (the
``ssm_scan`` kernel on the card, differentiated in training by its backward
kernel ``ssm_scan_bwd``; its plain recurrence on the CPU), where the
reference runs an associative scan (``_scan_chunk``); decode is the O(1)
single-step recurrence on (conv window, SSM state), plain as in the
reference.  ``PerfFlags.mamba_chunk`` has no effect: the kernel walks the
whole sequence with its state in registers, so no chunking bounds its
memory."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import _normal


def _dims(cfg: ArchConfig) -> "tuple[int, int, int, int]":
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or cfg.d_model // 16
    return d_inner, s.d_state, s.d_conv, dt_rank


def init_mamba(cfg: ArchConfig, generator, dtype, device) -> dict:
    d = cfg.d_model
    d_inner, d_state, d_conv, dt_rank = _dims(cfg)
    s = d ** -0.5
    a = torch.arange(1, d_state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": _normal((d, 2 * d_inner), generator, dtype, device, s),
        "conv_w": _normal((d_conv, d_inner), generator, dtype, device, 0.2),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_proj": _normal((d_inner, dt_rank + 2 * d_state), generator, dtype,
                          device, d_inner ** -0.5),
        "dt_proj": _normal((dt_rank, d_inner), generator, dtype, device,
                           dt_rank ** -0.5),
        "dt_bias": torch.zeros((d_inner,), dtype=dtype, device=device),
        "A_log": torch.log(a).repeat(d_inner, 1),
        "D": torch.ones((d_inner,), dtype=torch.float32, device=device),
        "out_proj": _normal((d_inner, d), generator, dtype, device,
                            d_inner ** -0.5),
    }


def _ssm_params(p: dict, cfg: ArchConfig, xc: torch.Tensor):
    """xc: (B, S, d_inner) post-conv activations -> dt, B_t, C_t (float32,
    contiguous)."""
    _, d_state, _, dt_rank = _dims(cfg)
    proj = xc @ p["x_proj"]                                  # (B, S, R+2N)
    dt = F.softplus(proj[..., :dt_rank] @ p["dt_proj"] + p["dt_bias"])
    B_t = proj[..., dt_rank: dt_rank + d_state]
    C_t = proj[..., dt_rank + d_state:]
    return (dt.float().contiguous(), B_t.float().contiguous(),
            C_t.float().contiguous())


def _conv_in(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """In-projection and the causal depthwise conv: (xc, z, the padded raw
    conv input)."""
    S = x.shape[1]
    _, _, d_conv, _ = _dims(cfg)
    xz = x @ p["in_proj"]
    xr, z = torch.chunk(xz, 2, dim=-1)                       # (B, S, d_inner)
    pad = F.pad(xr, (0, 0, d_conv - 1, 0))
    xc = sum(pad[:, i: i + S] * p["conv_w"][i] for i in range(d_conv)) + p["conv_b"]
    return F.silu(xc), z, pad, xr


def _scan(p: dict, cfg: ArchConfig, xc: torch.Tensor):
    """The selective scan plus the ``D`` skip, as the reference's
    ``_scan_chunk`` from a zero state: (y float32, final state)."""
    dt, B_t, C_t = _ssm_params(p, cfg, xc)
    A = -torch.exp(p["A_log"])                               # (d_inner, N)
    xf = xc.float().contiguous()
    y, h_last = ops.selective_scan(dt, B_t, C_t, xf, A)
    return y + p["D"] * xf, h_last


def mamba_block(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence pass. x: (B, S, D)."""
    xc, z, _, _ = _conv_in(p, cfg, x)
    y, _ = _scan(p, cfg, xc)
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"]


def mamba_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor
                  ) -> "tuple[torch.Tensor, dict]":
    """Full-sequence pass that also returns the decode cache after the last
    token: {"conv": last d_conv-1 raw inputs, "state": final SSM state}."""
    _, _, d_conv, _ = _dims(cfg)
    xc, z, pad, xr = _conv_in(p, cfg, x)
    y, h_last = _scan(p, cfg, xc)
    y = y.to(x.dtype) * F.silu(z)
    window = pad[:, -(d_conv - 1):] if d_conv > 1 else xr[:, :0]
    return y @ p["out_proj"], {"conv": window.contiguous(), "state": h_last}


def mamba_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                 ) -> "tuple[torch.Tensor, dict]":
    """Single-token step. cache: {"conv": (B, d_conv-1, d_inner),
    "state": (B, d_inner, N)} -- O(1) in context length.  Returns a new
    cache dict."""
    xz = x[:, 0] @ p["in_proj"]
    xr, z = torch.chunk(xz, 2, dim=-1)                       # (B, d_inner)
    window = torch.cat([cache["conv"], xr[:, None]], dim=1)  # (B, d_conv, di)
    xc = torch.einsum("bcd,cd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc)
    dt, B_t, C_t = _ssm_params(p, cfg, xc[:, None])
    dt, B_t, C_t = dt[:, 0], B_t[:, 0], C_t[:, 0]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)                        # (B, di, N)
    state = cache["state"] * dA + (dt * xc.float())[..., None] * B_t[:, None, :]
    y = torch.einsum("bdn,bn->bd", state, C_t) + p["D"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = (y @ p["out_proj"])[:, None]
    return out, {"conv": window[:, 1:], "state": state}
