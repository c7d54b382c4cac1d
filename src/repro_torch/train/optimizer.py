"""Optimizers (no external deps): AdamW and factored Adafactor, as the
reference's ``train/optimizer.py``.

The reference's leaves are stacked over groups (``groups/slot_<s>/...``
carry a leading group axis); the port keeps one tensor per layer.  AdamW is
elementwise, so its state mirrors the params tensor by tensor.  Adafactor is
not: it factors a stacked 1-D parameter ``(G, width)`` (its column moment is
a mean over the layers) and clips each update by its RMS over the whole
stacked leaf.  So ``adafactor(cfg=...)`` groups the port's tensors into the
reference's leaves (``models.convert.reference_leaves``), stacks each group
for the update, and keeps its second moments by reference leaf name, in the
reference's shapes.

``apply_updates`` adds the updates to the params in place (the reference
returns new arrays; in place saves a copy of the params on the card) and
returns them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.common.tree import (get_path, leaves, named_leaves,
                                     tree_from_paths, tree_map)
from repro_torch.models.convert import reference_leaves


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable     # (grads, state, params) -> (updates, state)
    name: str = ""


def _step(state) -> "tuple[torch.Tensor, torch.Tensor]":
    step = state["step"] + 1
    return step, step.float()


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          state_dtype=torch.float32) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves(params)[0].device)}

    def update(grads, state, params):
        step, t = _step(state)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        ups, ms, vs = {}, {}, {}
        for path, g in named_leaves(grads):
            m, v, p = (get_path(tr, path)
                       for tr in (state["m"], state["v"], params))
            g32 = g.float()
            m2 = b1 * m.float() + (1 - b1) * g32
            v2 = b2 * v.float() + (1 - b2) * g32 * g32
            mhat = m2 / c1
            vhat = v2 / c2
            u = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            ups[path] = (-lr * u).to(p.dtype)
            ms[path], vs[path] = m2.to(state_dtype), v2.to(state_dtype)
        return tree_from_paths(grads, ups), {
            "m": tree_from_paths(grads, ms), "v": tree_from_paths(grads, vs),
            "step": step}

    return Optimizer(init, update, "adamw")


def adafactor(cfg, lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment Adafactor (no momentum), over the reference's
    leaves of ``cfg`` (see the module docstring)."""

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def _stack(tree, name, paths):
        ts = [get_path(tree, p) for p in paths]
        return torch.stack(ts) if name.startswith("groups/") else ts[0]

    def init(params):
        v = {}
        for name, paths in reference_leaves(cfg, params).items():
            p = _stack(params, name, paths)
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                v[name] = {"vr": torch.zeros(p.shape[:-1], **f32),
                           "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                             **f32)}
            else:
                v[name] = {"v": torch.zeros(p.shape, **f32)}
        return {"v": v, "step": torch.zeros((), dtype=torch.int32,
                                            device=p.device)}

    def update(grads, state, params):
        step, t = _step(state)
        rho = 1.0 - t ** (-decay)
        ups, nv = {}, {}
        for name, paths in reference_leaves(cfg, grads).items():
            g32 = _stack(grads, name, paths).float()
            v = state["v"][name]
            g2 = g32 * g32 + eps
            if _factored(g32.shape):
                vr = rho * v["vr"] + (1 - rho) * g2.mean(dim=-1)
                vc = rho * v["vc"] + (1 - rho) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]) / torch.clamp_min(
                    vr.mean(dim=-1)[..., None, None], eps)
                u = g32 * torch.rsqrt(denom + eps)
                nv[name] = {"vr": vr, "vc": vc}
            else:
                nv[name] = {"v": rho * v["v"] + (1 - rho) * g2}
                u = g32 * torch.rsqrt(nv[name]["v"] + eps)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            u = -lr * u
            for i, path in enumerate(paths):
                ui = u[i] if name.startswith("groups/") else u
                ups[path] = ui.to(get_path(params, path).dtype)
        return tree_from_paths(grads, ups), {"v": nv, "step": step}

    return Optimizer(init, update, "adafactor")


def make_optimizer(name: str, cfg, **kw) -> Optimizer:
    """``adamw`` or ``adafactor``; ``cfg`` (Adafactor's) names the
    reference's leaves."""
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(cfg, **kw)
    raise ValueError(name)


@torch.no_grad()
def apply_updates(params, updates):
    """``params + updates``, in place; returns ``params``."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params
