"""Gradient compression with error feedback, as the reference's
``train/grad_compress.py``.

Quantizes gradients to int8 (max-abs scaling per reference leaf) before the
data-parallel all-reduce; the quantization residual is carried to the next
step (error feedback).  The reference's leaves stack a slot's layers over
groups, so one scale covers all of them: ``compress_grads(..., cfg=...)``
takes the max over the port's tensors of each reference leaf
(``models.convert.reference_leaves``) and gives each of them that scale.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.common.tree import get_path, tree_from_paths, tree_map
from repro_torch.models.convert import reference_leaves


@dataclass
class Quantized:
    """One tensor's int8 values and its leaf's float32 scale."""
    q: torch.Tensor
    scale: torch.Tensor


def quantize_int8(xs: list) -> "tuple[list, torch.Tensor]":
    """int8 values of the float32 tensors ``xs`` under one max-abs scale."""
    amax = torch.stack([x.abs().max() for x in xs]).max()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    return [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            for x in xs], scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads, error_fb, cfg):
    """Returns (a tree of ``Quantized`` leaves, new residuals)."""
    qs, es = {}, {}
    for paths in reference_leaves(cfg, grads).values():
        g32 = [get_path(grads, p).float() + get_path(error_fb, p)
               for p in paths]
        q, scale = quantize_int8(g32)
        for path, gi, qi in zip(paths, g32, q):
            qs[path] = Quantized(qi, scale)
            es[path] = gi - dequantize_int8(qi, scale)
    return tree_from_paths(grads, qs), tree_from_paths(grads, es)


def decompress_grads(qtree):
    return tree_map(lambda x: dequantize_int8(x.q, x.scale), qtree)
