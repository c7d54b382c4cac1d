"""Carry the reference's params and decode caches across to the port.

The reference stacks the layers of each repeating group (``groups`` leaves
carry a leading group axis, ``slot_<s>`` per position in the pattern) and
keeps irregular leading layers as ``prelude_<i>``; the port keeps one dict
per layer.  These functions take the reference's trees as numpy arrays
(``jax.tree.map(np.asarray, tree)``) and return the port's layout, so both
packages can run the same weights from one seed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config.base import ArchConfig
from repro_torch.models.model import group_structure


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: via float32
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(tree, device, pick=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, pick) for k, v in tree.items()}
    return _tensor(tree if pick is None else np.asarray(tree)[pick], device)


def _per_layer(cfg: ArchConfig, tree: dict, device) -> list:
    """The reference's ``prelude_<i>`` / stacked ``groups`` entries of
    ``tree`` as one converted dict per layer, in layer order."""
    prelude, _, pat = group_structure(cfg)
    out = []
    for li in range(cfg.n_layers):
        if li in prelude:
            out.append(_convert(tree[f"prelude_{li}"], device))
        else:
            g, s = divmod(li - len(prelude), pat)
            out.append(_convert(tree["groups"][f"slot_{s}"], device, pick=g))
    return out


def params_from_jax(cfg: ArchConfig, tree: dict, device="cuda") -> dict:
    """The port's params (``init_params``'s layout) from the reference's
    param tree as numpy arrays."""
    out = {k: _tensor(tree[k], device)
           for k in ("embed", "final_norm", "lm_head") if k in tree}
    out["layers"] = _per_layer(cfg, tree, device)
    return out


def caches_from_jax(cfg: ArchConfig, tree: dict, device="cuda") -> list:
    """The port's decode caches (one dict per layer) from the reference's
    cache tree as numpy arrays."""
    return _per_layer(cfg, tree, device)
