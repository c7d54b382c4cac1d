"""Carry the reference's params, gradients, optimizer state and decode
caches across to the port, and the port's params back.

The reference stacks the layers of each repeating group (``groups`` leaves
carry a leading group axis, ``slot_<s>`` per position in the pattern) and
keeps irregular leading layers as ``prelude_<i>``; the port keeps one dict
per layer (enc-dec's ``encdec`` subtree is the same in both).
``tree_from_jax`` and the functions built on it take the reference's trees
as numpy arrays (``jax.tree.map(np.asarray, tree)``) and return the port's
layout, so both packages can run the same weights from one seed;
``params_to_jax`` restacks the port's.  ``reference_leaves`` names the
reference leaf each port tensor belongs to: the optimizer and the
gradient compression take statistics over a whole reference leaf (the same
slot across groups, a prelude layer alone), so the port groups its tensors
the same way for them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.tree import get_path, named_leaves, path_name
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


def tree_from_jax(cfg: ArchConfig, tree: dict, device="cuda") -> dict:
    """The port's layout (``init_params``'s) of any reference tree laid out
    like the params (the params, their gradients, AdamW's moments, the
    error feedback), as numpy arrays."""
    out = {k: _tensor(tree[k], device)
           for k in ("embed", "final_norm", "lm_head") if k in tree}
    out["layers"] = _per_layer(cfg, tree, device)
    if "encdec" in tree:
        out["encdec"] = _convert(tree["encdec"], device)
    return out


# the port's params (``init_params``'s layout) from the reference's param
# tree as numpy arrays
params_from_jax = tree_from_jax


def _state_leaves(tree, path=()):
    """(reference leaf name, state dict) of an Adafactor state tree: the
    dicts that hold only ``vr``/``vc`` or ``v`` arrays."""
    if isinstance(tree, dict) and tree and set(tree) <= {"vr", "vc", "v"} \
            and not any(isinstance(v, dict) for v in tree.values()):
        return [(path_name(path), tree)]
    return [x for k, v in tree.items() for x in _state_leaves(v, path + (k,))]


def opt_state_from_jax(cfg: ArchConfig, state: dict, device="cuda") -> dict:
    """The port's optimizer state (``train.optimizer``'s) from the
    reference's, as numpy arrays: AdamW's moments in the params' layout,
    Adafactor's second moments by reference leaf name."""
    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                        device=device)
    if "m" in state:
        return {"m": tree_from_jax(cfg, state["m"], device),
                "v": tree_from_jax(cfg, state["v"], device), "step": step}
    return {"v": {name: _convert(v, device)
                  for name, v in _state_leaves(state["v"])}, "step": step}


def reference_leaves(cfg: ArchConfig, tree) -> "dict[str, list]":
    """``{reference leaf name: [paths of its port tensors]}`` for a tree in
    the params' layout, each list in group order: a tensor of layer ``l``
    belongs to ``groups/slot_<s>/...`` (group ``g``) or ``prelude_<l>/...``
    as the reference stacks it."""
    prelude, _, pat = group_structure(cfg)
    out: dict = {}
    for path, _ in named_leaves(tree):
        name = path_name(path)
        if path[0] == "layers":
            li = path[1]
            if li in prelude:
                head = f"prelude_{li}"
            else:
                head = f"groups/slot_{(li - len(prelude)) % pat}"
            name = path_name((head,) + tuple(path[2:]))
        out.setdefault(name, []).append(path)
    return out


def _numpy(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_jax(cfg: ArchConfig, params: dict) -> dict:
    """The reference's layout of the port's params as numpy arrays: each
    slot's layers stacked over groups, prelude layers alone (bfloat16
    leaves as float32)."""
    out: dict = {}
    for name, paths in reference_leaves(cfg, params).items():
        arrs = [_numpy(get_path(params, p)) for p in paths]
        leaf = np.stack(arrs) if name.startswith("groups/") else arrs[0]
        *heads, last = name.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def caches_from_jax(cfg: ArchConfig, tree: dict, device="cuda") -> list:
    """The port's decode caches (one dict per layer, then enc-dec's
    ``{"enc_out"}``) from the reference's cache tree as numpy arrays."""
    out = _per_layer(cfg, tree, device)
    if "enc_out" in tree:
        out.append({"enc_out": _tensor(tree["enc_out"], device)})
    return out
