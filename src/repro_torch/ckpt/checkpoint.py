"""Fault-tolerant checkpointing, as the reference's ``ckpt/checkpoint.py``.

  * leaf-wise ``.npy`` files under ``step_xxxxxxxx.tmp/``, then a single
    atomic ``rename``: a preempted writer never corrupts the latest
    checkpoint, and a leftover ``.tmp`` directory is never restored;
  * a manifest with a CRC32 per leaf, verified on restore (``IOError`` on a
    mismatch);
  * keep-last-k garbage collection.

A tree is nested dicts, lists and tuples of tensors (``common.tree``); its
leaves are named by their paths.  The reference restores onto a mesh's
shardings; the port restores every leaf onto one ``device`` (``cuda`` unless
the caller asks for the CPU).  bfloat16 tensors, which numpy lacks, are
stored as their int16 bits and restored as bfloat16.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.common.tree import named_leaves, path_name, tree_from_paths


def _to_numpy(t: torch.Tensor) -> "tuple[np.ndarray, str]":
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


@dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, extra: "dict | None" = None) -> str:
        tmp = os.path.join(self.directory, f"step_{step:08d}.tmp")
        final = os.path.join(self.directory, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "leaves": {},
                    "extra": extra or {}}
        for i, (path, leaf) in enumerate(named_leaves(tree)):
            arr, dtype = _to_numpy(leaf)
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][path_name(path)] = {
                "file": fn,
                "crc": zlib.crc32(arr.tobytes()),
                "shape": list(arr.shape),
                "dtype": dtype,
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final)  # atomic publish
        self._gc()
        return final

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> "int | None":
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> "list[int]":
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, like_tree, device="cuda"
                ) -> "tuple[object, dict]":
        """Restore into the structure of ``like_tree``, every leaf on
        ``device``."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for path, _ in named_leaves(like_tree):
            name = path_name(path)
            meta = manifest["leaves"][name]
            arr = np.load(os.path.join(d, meta["file"]))
            if zlib.crc32(arr.tobytes()) != meta["crc"]:
                raise IOError(f"checkpoint corruption in {name}")
            out[path] = _from_numpy(arr, meta["dtype"], device)
        return tree_from_paths(like_tree, out), manifest["extra"]

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
