#!/usr/bin/env python3
"""Check and time the training path's two backward kernels alone on a card.

    python scripts/bwd_kernels.py [--src DIR]

Runs ``chip_smoke.py``'s ``_check_bwd_flash`` and ``_check_bwd_scan`` at the
``train`` phase's shapes on inputs drawn from a seed: each kernel against
autograd through its plain version, two launches bit-identical, queued
device times, the bound, SDPA's backward (flash) and one ``torch.profiler``
pass over a single call (``launch_split``).  Prints the card's name and
power limit, then one JSON line per kernel.  ``--src`` takes the
``repro_torch`` package from another checkout's ``src`` (a parent commit
unpacked under the ignored ``build/``, say), so that two versions can be
compared on one card in one call.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the train phase's shapes: qwen2-0.5b's attention at batch 4 x 512 tokens
# (B, S, H, KV, hd), and falcon-mamba-7b's scan on one microbatch row of 512
# tokens (B, S, D, N)
FLASH_SHAPE = (4, 512, 14, 2, 64)
SCAN_SHAPE = (1, 512, 8192, 16)


def _inputs(shape_kind: str, rng, torch):
    import numpy as np

    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    if shape_kind == "flash":
        B, S, H, KV, hd = FLASH_SHAPE
        return [f(rng.normal(size=(B, S, h, hd))) for h in (H, KV, KV)]
    B, S, D, N = SCAN_SHAPE
    # dt positive (a softplus output), a negative (-exp(A_log))
    return [f(np.abs(rng.normal(0.1, 0.05, (B, S, D)))),
            f(rng.normal(size=(B, S, N))), f(rng.normal(size=(B, S, N))),
            f(rng.normal(size=(B, S, D))),
            f(-np.abs(rng.normal(1.0, 0.3, (D, N))))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is measured")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bwd_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    names = {"flash": ("flash_attention", "flash_attention_bwd"),
             "scan": ("ssm_scan", "ssm_scan_bwd")}
    build.build_kernels(tuple(n for pair in names.values() for n in pair))
    for name in build.BUILD_LOG:
        for line in build.BUILD_LOG[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}", file=sys.stderr)
    smi = C.nvidia_smi()
    print(smi, flush=True)
    rng = np.random.default_rng(C.TRAIN_SEED)
    for kind in names:
        x = _inputs(kind, rng, torch)
        row = (C._check_bwd_flash(*x) if kind == "flash"
               else C._check_bwd_scan(x))
        print(json.dumps({"kernel": names[kind][1], "src": args.src,
                          "nvidia_smi": smi, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
