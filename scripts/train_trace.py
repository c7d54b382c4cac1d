#!/usr/bin/env python3
"""Trace cell (a) of ``chip_smoke.py``'s ``train`` phase on a card.

    python scripts/train_trace.py [--steps N]

Builds ``qwen2-0.5b`` at full depth on the card from the phase's seed
(AdamW, lr 3e-4, batch 4 x 512 tokens, float32, TF32 off, remat as the
launcher trains), runs two warm steps, then traces ``N`` steps (default 2)
with ``torch.profiler`` in one session: the steps' host time, the device
time of every kernel and copy, the device's busy share, the kernels with
the most device time, and the flash-attention kernels' launches and share.
Prints the card's name and power limit, then one JSON line.  Exits 2
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("train_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as C
    from repro_torch.data.loader import TokenLoader
    from repro_torch.launch import train as T
    from repro_torch.models import model as MDL
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, arch, layers, flags = C.TRAIN_CELLS[0]
    targs = T.parse_args(C._train_argv(arch, flags, ""))
    cfg = C._train_cfg(arch, layers)
    opt = make_optimizer(targs.optimizer, cfg=cfg, lr=targs.lr)
    step_fn = make_train_step(cfg, opt, microbatches=targs.microbatches,
                              compress=targs.compress_grads)
    params = MDL.init_params(cfg, T.param_generator(targs.seed, C.DEVICE),
                             torch.float32, C.DEVICE)
    opt_state = opt.init(params)
    loader = TokenLoader(vocab=cfg.vocab, batch=targs.batch, seq=targs.seq,
                         seed=targs.seed)

    def step(i):
        nonlocal params, opt_state
        batch = {k: torch.from_numpy(v).long().to(C.DEVICE)
                 for k, v in loader.batch_at(i).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        return float(metrics["nll"])

    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    # a first session on one product, as chip_smoke's launch splits do
    x = torch.ones((256, 256), device=C.DEVICE)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (x @ x).sum().item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, 2 + args.steps):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict = {}
    launches: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = C._kernel_name(e.name)[:60]
            kernels[name] = kernels.get(name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
            launches[name] = launches.get(name, 0) + 1
    device_ms = sum(kernels.values())
    flash = {k: {"ms": v, "launches": launches[k]} for k, v in kernels.items()
             if k in ("flash_f32", "dq_kernel", "dkv_kernel", "group_sum")}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    print(C.nvidia_smi(), flush=True)
    print(json.dumps({
        "cell": cell, "model": arch, "layers": cfg.n_layers,
        "steps": args.steps, "wall_ms_per_step": wall_ms / args.steps,
        "device_ms_per_step": device_ms / args.steps,
        "busy_share": device_ms / wall_ms,
        "flash_kernels": flash,
        "flash_share_of_device": sum(v["ms"] for v in flash.values())
        / device_ms,
        "top_kernels_ms": [[k, v, launches[k]] for k, v in top]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
