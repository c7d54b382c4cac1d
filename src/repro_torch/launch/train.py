"""Training launcher, as the reference's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --steps 100 --batch 8 --seq 256 --ckpt-dir ckpt \\
        --ckpt-every 50 --device cpu

Wires together: config registry (+ reduced mode for the CPU), params drawn
on ``--device`` (``cuda`` unless the caller asks for the CPU) from a seeded
generator, the resumable data loader, the train step (microbatching,
optional int8 gradient compression with error feedback), atomic
checkpointing with restart, a heartbeat, and a checkpoint on SIGTERM.  The
reference's mesh and shardings have no counterpart here: the port trains
on one device.  As the reference's, the launcher feeds the VLM zero patch
embeddings and the encoder-decoder zero frames.

``main(argv)`` parses the reference's flags (plus ``--device``) and calls
``train(cfg, args)``, which a caller may also call with a configuration of
its own (a depth cut of a published one, say).
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.config.base import ArchConfig, PerfFlags, reduced_config
from repro_torch.configs import get_arch
from repro_torch.data.loader import TokenLoader
from repro_torch.ft.resilience import Heartbeat
from repro_torch.models import model as MDL
from repro_torch.train.grad_compress import init_error_feedback
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunked-loss", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def config(args: argparse.Namespace) -> ArchConfig:
    cfg = get_arch(args.arch)
    if args.reduced:
        over = {}
        if args.d_model:
            over["d_model"] = args.d_model
            over["head_dim"] = max(8, args.d_model // 8)
            over["d_ff"] = args.d_model * 4
        if args.layers:
            over["n_layers"] = args.layers
        cfg = reduced_config(cfg, **over)
    if args.chunked_loss:
        cfg = dataclasses.replace(cfg, perf=PerfFlags(chunked_loss=True,
                                                      loss_chunk=64))
    return cfg


def main(argv=None) -> dict:
    args = parse_args(argv)
    return train(config(args), args)


def param_generator(seed: int, device) -> torch.Generator:
    """The seeded generator the params are drawn from, on ``device``."""
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def train(cfg: ArchConfig, args: argparse.Namespace) -> dict:
    """Train ``cfg`` as ``args`` say; returns ``{"first", "last", "losses",
    "step_s"}``: the mean NLL of the first and last five steps (or the first
    step's), every step's NLL, and every step's host seconds (the step's
    loss read back included)."""
    dev = args.device
    n_params_est = cfg.param_count()
    print(f"arch={cfg.name} ~{n_params_est / 1e6:.1f}M params "
          f"(family={cfg.family})", flush=True)

    opt = make_optimizer(args.optimizer, cfg=cfg, lr=args.lr)
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches,
                              compress=args.compress_grads)

    loader = TokenLoader(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    hb = Heartbeat(timeout_s=60.0)

    params = MDL.init_params(cfg, param_generator(args.seed, dev), torch.float32,
                             dev)
    opt_state = opt.init(params)
    error_fb = init_error_feedback(params) if args.compress_grads else None
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        s = mgr.latest_step()
        (params, opt_state), extra = mgr.restore(s, (params, opt_state),
                                                 device=dev)
        start_step = extra.get("step", s)
        print(f"restored checkpoint at step {start_step}", flush=True)

    stop = {"now": False}
    signal.signal(signal.SIGTERM, lambda *_: stop.update(now=True))

    losses, step_s = [], []
    t_start = time.time()
    tokens_per_step = args.batch * args.seq
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).long().to(dev)
                 for k, v in loader.batch_at(step).items()}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (args.batch, cfg.vlm_prefix, cfg.d_model), device=dev)
        if cfg.encdec:
            batch["frames"] = torch.zeros(
                (args.batch, cfg.enc_seq, cfg.d_model), device=dev)
        if args.compress_grads:
            params, opt_state, metrics, error_fb = step_fn(params, opt_state,
                                                           batch, error_fb)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        hb.beat("worker0")
        losses.append(float(metrics["nll"]))
        step_s.append(time.perf_counter() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t_start
            tps = tokens_per_step * (step - start_step + 1) / max(dt, 1e-9)
            print(f"step {step:5d} nll={losses[-1]:.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f} tok/s={tps:,.0f}",
                  flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, (params, opt_state), extra={"step": step + 1})
        if stop["now"]:
            if mgr is not None:
                mgr.save(step + 1, (params, opt_state), extra={"step": step + 1})
            print("preempted: checkpoint saved, exiting", flush=True)
            break

    first = float(np.mean(losses[:5])) if len(losses) >= 5 else losses[0]
    last = float(np.mean(losses[-5:]))
    print(f"nll: first5={first:.4f} last5={last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})", flush=True)
    return {"first": first, "last": last, "losses": losses, "step_s": step_s}


if __name__ == "__main__":
    main()
