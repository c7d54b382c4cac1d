"""Training step, as the reference's ``train/train_step.py``: loss,
gradients (layers recomputed in the backward pass, ``remat``), optional
microbatch gradient accumulation, optional int8 gradient compression with
error feedback, optimizer update.

The gradients are PyTorch's autograd on the card's kernels: the flash
attention and selective scan kernels carry their own backward kernels
(``kernels.flash_attention.FlashAttentionFn``,
``kernels.ssm_scan.SSMScanFn``), where the reference takes ``jax.grad`` of
plain attention and the associative scan.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.tree import leaves, tree_map
from repro_torch.config.base import ArchConfig
from repro_torch.models import model as MDL
from repro_torch.train import grad_compress as GC
from repro_torch.train.optimizer import Optimizer, apply_updates


def _chunk_nll(xb, lb, head):
    """Summed token NLL of one sequence chunk against the head."""
    lg = (xb @ head).float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, lb[..., None])[..., 0]
    return (logz - gold).sum()


def loss_fn(cfg: ArchConfig, params, batch, aux_weight: float = 0.01,
            remat: bool = True):
    """``(loss, (nll, aux))``.  With ``cfg.perf.chunked_loss`` the ``(B, S,
    V)`` logits are never held: chunks of ``loss_chunk`` positions meet the
    head one at a time, each recomputed in the backward pass, and, as in the
    reference, the positions past the last whole chunk are dropped (the
    divisor is ``B * nc * c``)."""
    labels = batch["labels"]
    if cfg.perf.chunked_loss:
        x, aux = MDL.forward_hidden(cfg, params, batch, remat)
        head = MDL.lm_head(cfg, params)
        B, S, _ = x.shape
        c = min(cfg.perf.loss_chunk, S)
        nc = S // c
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(nc):
            sl = slice(i * c, (i + 1) * c)
            if torch.is_grad_enabled():
                acc = acc + checkpoint(_chunk_nll, x[:, sl], labels[:, sl],
                                       head, use_reentrant=False)
            else:
                acc = acc + _chunk_nll(x[:, sl], labels[:, sl], head)
        nll = acc / (B * nc * c)
        return nll + aux_weight * aux, (nll, aux)
    logits, aux = MDL.forward(cfg, params, batch, remat)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll + aux_weight * aux, (nll, aux)


def loss_and_grads(cfg: ArchConfig, params, batch, remat: bool = True):
    """``(loss, nll, aux, grads)``: ``grads`` in the params' layout."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, (nll, aux) = loss_fn(cfg, live, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves(live))
    it = iter(grads)
    return (loss.detach(), nll.detach(), aux.detach(),
            tree_map(lambda _: next(it), live))


def make_train_step(cfg: ArchConfig, optimizer: Optimizer,
                    microbatches: int = 1, compress: bool = False):
    """Returns ``train_step(params, opt_state, batch [, error_fb]) ->
    (params, opt_state, metrics [, error_fb])``.  ``params`` are updated in
    place; ``metrics`` holds 0-d tensors ``loss``, ``nll``, ``moe_aux`` and
    ``grad_norm``.  Microbatch gradients are summed in float32 and divided
    by ``microbatches``; the compression's scales are per reference leaf."""

    def split_micro(batch, i):
        return {k: v[i * (v.shape[0] // microbatches):
                     (i + 1) * (v.shape[0] // microbatches)]
                for k, v in batch.items()}

    def train_step(params, opt_state, batch, error_fb=None):
        if microbatches == 1:
            loss, nll, aux, grads = loss_and_grads(cfg, params, batch)
        else:
            acc, losses, nlls, auxs = None, [], [], []
            for i in range(microbatches):
                loss, nll, aux, g = loss_and_grads(
                    cfg, params, split_micro(batch, i))
                g = tree_map(lambda t: t.float(), g)
                acc = g if acc is None else tree_map(torch.add, acc, g)
                losses.append(loss)
                nlls.append(nll)
                auxs.append(aux)
            grads = tree_map(lambda g: g / microbatches, acc)
            loss, nll, aux = (torch.stack(x).mean()
                              for x in (losses, nlls, auxs))

        if compress:
            if error_fb is None:
                raise ValueError("compress needs the error feedback tree")
            qtree, error_fb = GC.compress_grads(grads, error_fb, cfg)
            grads = GC.decompress_grads(qtree)

        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in leaves(grads)))
        metrics = {"loss": loss, "nll": nll, "moe_aux": aux,
                   "grad_norm": gnorm}
        if compress:
            return params, opt_state, metrics, error_fb
        return params, opt_state, metrics

    return train_step
