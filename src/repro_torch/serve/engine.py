"""Batched serving engine: continuous-batching-lite over the decode step.

Requests join/leave a fixed slot grid (B slots x S_ctx cache); each engine
step decodes one token for every active slot.  Slot admission, greedy
sampling, EOS retirement and per-request accounting live host-side; the
device step is the model's ``decode_step``, run eagerly on ``device``
(``"cuda"`` unless the caller asks for the CPU).  With ``use_prefill`` a
request's prompt is admitted in one full-sequence pass
(``prefill_with_caches``: the flash attention and selective-scan kernels on
the card) that seeds its slot's caches.

The engine exposes the shared serving surface (``repro_torch.serve.base``):
``submit(req, deadline=None)`` -- the deadline budget orders slot admission
(earliest absolute deadline first; FIFO among equals) -- plus ``step()``,
``poll()``, ``drain()``, and ``serve_stats``.  ``run_until_done`` is a
deprecated wrapper over ``drain()``.

Beyond the reference's surface, ``keep_logits=True`` keeps on each request
(``Request.logits``, float32 on the host) the logits row each of its tokens
was drawn from, so two runs can be compared token by token.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.config.base import ArchConfig
from repro_torch.models import model as MDL
from repro_torch.serve.base import ServeStats, warn_run_until_done


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    out: list[int] = field(default_factory=list)
    slot: int = -1
    done: bool = False
    truncated: bool = False          # prompt clamped to the slot cache
    deadline: float = 0.0            # absolute admission priority (t_submit + slo)
    t_submit: float = 0.0
    t_done: float = 0.0
    logits: list = field(default_factory=list)   # with keep_logits only


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, n_slots: int = 4,
                 ctx_len: int = 128, eos: "int | None" = None,
                 use_prefill: bool = False, overflow: str = "reject",
                 default_slo_ms: float = 60_000.0, device="cuda",
                 keep_logits: bool = False):
        if overflow not in ("reject", "truncate"):
            raise ValueError(f"overflow must be 'reject' or 'truncate', got {overflow!r}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.ctx = ctx_len
        self.eos = eos
        self.overflow = overflow
        self.default_slo = default_slo_ms * 1e-3
        self.device = torch.device(device)
        self.keep_logits = keep_logits
        self.serve_stats = ServeStats()
        self._reported = 0               # finished[: _reported] already returned
        # prefill admission: run the whole prompt in one full-seq pass and
        # seed the slot's cache (decoder-only archs)
        self.use_prefill = use_prefill and not cfg.encdec
        self.caches = MDL.init_decode_caches(cfg, n_slots, ctx_len,
                                             torch.float32, self.device)
        self.pos = np.zeros(n_slots, np.int32)           # next write index
        self.active: dict[int, Request] = {}             # slot -> request
        self.queue: list[Request] = []
        self.finished: list[Request] = []

    # -- host scheduler ------------------------------------------------------
    def submit(self, req: Request, deadline: "float | None" = None) -> None:
        """Enqueue one request.  ``deadline`` is the request's SLO budget in
        seconds; slot admission picks the earliest absolute deadline first
        (FIFO among requests sharing the default)."""
        # the slot cache holds positions 0..ctx-1 and the decode loop retires
        # a slot at pos == ctx-1, so a prompt may occupy at most ctx-1 lines
        # (leaving >= 1 decode step); anything longer would run `pos` off the
        # cache grid and scatter out of bounds
        limit = self.ctx - 1
        if len(req.prompt) > limit:
            if self.overflow == "reject":
                raise ValueError(
                    f"prompt of {len(req.prompt)} tokens exceeds the slot cache "
                    f"(ctx_len={self.ctx}, max prompt {limit}); shorten it or "
                    f"construct the engine with overflow='truncate'")
            req.prompt = req.prompt[-limit:]    # keep the newest context
            req.truncated = True
        req.t_submit = time.perf_counter()
        slo = self.default_slo if deadline is None else float(deadline)
        req.deadline = req.t_submit + slo
        self.queue.append(req)

    def _place_slot(self, slot: int, pre_caches: list) -> None:
        """Copy a B=1 prefill cache into one slot of the batched caches."""
        for cache, pre in zip(self.caches, pre_caches):
            for key, c_all in cache.items():
                c_all[slot] = pre[key][0].to(c_all.dtype)

    def _clear_slot(self, slot: int) -> None:
        """Zero a newly admitted slot's caches.  Attention reads only the
        positions a request wrote, but a Mamba state carries everything the
        slot decoded before (an earlier request, or the idle slot's dummy
        tokens); the reference's engine leaves it, so a reused slot's
        token-by-token admission starts from a stale state there."""
        for cache in self.caches:
            for c_all in cache.values():
                c_all[slot].zero_()

    def _emit(self, req: Request, logits_row: torch.Tensor, tok: int) -> None:
        req.out.append(tok)
        if self.keep_logits:
            req.logits.append(logits_row.float().cpu())

    def _admit(self) -> None:
        free = [s for s in range(self.n_slots) if s not in self.active]
        while free and self.queue:
            slot = free.pop(0)
            # earliest-deadline-first; ties keep submission order (stable min)
            nxt = min(range(len(self.queue)),
                      key=lambda i: (self.queue[i].deadline, i))
            req = self.queue.pop(nxt)
            req.slot = slot
            self.active[slot] = req
            self.pos[slot] = 0
            self._clear_slot(slot)
            if self.use_prefill and len(req.prompt) > 1:
                toks = torch.tensor([req.prompt], dtype=torch.int64,
                                    device=self.device)
                logits, pre = MDL.prefill_with_caches(self.cfg, self.params,
                                                      toks, self.ctx)
                self._place_slot(slot, pre)
                self.pos[slot] = len(req.prompt)
                tok = int(torch.argmax(logits[0, -1]))
                self._emit(req, logits[0, -1], tok)
                if (len(req.out) >= req.max_new
                        or (self.eos is not None and tok == self.eos)):
                    self._retire(slot, req)
                    free.insert(0, slot)

    def step(self) -> None:
        """Advance every active slot by one token."""
        self._admit()
        if not self.active:
            return
        self.serve_stats.n_steps += 1
        toks = np.zeros((self.n_slots, 1), np.int64)
        for slot, req in self.active.items():
            consumed = int(self.pos[slot])
            if consumed < len(req.prompt):
                toks[slot, 0] = req.prompt[consumed]
            else:
                toks[slot, 0] = req.out[-1] if req.out else 0
        # per-slot position vector: slots progress independently (idle slots
        # write harmlessly at their own position 0 and are never read)
        logits, self.caches = MDL.decode_step(
            self.cfg, self.params, self.caches,
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(self.pos.astype(np.int64)).to(self.device))
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for slot, req in list(self.active.items()):
            self.pos[slot] += 1
            if self.pos[slot] >= len(req.prompt):
                tok = int(nxt[slot])
                self._emit(req, logits[slot, -1], tok)
                if (len(req.out) >= req.max_new
                        or (self.eos is not None and tok == self.eos)
                        or self.pos[slot] >= self.ctx - 1):
                    self._retire(slot, req)
            elif self.pos[slot] >= self.ctx - 1:
                # prompt longer than the slot cache: retire before `pos` runs
                # off the grid (defense in depth -- ``submit`` clamps/rejects)
                req.truncated = True
                self._retire(slot, req)

    def _retire(self, slot: int, req: Request) -> None:
        req.done = True
        req.t_done = time.perf_counter()
        self.serve_stats.n_served += 1
        self.finished.append(req)
        del self.active[slot]
        # reset the slot's position: `step` passes the whole `pos` vector to
        # decode_step, so a freed slot with a stale pos (up to ctx-1) would
        # scatter its dummy token into freed cache lines instead of holding
        # the stated "idle slots write at their own position 0" invariant
        self.pos[slot] = 0

    def _take_new(self) -> list[Request]:
        """Completions not yet reported by ``poll``/``drain`` -- each request
        is reported exactly once across both."""
        out = self.finished[self._reported:]
        self._reported = len(self.finished)
        return out

    def poll(self) -> list[Request]:
        """Streaming completion: the requests retired since the last
        ``poll()``/``drain()`` report.  Purely a report -- ``step()`` is the
        scheduling quantum; here the caller drives the decode loop."""
        return self._take_new()

    def drain(self, max_steps: int = 10_000) -> list[Request]:
        """Drain queue + active slots; returns only the requests retired by
        *this* call (``self.finished`` keeps the cumulative history, so
        repeated drains never re-report earlier completions).

        Raises ``RuntimeError`` if ``max_steps`` is exhausted with work
        still pending -- a partial drain must not be mistakable for a full
        one (undrained requests stay on ``self.queue``/``self.active``)."""
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step()
            steps += 1
        if self.queue or self.active:
            raise RuntimeError(
                f"drain gave up after {max_steps} steps with "
                f"{len(self.queue)} queued and {len(self.active)} active "
                f"request(s) remaining (finished stay on .finished)")
        return self._take_new()

    def run_until_done(self, max_steps: int = 10_000) -> list[Request]:
        """Deprecated: thin wrapper over ``drain`` (same return value, same
        partial-drain ``RuntimeError`` contract)."""
        warn_run_until_done(type(self).__name__)
        return self.drain(max_steps=max_steps)
