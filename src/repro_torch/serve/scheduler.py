"""Shape-affine, deadline-driven admission and the background planning stage
of the continuous-batching query engine.

``AdmissionController`` groups queued requests by *plan-sharing affinity*:
each request's ``AffinityKey`` (``repro_torch.core.batch_planner.plan_affinity``)
is matched against open groups tier by tier — exact signature, then
selection key, then pricing key, then DP shape key — and the request joins
the first (deepest) group it shares a tier with.  Grouping is purely a
batch-formation heuristic: ``optimize_batch`` re-derives the exact sharing
inside every batch, so membership can never change a plan, only how much of
the planning pipeline a batch amortizes.

Flushing is deadline-driven, not size-driven: a group becomes ripe when the
*earliest* member's admission deadline (``t_submit + slo``) expires, or
immediately when it accumulates a full batch.  ``next_batch(force=True)``
(the drain path) flushes the most urgent group regardless.

``PlannerWorker`` is the host-side planning stage of the two-stage pipeline:
it pulls ripe batches off the controller, runs ``optimize_batch``, and
pushes planned batches into the engine's bounded handoff queue — so planning
of batch *k+1* overlaps the caller's execution of batch *k*.  A worker that
dies records its exception on the engine, where it is re-raised to the
caller at the next ``submit``/``poll``/``drain``; it is never swallowed.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

from repro_torch.core.batch_planner import AFFINITY_TIERS, AffinityKey


@dataclass
class _Group:
    """One open affinity group: members in arrival order, the earliest
    member's admission deadline, and the tier keys registered for it."""

    gid: int
    members: list = field(default_factory=list)
    flush_at: float = float("inf")
    keys: "list[tuple[int, tuple]]" = field(default_factory=list)


class AdmissionController:
    """Deadline-driven, affinity-grouped admission queue (module docstring).

    Not thread-safe on its own — the engine serializes access under its
    condition lock.
    """

    def __init__(self, max_group: int):
        if max_group < 1:
            raise ValueError(f"max_group must be >= 1, got {max_group}")
        self.max_group = max_group
        self._groups: "dict[int, _Group]" = {}     # insertion == creation order
        # tier index -> key -> gid (first-writer wins; cleaned up on close)
        self._tiers: "list[dict[tuple, int]]" = [{} for _ in AFFINITY_TIERS]
        self._next_gid = 0
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def requests(self) -> list:
        """Every queued request (group creation order, members in arrival
        order within a group)."""
        return [r for g in self._groups.values() for r in g.members]

    def add(self, req, key: AffinityKey, flush_at: float) -> "str | None":
        """Queue ``req``; returns the tier name it matched an open group at
        (``'signature'`` > ``'selection'`` > ``'pricing'`` > ``'shape'``),
        or ``None`` when it founded a new group."""
        matched: "str | None" = None
        group: "_Group | None" = None
        for ti, (name, k) in enumerate(key.tier_keys()):
            gid = self._tiers[ti].get(k)
            if gid is not None:
                group, matched = self._groups[gid], name
                break
        if group is None:
            group = _Group(gid=self._next_gid)
            self._next_gid += 1
            self._groups[group.gid] = group
        group.members.append(req)
        group.flush_at = min(group.flush_at, flush_at)
        # register this member's keys at every still-unclaimed tier, so a
        # later request matching *it* (not the founder) still finds the group
        for ti, (name, k) in enumerate(key.tier_keys()):
            if k not in self._tiers[ti]:
                self._tiers[ti][k] = group.gid
                group.keys.append((ti, k))
        self._n += 1
        return matched

    def next_flush_at(self) -> "float | None":
        if not self._groups:
            return None
        return min(g.flush_at for g in self._groups.values())

    def ripe(self, now: float) -> bool:
        return any(len(g.members) >= self.max_group or g.flush_at <= now
                   for g in self._groups.values())

    def next_batch(self, now: float,
                   force: bool = False) -> "tuple[list, str] | None":
        """Flush the most urgent group: full groups first (creation order),
        then the earliest expired deadline; under ``force``, the earliest
        deadline regardless.  Returns ``(members, reason)`` with ``reason``
        in ``('full', 'deadline', 'forced')``, or ``None`` when nothing is
        ripe."""
        chosen: "_Group | None" = None
        reason = ""
        for g in self._groups.values():
            if len(g.members) >= self.max_group:
                chosen, reason = g, "full"
                break
        if chosen is None:
            expired = [g for g in self._groups.values() if g.flush_at <= now]
            if expired:
                chosen = min(expired, key=lambda g: g.flush_at)
                reason = "deadline"
            elif force and self._groups:
                chosen = min(self._groups.values(), key=lambda g: g.flush_at)
                reason = "forced"
        if chosen is None:
            return None
        batch = chosen.members[:self.max_group]
        del chosen.members[:len(batch)]
        self._n -= len(batch)
        if chosen.members:
            # overflow remainder keeps the group (and its registrations);
            # its urgency re-derives from the members left behind
            chosen.flush_at = min(r.deadline for r in chosen.members)
        else:
            for ti, k in chosen.keys:
                if self._tiers[ti].get(k) == chosen.gid:
                    del self._tiers[ti][k]
            del self._groups[chosen.gid]
        return batch, reason


class ArrivalQueue:
    """Legacy arrival-order admission with the same interface: one FIFO, a
    batch is the first ``max_group`` requests, ripe when full or when the
    head-of-line deadline expires.  This is the drain-loop policy the
    affinity controller replaces; kept as the benchmark baseline
    (``admission='arrival'``)."""

    def __init__(self, max_group: int):
        self.max_group = max_group
        self._fifo: list = []

    def __len__(self) -> int:
        return len(self._fifo)

    def requests(self) -> list:
        return list(self._fifo)

    def add(self, req, key, flush_at: float) -> None:
        self._fifo.append(req)
        return None

    def next_flush_at(self) -> "float | None":
        return self._fifo[0].deadline if self._fifo else None

    def ripe(self, now: float) -> bool:
        return (len(self._fifo) >= self.max_group
                or (bool(self._fifo) and self._fifo[0].deadline <= now))

    def next_batch(self, now: float,
                   force: bool = False) -> "tuple[list, str] | None":
        if not self._fifo:
            return None
        if len(self._fifo) >= self.max_group:
            reason = "full"
        elif self._fifo[0].deadline <= now:
            reason = "deadline"
        elif force:
            reason = "forced"
        else:
            return None
        batch = self._fifo[:self.max_group]
        del self._fifo[:len(batch)]
        return batch, reason


class PlannerWorker(threading.Thread):
    """Background planning stage (module docstring): admission -> plan ->
    bounded handoff.  One worker per engine; the optimizer is touched by
    this thread only, so the plan cache needs no locking."""

    # worker liveness poll while waiting on a flush deadline or a full
    # handoff queue; real-time bound even under a simulated engine clock
    _WAIT_S = 0.02

    def __init__(self, engine):
        super().__init__(name="query-serve-planner", daemon=True)
        self.engine = engine

    def run(self) -> None:
        eng = self.engine
        try:
            while True:
                with eng._cond:
                    got = None
                    while got is None:
                        if eng._stopping and not len(eng._admission):
                            return
                        now = eng._clock()
                        force = eng._force_flush or eng._stopping
                        got = eng._admission.next_batch(now, force=force)
                        if got is None:
                            eng._cond.wait(self._WAIT_S)
                    batch, reason = got
                    eng._note_flush(reason)
                    eng._cond.notify_all()     # submit() may unblock now
                eng._plan_batch(batch)         # outside the lock: the overlap
                with eng._cond:
                    while (len(eng._handoff) >= eng.handoff_depth
                           and not eng._stopping):
                        eng._cond.wait(self._WAIT_S)
                    eng._handoff.append(batch)
                    eng._cond.notify_all()
        except BaseException as e:  # repro: ignore[RPR102] -- worker death
            # must reach the caller, not a thread traceback: the exception is
            # recorded here and re-raised by the engine on the next submit()/
            # poll()/drain() (tested: test_serve_scheduler.py worker-death)
            with eng._cond:
                eng._worker_error = e
                eng._cond.notify_all()
