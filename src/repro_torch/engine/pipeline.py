"""Adaptive operator-pipeline execution of physical plans (a copy of the
reference package's ``engine/pipeline.py``, host numpy).

``LocalEngine``'s original evaluator was one recursive ``_execute`` over the
plan tree: every subquery dispatched all of its sources in a fixed order, a
dead endpoint threw away the whole query, and nothing downstream learned how
wrong the optimizer's cardinalities were.  This module lowers a
``PhysicalPlan`` into an explicit graph of operators instead
(ADQUEX-style tuple routing, arXiv 1505.04880; ANAPSID-style symmetric-hash
joins):

* ``SubqueryOp`` + per-endpoint scan tasks, each routed through a
  ``SourceChannel`` that memoizes completed scans — a resumed or salvaged
  execution never re-ships tuples an endpoint already produced;
* ``SymHashJoinOp`` builds both sides incrementally: every arriving chunk is
  probed against the chunks already held for the other side, so match pairs
  exist long before either input is complete (the scheduler's scan order is
  free to change without changing the answer);
* a routing layer (``drop_source`` / ``_alternates``) that, when an endpoint
  dies mid-query, drops only that endpoint's scans — or redirects a star
  subquery to an alternate relevant source retained by the
  ``SourceSelection`` — and re-derives the dataflow from the salvaged parts.

Bit-identity contract: on a healthy federation ``PipelineExecution.run()``
returns exactly the rows (same order), NTT, request and intermediate-row
counts as ``LocalEngine.execute_recursive``.  The legacy join emits match
pairs sorted by ``(left_row, right_row)`` — its right indices come from a
stable argsort of the packed keys, so equal-key runs keep ascending original
order — and the symmetric-hash join reproduces that canonical order by
sorting its accumulated pairs at finalize, whatever order chunks arrived in.
See docs/execution.md.

Every scan and operator also records observed vs. estimated cardinality on
``ExecutionResult.card_log`` — the dirty-source signal consumed by
``repro_torch.stats.feedback`` to trigger incremental ``refresh_source``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.planner import (
    FilterPlanNode,
    JoinPlanNode,
    LeftJoinPlanNode,
    PhysicalPlan,
    PlanNode,
    SubqueryNode,
    UnionPlanNode,
)
from repro_torch.engine.local import (
    ExecutionMetrics,
    ExecutionResult,
    Relation,
    _concat,
    _dedup,
    _empty,
    _nrows,
    _outer_union,
    filter_mask,
    join_indices,
    join_rels,
)
from repro_torch.query.algebra import TriplePattern, Var
from repro_torch.rdf.dataset import Federation

UNDEF = int(np.int32(-1))


class VirtualClock:
    """Deterministic simulated clock for fault-injection tests and the
    adaptive benchmark: calling it reads the current virtual time,
    ``advance`` moves it forward (``SourceChannel`` charges each physical
    scan its endpoint's ``latency_s`` here; ``RetryPolicy(sleep=clock.
    advance)`` retries without wall-clock sleeps)."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@dataclass(frozen=True)
class CardObservation:
    """One observed-vs-estimated cardinality sample.

    ``kind`` is ``"scan"`` (unbound single-star dispatch: the one form whose
    estimate and observation measure the same quantity, so the feedback hook
    scores only these by default), ``"scan_merged"`` / ``"scan_bound"`` for
    merged-exclusive-group and bind-join dispatches, or an operator kind
    (``"subquery"``/``"join"``/``"leftjoin"``/``"union"``/``"filter"``).
    ``source`` is the endpoint name for scan kinds, ``None`` for operators.
    """

    kind: str
    source: "str | None"
    star: "int | None"
    est: "float | None"
    obs: int


class SourceChannel:
    """The engine's connection to one endpoint.

    Owns fault injection (duck-typed against the reference package's
    ``ft.failover.FlakySource``: ``check()`` at dispatch, ``note_tuples()``
    per physical scan, ``latency_s`` for the simulated clock), the physical
    transfer counters the salvage tests and benchmark assert on, and a memo
    of completed scans keyed by the scan constants — the reason a salvaged
    or resumed execution never re-ships tuples this endpoint already
    produced.
    """

    def __init__(self, src, pos: int, honor_faults: bool, clock=None):
        self.src = src
        self.pos = pos
        self.honor_faults = honor_faults
        self.clock = clock
        self.dropped = False            # excluded mid-query by drop_source
        self.physical_scans = 0         # endpoint scans actually executed
        self.physical_tuples = 0        # tuples shipped endpoint -> engine
        self.cache_hits = 0             # scans answered from the memo
        self._scans: "dict[tuple, np.ndarray]" = {}

    @property
    def name(self) -> str:
        return self.src.name

    def latency_estimate(self) -> float:
        return float(getattr(self.src, "latency_s", 0.0) or 0.0)

    def connect(self) -> None:
        """Dispatch-time health check (raises ``EndpointDown`` on a dead or
        transiently failing ``FlakySource``)."""
        if self.honor_faults:
            check = getattr(self.src, "check", None)
            if check is not None:
                check()

    def scan(self, s, p, o) -> np.ndarray:
        key = (s, p, o)
        hit = self._scans.get(key)
        if hit is not None:
            self.cache_hits += 1
            return hit
        rows = self.src.table.scan(s, p, o)
        if self.honor_faults:
            note = getattr(self.src, "note_tuples", None)
            if note is not None:
                note(len(rows))         # may raise: mid-scan endpoint death
        lat = self.latency_estimate()
        if lat and self.clock is not None:
            adv = getattr(self.clock, "advance", None)
            if adv is not None:
                adv(lat)
        self.physical_scans += 1
        self.physical_tuples += len(rows)
        self._scans[key] = rows
        return rows


# --------------------------------------------------------------------------
# Operators
# --------------------------------------------------------------------------

class Op:
    """One pipeline operator.  Children push chunks via ``accept``; ``emit``
    finalizes (once per run) and returns the operator's full relation."""

    kind = "op"

    def __init__(self, exec_: "PipelineExecution", node: PlanNode,
                 children: "list[Op]"):
        self.exec = exec_
        self.node = node
        self.children = children
        self.parent: "Op | None" = None
        self.port = 0
        for i, c in enumerate(children):
            c.parent, c.port = self, i
        self.out: "Relation | None" = None

    def reset(self) -> None:
        self.out = None

    def accept(self, port: int, slot: int, rel: Relation) -> None:
        """Push one chunk of input ``port`` (default: buffering operators
        ignore chunks and pull full inputs at finalize)."""

    def finalize(self) -> Relation:
        raise NotImplementedError

    def emit(self) -> Relation:
        if self.out is None:
            self.out = self.finalize()
            est = getattr(self.node, "est_cardinality", None)
            self.exec._log(self.kind, None, None, est, _nrows(self.out))
        return self.out

    # chunked-output protocol (consumed by pair-accumulating parents)
    def chunk_sizes(self) -> "list[int]":
        return [_nrows(self.emit())]


class SubqueryOp(Op):
    """One (merged) star subquery: a scan task per live endpoint slot, the
    output the slot-ordered union of the shipped parts.  ``slots`` is the
    routing state — ``drop_source`` removes a dead endpoint's slot (and may
    append an alternate relevant source); ``shipped`` memoizes completed
    unbound dispatches across runs, so salvage re-derives the dataflow
    without re-executing them."""

    kind = "subquery"

    def __init__(self, exec_, node: SubqueryNode, bound: bool = False):
        super().__init__(exec_, node, [])
        self.bound = bound
        self.slots: "list[int]" = list(node.sources)
        ests = getattr(node, "est_source_cards", None) or []
        self.est_by_pos = dict(zip(node.sources, ests))
        self.shipped: "dict[int, Relation]" = {}   # unbound parts, cross-run
        self.parts: "dict[int, Relation]" = {}     # committed this run
        self.bindings: "Relation | None" = None    # set by BindJoinOp

    def reset(self) -> None:
        super().reset()
        self.parts = {}
        self.bindings = None

    def full_vars(self) -> "set[str]":
        out: set[str] = set()
        for tp in self.node.patterns:
            out |= set(tp.variables())
        if self.bindings:
            out |= set(self.bindings)
        return out

    def scan_kind(self) -> str:
        if self.bound:
            return "scan_bound"
        return "scan" if len(self.node.stars) == 1 else "scan_merged"

    def slot_index(self, pos: int) -> int:
        return self.slots.index(pos)

    def finalize(self) -> Relation:
        parts = [self.parts[p] for p in self.slots]
        out = _concat(parts)
        if not out:
            return _empty(sorted(self.full_vars()))
        return out

    def chunk_sizes(self) -> "list[int]":
        return [_nrows(self.parts[p]) for p in self.slots]


class SymHashJoinOp(Op):
    """Non-blocking symmetric-hash join: chunks from either input are probed
    against the chunks already held for the other input the moment they
    arrive, accumulating ``(left_chunk, left_row, right_chunk, right_row)``
    match quadruples.  Finalize assigns canonical row offsets (chunk order =
    the child's slot order) and sorts the pairs by global ``(li, ri)`` —
    exactly the legacy sort-merge emission order — so the answer is invariant
    to the scheduler's arrival order."""

    kind = "join"

    def __init__(self, exec_, node, children):
        super().__init__(exec_, node, children)
        self._chunks: "tuple[dict[int, Relation], dict[int, Relation]]" = ({}, {})
        self._pairs: "list[tuple[int, np.ndarray, int, np.ndarray]]" = []

    def reset(self) -> None:
        super().reset()
        self._chunks = ({}, {})
        self._pairs = []

    def accept(self, port: int, slot: int, rel: Relation) -> None:
        other = self._chunks[1 - port]
        found = 0
        for oslot, orel in other.items():
            if port == 0:
                li, ri = join_indices(rel, orel)
                quad = (slot, li, oslot, ri)
            else:
                li, ri = join_indices(orel, rel)
                quad = (oslot, li, slot, ri)
            if len(li):
                self._pairs.append(quad)
                found += len(li)
        self._chunks[port][slot] = rel
        if found:
            self.exec._note_progress(found)

    def _ingest_pending(self) -> None:
        """Pull the single output chunk of any child that does not stream
        (joins, filters, unions below this one push nothing during the scan
        phase)."""
        for port, child in enumerate(self.children):
            if not isinstance(child, SubqueryOp):
                if 0 not in self._chunks[port]:
                    self.accept(port, 0, child.emit())

    def _offsets(self, port: int) -> np.ndarray:
        sizes = self.children[port].chunk_sizes()
        return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    def _canonical_pairs(self) -> "tuple[np.ndarray, np.ndarray]":
        if not self._pairs:
            z = np.zeros(0, np.int64)
            return z, z
        loff, roff = self._offsets(0), self._offsets(1)
        li = np.concatenate([loff[ls] + a for ls, a, _, _ in self._pairs])
        ri = np.concatenate([roff[rs] + b for _, _, rs, b in self._pairs])
        order = np.lexsort((ri, li))
        return li[order], ri[order]

    def finalize(self) -> Relation:
        lrel = self.children[0].emit()
        rrel = self.children[1].emit()
        self.exec.metrics.intermediate_rows += _nrows(lrel) + _nrows(rrel)
        if not lrel:            # legacy join identities ({} == no columns)
            return rrel
        if not rrel:
            return lrel
        self._ingest_pending()
        li, ri = self._canonical_pairs()
        out: Relation = {v: lrel[v][li] for v in lrel}
        for v in rrel:
            if v not in out:
                out[v] = rrel[v][ri]
        return out


class LeftJoinOp(SymHashJoinOp):
    """OPTIONAL on the pair-accumulating machinery: the canonical inner-join
    pairs plus every unmatched left row (ascending), right-only columns
    padded with UNDEF — the legacy ``_left_join`` emission order."""

    kind = "leftjoin"

    def finalize(self) -> Relation:
        lrel = self.children[0].emit()
        rrel = self.children[1].emit()
        self.exec.metrics.intermediate_rows += _nrows(lrel) + _nrows(rrel)
        if not lrel:
            return rrel
        if not rrel:
            return lrel
        self._ingest_pending()
        li, ri = self._canonical_pairs()
        matched = np.zeros(_nrows(lrel), bool)
        matched[li] = True
        un = np.nonzero(~matched)[0]
        out: Relation = {}
        for v in lrel:
            out[v] = np.concatenate([lrel[v][li], lrel[v][un]])
        for v in rrel:
            if v not in out:
                out[v] = np.concatenate(
                    [rrel[v][ri], np.full(len(un), UNDEF, rrel[v].dtype)])
        return out


class BindJoinOp(Op):
    """Bind join: the right star subquery is dispatched *bound* to the
    finalized left relation (one scan per distinct relevant binding row at
    each endpoint), and its union — each part already joined with the
    bindings endpoint-side — is the join output, as in the legacy
    ``_eval_subquery(node.right, bindings=left)``."""

    kind = "join"

    def finalize(self) -> Relation:
        left = self.children[0].emit()
        self.exec.metrics.intermediate_rows += _nrows(left)
        rop = self.children[1]
        rop.bindings = left
        self.exec._run_bound_tasks(rop)
        out = rop.emit()
        self.exec.metrics.intermediate_rows += _nrows(out)
        return out


class UnionOp(Op):
    kind = "union"

    def finalize(self) -> Relation:
        parts = [c.emit() for c in self.children]
        for p in parts:
            self.exec.metrics.intermediate_rows += _nrows(p)
        return _outer_union(parts)


class FilterOp(Op):
    kind = "filter"

    def finalize(self) -> Relation:
        rel = self.children[0].emit()
        self.exec.metrics.intermediate_rows += _nrows(rel)
        m = filter_mask(self.node.expr, rel)
        return {v: c[m] for v, c in rel.items()}


@dataclass
class ScanTask:
    op: SubqueryOp
    pos: int                    # endpoint position in the compile-time fed


# --------------------------------------------------------------------------
# The execution
# --------------------------------------------------------------------------

class PipelineExecution:
    """One plan lowered onto one federation, resumable and salvageable.

    ``run()`` is re-entrant: every call resets the operator states, replays
    the parts already shipped (channel memos make that free of endpoint
    traffic), then executes the remaining scan tasks in the routing policy's
    order.  Logical metrics (NTT / requests / intermediate rows — what the
    paper counts) are recomputed per run and match the legacy evaluator on
    the surviving plan; physical transfer lives on the ``SourceChannel``s
    and only ever grows by the genuinely new work.

    ``policy``: ``"static"`` dispatches scans in plan order (the legacy
    order); ``"adaptive"`` dispatches fast endpoints first (by
    ``latency_s``-informed estimate) so joins see chunks early and degraded
    endpoints cannot stall the pipeline head; ``"random"`` shuffles (the
    schedule-invariance tests).  The answer is policy-invariant by the
    canonical-pair contract.
    """

    def __init__(self, plan: PhysicalPlan, fed: Federation,
                 honor_faults: bool = False, policy: str = "static",
                 clock=None, rng=None):
        if policy not in ("static", "adaptive", "random"):
            raise ValueError(f"unknown scan policy {policy!r}")
        self.plan = plan
        self.fed = fed
        self.honor_faults = honor_faults
        self.policy = policy
        self.clock = clock
        self.rng = rng or np.random.default_rng(0)
        self.metrics = ExecutionMetrics()
        self.card_log: "list[CardObservation]" = []
        self.channels: "dict[int, SourceChannel]" = {}
        self.ops: "list[Op]" = []
        self.subquery_ops: "list[SubqueryOp]" = []
        self.root_op = self._build(plan.root)
        self.salvages = 0
        self.rerouted: "list[tuple[str, str]]" = []
        self.first_answer_t: "float | None" = None

    # -- graph construction --------------------------------------------------
    def _build(self, node: PlanNode) -> Op:
        if isinstance(node, SubqueryNode):
            op = SubqueryOp(self, node)
        elif isinstance(node, LeftJoinPlanNode):
            op = LeftJoinOp(self, node, [self._build(node.left),
                                         self._build(node.right)])
        elif isinstance(node, UnionPlanNode):
            op = UnionOp(self, node, [self._build(c) for c in node.children])
        elif isinstance(node, FilterPlanNode):
            op = FilterOp(self, node, [self._build(node.child)])
        else:
            if not isinstance(node, JoinPlanNode):
                raise TypeError(f"unknown plan node {type(node).__name__}")
            if node.strategy == "bind" and isinstance(node.right, SubqueryNode):
                right = SubqueryOp(self, node.right, bound=True)
                self.ops.append(right)
                self.subquery_ops.append(right)
                op = BindJoinOp(self, node, [self._build(node.left), right])
            else:
                op = SymHashJoinOp(self, node, [self._build(node.left),
                                                self._build(node.right)])
        self.ops.append(op)
        if isinstance(op, SubqueryOp):
            self.subquery_ops.append(op)
        return op

    def _channel(self, pos: int) -> SourceChannel:
        ch = self.channels.get(pos)
        if ch is None:
            ch = SourceChannel(self.fed.sources[pos], pos,
                               self.honor_faults, self.clock)
            self.channels[pos] = ch
        return ch

    # -- bookkeeping ---------------------------------------------------------
    def _log(self, kind, source, star, est, obs) -> None:
        self.card_log.append(CardObservation(kind=kind, source=source,
                                             star=star, est=est, obs=obs))

    def _note_progress(self, n_matches: int) -> None:
        if n_matches and self.first_answer_t is None:
            self.first_answer_t = (self.clock() if self.clock is not None
                                   else time.perf_counter())

    def _now(self) -> float:
        return self.clock() if self.clock is not None else time.perf_counter()

    # -- per-endpoint evaluation (mirrors LocalEngine._eval_pattern) ---------
    def _eval_pattern(self, chan: SourceChannel, tp: TriplePattern,
                      bindings: "Relation | None") -> Relation:
        s, p, o = tp.constants()
        table = chan.src.table
        out_vars = [t.name for t in (tp.s, tp.p, tp.o) if isinstance(t, Var)]
        if bindings is None or not any(
            isinstance(t, Var) and t.name in bindings for t in (tp.s, tp.p, tp.o)
        ):
            rows = chan.scan(s, p, o)
            rel: Relation = {}
            if isinstance(tp.s, Var):
                rel[tp.s.name] = table.s[rows]
            if isinstance(tp.p, Var):
                rel[tp.p.name] = table.p[rows]
            if isinstance(tp.o, Var):
                rel[tp.o.name] = table.o[rows]
            if bindings is not None:
                return join_rels(bindings, rel)
            return rel
        join_vars = [v for v in (tp.s, tp.p, tp.o)
                     if isinstance(v, Var) and v.name in bindings]
        jnames = [v.name for v in join_vars]
        stacked = np.stack([bindings[v].astype(np.int64) for v in jnames], axis=1)
        uniq = np.unique(stacked, axis=0)
        parts: list[Relation] = []
        for row in uniq:
            bind = dict(zip(jnames, row.tolist()))
            s2 = bind.get(tp.s.name, s) if isinstance(tp.s, Var) else s
            p2 = bind.get(tp.p.name, p) if isinstance(tp.p, Var) else p
            o2 = bind.get(tp.o.name, o) if isinstance(tp.o, Var) else o
            rows = chan.scan(s2, p2, o2)
            rel = {}
            if isinstance(tp.s, Var):
                rel[tp.s.name] = table.s[rows] if tp.s.name not in bind else np.full(len(rows), bind[tp.s.name], np.int32)
            if isinstance(tp.p, Var):
                rel[tp.p.name] = table.p[rows] if tp.p.name not in bind else np.full(len(rows), bind[tp.p.name], np.int32)
            if isinstance(tp.o, Var):
                rel[tp.o.name] = table.o[rows] if tp.o.name not in bind else np.full(len(rows), bind[tp.o.name], np.int32)
            parts.append(rel)
        matches = _concat(parts) if parts else _empty(out_vars)
        return join_rels(bindings, matches)

    def _ship(self, chan: SourceChannel, op: SubqueryOp) -> Relation:
        """One subquery dispatch at one endpoint: the legacy per-source chain
        with early break, through the channel's scan memo."""
        rel: "Relation | None" = op.bindings
        for tp in op.node.patterns:
            rel = self._eval_pattern(chan, tp, rel)
            if _nrows(rel) == 0 and rel:
                break
        if rel is None or _nrows(rel) == 0:
            rel = _empty(sorted(op.full_vars()))
        return rel

    def _commit(self, op: SubqueryOp, pos: int, part: Relation) -> None:
        op.parts[pos] = part
        self.metrics.requests += 1
        self.metrics.transferred_tuples += _nrows(part)
        star = op.node.stars[0] if len(op.node.stars) == 1 else None
        self._log(op.scan_kind(), self.channels[pos].name, star,
                  op.est_by_pos.get(pos), _nrows(part))
        if op.parent is not None:
            op.parent.accept(op.port, op.slot_index(pos), part)
        if op is self.root_op:
            self._note_progress(_nrows(part))

    def _order(self, tasks: "list[ScanTask]") -> "list[ScanTask]":
        if self.policy == "adaptive":
            return sorted(tasks,
                          key=lambda t: self._channel(t.pos).latency_estimate())
        if self.policy == "random":
            tasks = list(tasks)
            self.rng.shuffle(tasks)  # type: ignore[arg-type]
            return tasks
        return tasks

    def _run_bound_tasks(self, op: SubqueryOp) -> None:
        """Dispatch a bound subquery (the right side of a bind join) once its
        bindings are final.  Bound parts are never memoized across runs — the
        bindings may shrink after a salvage — but every underlying scan hits
        the channel memo, so a re-derivation ships nothing."""
        for task in self._order([ScanTask(op, p) for p in op.slots]):
            chan = self._channel(task.pos)
            chan.connect()
            self._commit(op, task.pos, self._ship(chan, op))

    def scan_order(self) -> "list[tuple[SubqueryOp, int]]":
        """The unbound scan schedule the next ``run()`` would use (testing /
        introspection)."""
        tasks = [ScanTask(op, pos) for op in self.subquery_ops
                 if not op.bound for pos in op.slots]
        return [(t.op, t.pos) for t in self._order(tasks)]

    # -- the run loop --------------------------------------------------------
    def run(self) -> ExecutionResult:
        t0 = time.perf_counter()
        self.metrics = ExecutionMetrics()
        self.card_log = []
        self.first_answer_t = None
        for op in self.ops:
            op.reset()
        replay: "list[ScanTask]" = []
        todo: "list[ScanTask]" = []
        for op in self.subquery_ops:
            if op.bound:
                continue
            for pos in op.slots:
                t = ScanTask(op, pos)
                (replay if pos in op.shipped else todo).append(t)
        # salvaged / resumed parts first: re-derive the dataflow for free
        for t in replay:
            self._channel(t.pos)
            self._commit(t.op, t.pos, t.op.shipped[t.pos])
        for t in self._order(todo):
            chan = self._channel(t.pos)
            chan.connect()
            part = self._ship(chan, t.op)
            t.op.shipped[t.pos] = part
            self._commit(t.op, t.pos, part)
        rel = self.root_op.emit()
        # query completion (§3.4 step iv), identical to the legacy evaluator
        fill = 0 if self.plan.query.root is None else UNDEF
        proj = self.plan.query.effective_projection()
        rel = {v: rel.get(v, np.full(_nrows(rel), fill, np.int32)) for v in proj}
        if self.plan.query.distinct:
            rel = _dedup(rel)
        self.metrics.wall_ms = (time.perf_counter() - t0) * 1e3
        return ExecutionResult(rows=rel, metrics=self.metrics, plan=self.plan,
                               stats_epoch=self.plan.stats_epoch,
                               card_log=tuple(self.card_log))

    # -- routing / salvage ---------------------------------------------------
    def _alternates(self, op: SubqueryOp) -> "list[int]":
        """Relevant sources the ``SourceSelection`` retains for this
        subquery's star(s) beyond the plan's dispatch list — the re-route
        candidates when one of its endpoints dies."""
        sel = self.plan.selection
        if sel is None or not op.node.stars:
            return []
        cands: "set[int] | None" = None
        for si in op.node.stars:
            if si >= len(sel.star_sources):
                return []
            s = set(sel.star_sources[si])
            cands = s if cands is None else (cands & s)
        return sorted(cands or ())

    def drop_source(self, name: str) -> "list[str]":
        """Salvage after an endpoint death: remove the dead endpoint's slots
        from every subquery, re-route to alternate relevant sources where the
        selection retains any, and keep every already-shipped part of the
        survivors — the next ``run()`` re-derives the answer without
        re-executing completed scans.  Returns the names of any endpoints
        newly routed in."""
        pos = next((p for p, ch in self.channels.items() if ch.name == name),
                   None)
        if pos is None:
            pos = next(i for i, s in enumerate(self.fed.sources)
                       if s.name == name)
        chan = self._channel(pos)
        chan.dropped = True
        routed: "list[str]" = []
        for op in self.subquery_ops:
            if pos not in op.slots:
                continue
            op.slots.remove(pos)
            op.shipped.pop(pos, None)
            for alt in self._alternates(op):
                if alt == pos or alt in op.slots:
                    continue
                if self._channel(alt).dropped:
                    continue
                if getattr(self.fed.sources[alt], "dead", False):
                    continue
                op.slots.append(alt)
                nm = self.fed.sources[alt].name
                routed.append(nm)
                self.rerouted.append((name, nm))
        self.salvages += 1
        return routed

    # -- physical-transfer introspection ------------------------------------
    @property
    def physical_scans(self) -> int:
        return sum(ch.physical_scans for ch in self.channels.values())

    @property
    def physical_tuples(self) -> int:
        return sum(ch.physical_tuples for ch in self.channels.values())


def compile_plan(plan: PhysicalPlan, fed: Federation,
                 honor_faults: bool = False, policy: str = "static",
                 clock=None, rng=None) -> PipelineExecution:
    """Lower ``plan`` into a resumable operator pipeline over ``fed``."""
    return PipelineExecution(plan, fed, honor_faults=honor_faults,
                             policy=policy, clock=clock, rng=rng)
