"""Continuous-batching federated-query serving: shape-affine deadline-driven
admission, a two-stage plan/execute pipeline, and streaming completion.

``QueryServeEngine`` is the query-side sibling of the token-serving
``ServeEngine`` and shares its surface (``repro_torch.serve.base.ServeBase``):
``submit(query, deadline=None)`` enqueues under a per-request latency SLO,
``poll()`` streams completions out as they finish, ``drain()`` runs the
queue dry.  Three layers turn that surface into throughput:

1. **Shape-affine admission** (``repro_torch.serve.scheduler``): queued requests
   are grouped by plan-sharing affinity key — exact signature > selection
   key > pricing key > DP shape key, the exact tiering
   ``repro_torch.core.batch_planner`` exploits — and a group is flushed when its
   earliest member's deadline budget expires or it fills a batch.
   Deadline-driven, not size-driven: a lone request never waits past its
   SLO for batch-mates that are not coming, and a templated burst lands in
   *one* ``optimize_batch`` call instead of arrival-order fragments.
2. **Plan/execute overlap** (``pipeline=True``): a background planner
   thread runs host-side ``optimize_batch`` for batch *k+1* while the
   caller executes batch *k*, handing planned batches over a bounded queue.
   Past the admission watermark ``submit`` rejects or blocks
   (``queue_depth``/``backpressure``); a dead worker re-raises at the next
   call, never silently.
3. **Batched planning** underneath is unchanged: plan-cache hits and exact
   duplicates rebound per request, the rest share one source-selection pass
   and one DP sweep per shape (``dp_backend='torch'``, the default, routes
   shape groups through the resident ``repro_torch.kernels.dp_layer``
   sweep on ``device``, the card unless the caller asks for the CPU).

Scheduling never changes answers: per-request plans and rows are
bit-identical to the synchronous arrival-order ``step()`` loop
(differentially tested), because ``optimize_batch`` is bit-identical to the
sequential ``optimize`` loop regardless of how batches are cut.

See docs/serving.md for the admission policy, SLO semantics and the
migration notes.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from repro_torch.common.spans import span
from repro_torch.core.batch_planner import plan_affinity
from repro_torch.core.cost import CostModel
from repro_torch.core.federation import FederatedStats
from repro_torch.core.join_order import DEFAULT_DEVICE
from repro_torch.core.planner import OdysseyOptimizer, PhysicalPlan
from repro_torch.engine.local import ExecutionMetrics, LocalEngine
from repro_torch.query.algebra import BGPQuery
from repro_torch.rdf.dataset import Federation
from repro_torch.serve.base import (
    BackpressureError,
    ServeStats,
    warn_run_until_done,
)
from repro_torch.serve.scheduler import AdmissionController, ArrivalQueue, PlannerWorker


@dataclass
class QueryRequest:
    qid: int
    query: BGPQuery
    plan: PhysicalPlan | None = None
    rows: dict | None = None
    metrics: ExecutionMetrics | None = None
    done: bool = False
    cached: bool = False               # plan served from the plan cache
    stats_epoch: int = 0               # epoch the plan was emitted under
    slo: float = 0.0                   # admission deadline budget (seconds)
    deadline: float = 0.0              # absolute flush-by time (t_submit + slo)
    affinity_tier: str | None = None   # deepest tier shared with its group
    plan_ms: float = 0.0               # this request's own planning cost
    # engine-clock stamps, in order: submitted, its batch released to
    # planning, planned, its own execution began, done
    t_submit: float = 0.0
    t_flushed: float = 0.0
    t_planned: float = 0.0
    t_exec: float = 0.0
    t_done: float = 0.0

    def planning_latency_s(self) -> float:
        """Submission-to-plan latency as this request experienced it: queue
        wait plus its *own* planning attribution — a cache hit is charged
        its rebind, not the batch's whole planning window."""
        return max(0.0, self.t_planned - self.t_submit)


class QueryServeEngine:
    """Continuous batching for federated queries (module docstring).

    Modes:

    - ``admission='affinity'`` (default): shape-affine deadline-driven
      admission; ``'arrival'`` keeps the legacy arrival-order FIFO.
    - ``pipeline=False`` (default): synchronous — ``step()``/``poll()``/
      ``drain()`` plan and execute in the caller's thread.  ``True`` starts
      the background planner thread; use ``poll()``/``drain()`` (``step()``
      would race the worker and raises).
    - ``queue_depth``: admission watermark (requests waiting for planning);
      past it ``submit`` raises ``BackpressureError`` when
      ``backpressure='reject'`` or waits when ``'block'`` (pipeline mode
      only — in synchronous mode nothing drains the queue concurrently, so
      blocking would deadlock).

    ``deadline`` on ``submit`` is a per-request SLO budget in seconds; it
    bounds how long admission may hold the request waiting for batch-mates
    (``default_slo_ms`` when absent).  Planning and execution latency come
    on top; the serving benchmark measures the end-to-end distribution.
    """

    def __init__(self, fed: Federation, stats: FederatedStats,
                 max_batch: int = 64, plan_cache_size: int = 1024,
                 cost_model: CostModel | None = None, engine=None,
                 dp_backend: str = "torch",
                 device: str = DEFAULT_DEVICE,
                 admission: str = "affinity",
                 default_slo_ms: float = 25.0,
                 queue_depth: int | None = None,
                 backpressure: str = "reject",
                 pipeline: bool = False,
                 handoff_depth: int = 2,
                 feedback=None,
                 clock=time.perf_counter):
        if admission not in ("affinity", "arrival"):
            raise ValueError(f"admission must be 'affinity' or 'arrival', "
                             f"got {admission!r}")
        if backpressure not in ("reject", "block"):
            raise ValueError(f"backpressure must be 'reject' or 'block', "
                             f"got {backpressure!r}")
        if backpressure == "block" and not pipeline:
            raise ValueError(
                "backpressure='block' requires pipeline=True: in synchronous "
                "mode nothing drains the admission queue while submit waits, "
                "so a blocked submit could never resume")
        if handoff_depth < 1:
            raise ValueError(f"handoff_depth must be >= 1, got {handoff_depth}")
        self.optimizer = OdysseyOptimizer(stats, cost_model=cost_model,
                                          plan_cache_size=plan_cache_size,
                                          dp_backend=dp_backend,
                                          device=device)
        self.engine = engine if engine is not None else LocalEngine(fed)
        # optional repro_torch.stats.feedback.CardinalityFeedback: executions feed
        # observed cardinalities in (_execute_batch, any thread), and drifted
        # sources are refreshed at the top of the next planning batch
        # (_plan_batch — the only code that touches the optimizer/statistics)
        self.feedback = feedback
        self.max_batch = max_batch
        self.admission = admission
        self.default_slo = default_slo_ms * 1e-3
        self.queue_depth = queue_depth
        self.backpressure = backpressure
        self.pipeline = pipeline
        self.handoff_depth = handoff_depth
        self.finished: list[QueryRequest] = []
        self.serve_stats = ServeStats()
        self._clock = clock
        self._cond = threading.Condition()
        self._admission = (AdmissionController(max_batch)
                           if admission == "affinity"
                           else ArrivalQueue(max_batch))
        self._handoff: deque = deque()       # planned batches awaiting execution
        self._unpolled: list[QueryRequest] = []
        self._n_pending = 0                  # submitted and not yet finished
        self._next_qid = 0
        self._force_flush = False
        self._stopping = False
        self._worker_error: BaseException | None = None
        self._worker: PlannerWorker | None = None
        if pipeline:
            self._worker = PlannerWorker(self)
            self._worker.start()

    # -- introspection -------------------------------------------------------
    @property
    def queue(self) -> "list[QueryRequest]":
        """Requests still waiting for planning, in submission order (planned
        or in-flight requests are no longer on the queue)."""
        return sorted(self._admission.requests(), key=lambda r: r.qid)

    def _raise_worker_error(self) -> None:
        if self._worker_error is not None:
            err = self._worker_error
            raise RuntimeError(
                "the background planner thread died; the engine cannot make "
                "progress (original exception chained)") from err

    def _note_flush(self, reason: str) -> None:
        """Stats for one flushed batch — called with the lock held."""
        if reason == "full":
            self.serve_stats.n_full_flushes += 1
        elif reason == "deadline":
            self.serve_stats.n_deadline_flushes += 1
        else:
            self.serve_stats.n_forced_flushes += 1

    # -- admission -----------------------------------------------------------
    def submit(self, query: BGPQuery,
               deadline: "float | None" = None) -> QueryRequest:
        """Enqueue one query under a latency SLO of ``deadline`` seconds
        (``default_slo_ms`` when ``None``).  Raises ``BackpressureError``
        (or blocks, per ``backpressure``) at the queue-depth watermark."""
        key = plan_affinity(query) if self.admission == "affinity" else None
        with self._cond:
            self._raise_worker_error()
            if self.queue_depth is not None \
                    and len(self._admission) >= self.queue_depth:
                if self.backpressure == "reject":
                    self.serve_stats.n_rejected += 1
                    raise BackpressureError(
                        f"admission queue at its watermark "
                        f"({len(self._admission)} >= {self.queue_depth}); "
                        f"retry after draining or raise queue_depth")
                self.serve_stats.n_blocked += 1
                while len(self._admission) >= self.queue_depth:
                    self._cond.wait(0.02)
                    self._raise_worker_error()
            now = self._clock()
            slo = self.default_slo if deadline is None else float(deadline)
            req = QueryRequest(qid=self._next_qid, query=query, slo=slo,
                               deadline=now + slo, t_submit=now)
            self._next_qid += 1
            req.affinity_tier = self._admission.add(req, key, req.deadline)
            self._n_pending += 1
            self._cond.notify_all()
        return req

    # -- the two pipeline stages --------------------------------------------
    def _plan_batch(self, batch: "list[QueryRequest]") -> None:
        """Plan one admitted batch through ``optimize_batch`` and stamp
        per-request attribution.  In pipeline mode this runs on the worker
        thread (the only thread that touches the optimizer)."""
        with span("odyssey.serve.plan_batch"):
            t0 = self._clock()
            for req in batch:
                req.t_flushed = t0
            if self.feedback is not None:
                # planner thread == the only safe place to mutate the
                # statistics; each refresh bumps the epoch, so the plan cache
                # retires exactly the entries priced under the drifted source
                applied = self.feedback.apply_pending()
                if applied:
                    with self._cond:
                        self.serve_stats.n_stats_refreshes += len(applied)
                t0 = self._clock()
            plans = self.optimizer.optimize_batch([r.query for r in batch])
            t1 = self._clock()
            report = self.optimizer.last_batch_report
            for req, plan in zip(batch, plans):
                req.plan = plan
                req.cached = plan.cached
                req.stats_epoch = plan.stats_epoch
                req.plan_ms = plan.optimization_ms
                # per-request attribution: a plan-cache hit (or in-batch
                # duplicate) was ready after its own ~50us rebind — charging
                # it the whole batch's planning window (the old shared `t1`
                # stamp) made hits look as slow as cold plans in the latency
                # bench
                if plan.cached:
                    req.t_planned = min(t0 + plan.optimization_ms * 1e-3, t1)
                else:
                    req.t_planned = t1
            with self._cond:
                self.serve_stats.plan_ms += (t1 - t0) * 1e3
                self.serve_stats.plan_cache_hits += (report.cache_hits
                                                     + report.duplicates)
                self.serve_stats.n_planned += report.n_planned
                self.serve_stats.n_shapes += report.n_shapes

    def _execute_batch(self, batch: "list[QueryRequest]") -> None:
        """Execute one planned batch in the caller's thread; completions
        land on ``finished`` and the unpolled buffer.  A request's execution
        begins when the one before it in the batch is done."""
        with span("odyssey.serve.execute_batch"):
            t0 = t = self._clock()
            for req in batch:
                req.t_exec = t
                with span("odyssey.serve.execute", req.qid):
                    res = self.engine.execute(req.plan)
                req.rows, req.metrics = res.rows, res.metrics
                if self.feedback is not None:
                    self.feedback.observe_result(res)   # thread-safe
                req.done = True
                req.t_done = t = self._clock()
            with self._cond:
                self.serve_stats.exec_ms += (self._clock() - t0) * 1e3
                self.serve_stats.n_served += len(batch)
                self.serve_stats.n_steps += 1
                self.finished.extend(batch)
                self._unpolled.extend(batch)
                self._n_pending -= len(batch)
                self._cond.notify_all()

    def _take_unpolled(self) -> "list[QueryRequest]":
        with self._cond:
            out, self._unpolled = self._unpolled, []
        return out

    # -- synchronous quantum -------------------------------------------------
    def step(self) -> "list[QueryRequest]":
        """Synchronously flush the most urgent batch (deadline expired or
        not), plan it, execute it.  Returns the newly completed requests
        (anything finished since the last report, exactly once)."""
        if self.pipeline:
            raise RuntimeError(
                "step() is the synchronous scheduling quantum; with "
                "pipeline=True the planner thread owns batch formation — "
                "use poll()/drain()")
        self._raise_worker_error()
        with self._cond:
            got = self._admission.next_batch(self._clock(), force=True)
            if got is not None:
                self._note_flush(got[1])
        if got is not None:
            batch, _ = got
            self._plan_batch(batch)
            self._execute_batch(batch)
        return self._take_unpolled()

    # -- streaming completion ------------------------------------------------
    def poll(self) -> "list[QueryRequest]":
        """Non-blocking streaming completion: service whatever is ripe
        (synchronous mode) or already planned (pipeline mode), then return
        the requests that finished since the last report — each exactly
        once."""
        self._raise_worker_error()
        if self.pipeline:
            while True:
                with self._cond:
                    if not self._handoff:
                        break
                    batch = self._handoff.popleft()
                    self._cond.notify_all()    # handoff slot freed
                self._execute_batch(batch)
            self._raise_worker_error()
        else:
            while True:
                with self._cond:
                    got = self._admission.next_batch(self._clock(), force=False)
                    if got is not None:
                        self._note_flush(got[1])
                if got is None:
                    break
                batch, _ = got
                self._plan_batch(batch)
                self._execute_batch(batch)
        return self._take_unpolled()

    def completed(self):
        """Iterator form of ``poll``: yields requests as they complete until
        everything submitted so far has been reported."""
        while True:
            with self._cond:
                pending = self._n_pending or self._unpolled
            if not pending:
                return
            yield from self.poll()

    # -- drain ---------------------------------------------------------------
    def drain(self, max_steps: int = 10_000) -> "list[QueryRequest]":
        """Run until everything submitted has completed; returns only the
        requests completed by *this* call (cumulative history stays on
        ``self.finished``).  Raises ``RuntimeError`` if ``max_steps``
        batches are exhausted with requests still queued — a partial drain
        must not be mistakable for a full one (the leftover stays on
        ``self.queue``; callers can inspect it and drain again)."""
        done: "list[QueryRequest]" = []
        steps = 0
        if not self.pipeline:
            while self._n_pending and steps < max_steps:
                done.extend(self.step())
                steps += 1
        else:
            with self._cond:
                self._force_flush = True
                self._cond.notify_all()
            try:
                while steps < max_steps:
                    with self._cond:
                        if not self._n_pending:
                            break
                        self._raise_worker_error()
                        if not self._handoff:
                            self._cond.wait(0.02)
                            continue
                        batch = self._handoff.popleft()
                        self._cond.notify_all()
                    self._execute_batch(batch)
                    steps += 1
                done.extend(self._take_unpolled())
            finally:
                with self._cond:
                    self._force_flush = False
        if self._n_pending:
            raise RuntimeError(
                f"drain gave up after {max_steps} steps with "
                f"{self._n_pending} request(s) still queued ({len(done)} "
                f"completed this call; the leftover stays on .queue)")
        return done

    def run_until_done(self, max_steps: int = 10_000) -> "list[QueryRequest]":
        """Deprecated: thin wrapper over ``drain`` (same return value, same
        partial-drain ``RuntimeError`` contract)."""
        warn_run_until_done(type(self).__name__)
        return self.drain(max_steps=max_steps)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Stop the background planner thread (no-op in synchronous mode).
        Queued-but-unplanned requests stay queued; a later ``close`` is
        idempotent."""
        if self._worker is None:
            return
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._worker.join(timeout=10.0)
        self._worker = None

    def __enter__(self) -> "QueryServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
