"""Endpoint failover for the federated engine, on the versioned statistics
lifecycle.

A SPARQL federation loses endpoints routinely; the paper's engines time out.
Here failures are first-class and *cheap*: a ``FailoverSession`` owns one
long-lived ``OdysseyOptimizer``.  Transient failures are retried without
replanning (RetryPolicy); an endpoint that stays dead is excluded via
``FederatedStats.remove_source`` — only the dead source's statistics are
dropped (the survivors' CS/CP state and memoized formulas are reused, no
rebuild) — and the epoch bump lazily evicts exactly the now-stale cached
plans, so a templated workload re-warms the plan cache after the first
replan instead of losing it.  Recovery is symmetric: ``restore`` re-adds a
source incrementally (``add_source``).

Since the operator-pipeline refactor (docs/execution.md) a death
*mid-execution* is cheaper still: the session salvages the pipeline's
already-produced operator state — only the dead endpoint's scans drop (or
re-route to an alternate relevant source), no completed scan re-executes —
instead of replanning and re-running the query from scratch
(``salvage=False`` restores the legacy loop).

Source selection runs again without the dead source, so the
no-false-negative guarantee holds **relative to the live data** and the
result is flagged partial (the honest contract; silently complete-looking
results are the failure mode to avoid).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.federation import FederatedStats
from repro_torch.core.join_order import DEFAULT_DEVICE
from repro_torch.core.planner import OdysseyOptimizer, PhysicalPlan
from repro_torch.engine.local import ExecutionMetrics, LocalEngine
from repro_torch.ft.resilience import RetryPolicy
from repro_torch.query.algebra import BGPQuery
from repro_torch.rdf.dataset import Federation, Source


class EndpointDown(RuntimeError):
    pass


class FlakySource(Source):
    """Test/simulation fault- and latency-injection wrapper.

    Three failure axes, all deterministic:

    * ``fail_times`` — ``check()`` raises for the first N dispatches
      (transient outage, healed by a retry);
    * ``dead`` — ``check()`` always raises (hard death at dispatch);
    * ``die_after_tuples`` — ``note_tuples()`` flips ``dead`` and raises the
      moment the endpoint has served more than N tuples (death *mid-scan*:
      earlier completed scans stay shipped, the crossing scan is lost).

    ``latency_s`` is a deterministic per-scan latency the pipeline's
    ``SourceChannel`` charges to an injectable virtual clock (no wall-clock
    sleeps — the pattern of ``tests/test_serve_scheduler.py``), which is what
    makes adaptive-vs-static routing measurable.
    """

    def __init__(self, src: Source, fail_times: int = 0, dead: bool = False,
                 die_after_tuples: "int | None" = None,
                 latency_s: float = 0.0):
        super().__init__(src.name, src.table, src.sid)
        self._fails_left = fail_times
        self.dead = dead
        self.die_after_tuples = die_after_tuples
        self.latency_s = latency_s
        self.tuples_served = 0

    def check(self) -> None:
        if self.dead:
            raise EndpointDown(self.name)
        if self._fails_left > 0:
            self._fails_left -= 1
            raise EndpointDown(f"{self.name} (transient)")

    def note_tuples(self, n: int) -> None:
        """Physical-scan accounting hook (called by ``SourceChannel`` per
        cache-missing scan); the mid-scan death trigger."""
        self.tuples_served += n
        if (self.die_after_tuples is not None
                and self.tuples_served > self.die_after_tuples):
            self.dead = True
            raise EndpointDown(
                f"{self.name} (died mid-scan after {self.die_after_tuples} "
                f"tuples)")


class FailoverEngine(LocalEngine):
    """LocalEngine that honors FlakySource failures.  On the pipeline path
    the ``SourceChannel`` enforces faults per scan task (``honor_faults``);
    the recursive path keeps the legacy whole-subquery dispatch check."""

    honor_faults = True

    def _eval_subquery(self, node, metrics, bindings=None):
        for sid in node.sources:
            src = self.fed.sources[sid]
            if isinstance(src, FlakySource):
                src.check()
        return super()._eval_subquery(node, metrics, bindings)


@dataclass
class FailoverResult:
    rows: dict
    metrics: ExecutionMetrics
    partial: bool                 # True => some endpoint was excluded
    excluded: list[str]
    replans: int = 0
    salvages: int = 0             # mid-query salvages (operator state kept)
    cache_hit: bool = False       # plan served from the optimizer's plan cache
    stats_epoch: int = 0          # statistics epoch the answer was planned under
    rerouted: "list[tuple[str, str]]" = None  # (dead, alternate) re-routes
    card_log: tuple = ()          # observed-vs-estimated cardinality samples

    def __post_init__(self):
        if self.rerouted is None:
            self.rerouted = []


class FailoverSession:
    """Long-lived failover executor: one optimizer, one live federation.

    The session clones ``stats`` once (cheap: the clone shares the statistics
    arrays) so endpoint exclusion never writes through to the caller's
    statistics.  Across queries the plan cache and the untouched sources'
    memoized formulas survive every exclusion — previously each dead endpoint
    threw away the optimizer and rebuilt the whole federation's statistics.

    Its optimizer plans with ``dp_backend`` on ``device``: the DP sweep of
    every plan, replan and post-``restore`` plan runs on the card unless the
    caller asks for the CPU (``device="cpu"``) or the numpy backend.
    """

    def __init__(self, fed: Federation, stats: FederatedStats,
                 retry: RetryPolicy | None = None, clone_stats: bool = True,
                 salvage: bool = True, scan_policy: str = "static",
                 dp_backend: str = "torch", device: str = DEFAULT_DEVICE):
        self.retry = retry or RetryPolicy(max_attempts=3, base_delay_s=0.001)
        self.optimizer = OdysseyOptimizer(
            stats.clone() if clone_stats else stats, dp_backend=dp_backend,
            device=device)
        self.fed = fed
        self.salvage = salvage
        self.scan_policy = scan_policy
        self.excluded: list[str] = []
        self._all_sources: dict[str, Source] = {s.name: s for s in fed.sources}
        self._base_sources: list[Source] = list(fed.sources)

    @property
    def stats(self) -> FederatedStats:
        return self.optimizer.stats

    def _compile(self, plan: PhysicalPlan, fed: Federation):
        from repro_torch.engine.pipeline import compile_plan
        return compile_plan(plan, fed, honor_faults=True,
                            policy=self.scan_policy)

    def execute(self, query: BGPQuery) -> FailoverResult:
        """Execute with mid-query salvage: an endpoint death keeps the
        pipeline's already-produced operator state (no completed scan is
        re-executed — the dead endpoint's scans drop or re-route) instead of
        replanning from scratch.  ``salvage=False`` restores the legacy
        exclude-and-replan loop.  ``partial``/``excluded`` semantics are
        identical either way."""
        replans = salvages = 0
        plan = self.optimizer.optimize(query)
        exec_ = self._compile(plan, self.fed)
        while True:
            try:
                res = self.retry.run(exec_.run)
                return FailoverResult(rows=res.rows, metrics=res.metrics,
                                      partial=bool(self.excluded),
                                      excluded=list(self.excluded),
                                      replans=replans, salvages=salvages,
                                      cache_hit=plan.cached,
                                      stats_epoch=self.stats.epoch,
                                      rerouted=list(exec_.rerouted),
                                      card_log=res.card_log)
            except RuntimeError:
                # a dead endpoint survived retries
                sid = self._find_dead()
                if sid is None:
                    raise
                name = self.exclude(sid)
                if self.salvage:
                    # drop/re-route only the dead endpoint's scans; survivors'
                    # shipped parts stay salvaged inside the execution
                    exec_.drop_source(name)
                    salvages += 1
                else:
                    replans += 1
                    plan = self.optimizer.optimize(query)
                    exec_ = self._compile(plan, self.fed)

    def execute_batch(self, queries: "list[BGPQuery]") -> "list[FailoverResult]":
        """Failover-aware batch execution on the truly batched planner: the
        whole batch is planned in one ``optimize_batch`` call (shared source
        selection, one DP sweep per shape, one epoch snapshot), then executed
        query by query.  When an endpoint turns out dead it is excluded once
        and the *remaining* queries are replanned as a (smaller) batch under
        the new epoch — completed queries keep their results, so a mid-batch
        death costs one exclusion plus one batched replan, not per-query
        rebuilds.  With ``salvage`` (the default) the query that was running
        when the endpoint died additionally completes on its salvaged
        operator state instead of joining the replan.

        A ``RuntimeError`` with no dead endpoint to blame propagates and the
        call is all-or-nothing — the same contract as the sequential
        ``[session.execute(q) for q in queries]`` it replaces; callers that
        must keep partial progress through *non-endpoint* failures should
        fall back to per-query ``execute``."""
        results: "list[FailoverResult | None]" = [None] * len(queries)
        pending = list(range(len(queries)))
        replans = 0
        while pending:
            plans = self.optimizer.optimize_batch([queries[i] for i in pending])
            fed_now = self.fed          # the federation these plans address
            still: list[int] = []
            excluded_now = False
            for i, plan in zip(pending, plans):
                if excluded_now:
                    still.append(i)       # replan under the new epoch
                    continue
                exec_ = self._compile(plan, fed_now)
                while True:
                    try:
                        res = self.retry.run(exec_.run)
                    except RuntimeError:
                        sid = self._find_dead()
                        if sid is None:
                            raise
                        name = self.exclude(sid)
                        excluded_now = True
                        replans += 1      # the remainder replans either way
                        if self.salvage:
                            # finish *this* query on its salvaged operator
                            # state; the rest of the batch replans under the
                            # new epoch (their plans still address the dead
                            # endpoint)
                            exec_.drop_source(name)
                            continue
                        still.append(i)
                        res = None
                        break
                    break
                if res is None:
                    continue
                results[i] = FailoverResult(
                    rows=res.rows, metrics=res.metrics,
                    partial=bool(self.excluded),
                    excluded=list(self.excluded), replans=replans,
                    salvages=exec_.salvages, cache_hit=plan.cached,
                    stats_epoch=plan.stats_epoch,
                    rerouted=list(exec_.rerouted), card_log=res.card_log)
            pending = still
        return results      # type: ignore[return-value]

    def _find_dead(self) -> int | None:
        for i, s in enumerate(self.fed.sources):
            if isinstance(s, FlakySource) and s.dead:
                return i
        return None

    def exclude(self, sid: int) -> str:
        """Drop source ``sid`` from the live federation and its statistics.
        Incremental: survivors keep their statistics and warm caches; the
        epoch bump makes the plan cache lazily evict only stale plans."""
        keep = self.fed.sources[:sid] + self.fed.sources[sid + 1:]
        if not keep:
            raise RuntimeError("every endpoint is dead")
        name = self.fed.sources[sid].name
        # mutate the statistics first: session bookkeeping (the `partial`
        # contract reads `excluded`) must only record what actually happened
        self.stats.remove_source(sid)
        self.excluded.append(name)
        self.fed = self._rebuild_fed(keep)
        return name

    def restore(self, name: str) -> int:
        """Recovery: re-admit a previously excluded source.  Its statistics
        (and the federated CPs incident to it) are rebuilt incrementally via
        ``add_source``; everything else is reused.  Returns the new sid."""
        if name not in self.excluded:
            raise ValueError(f"source {name!r} is not excluded")
        src = self._all_sources[name]
        # add_source does real work (local stats + Algorithm 1 pairs) and may
        # raise; only clear the exclusion once the source is really back,
        # otherwise later results would look complete while it is absent
        sid = self.stats.add_source(src.table)
        self.excluded.remove(name)
        self.fed = self._rebuild_fed(self.fed.sources + [src])
        return sid

    def _rebuild_fed(self, sources: list[Source]) -> Federation:
        """Live federation over the (shared) Source objects.  Federation's
        __post_init__ renumbers ``src.sid`` in place on those shared objects;
        restore the caller's numbering afterwards — engines address sources
        by list index, never by the sid field, so the session works either
        way but the caller's original federation must stay intact."""
        fed = Federation(sources, self.fed.dictionary)
        for i, s in enumerate(self._base_sources):
            s.sid = i
        return fed


def execute_with_failover(fed: Federation, stats: FederatedStats,
                          query: BGPQuery,
                          retry: RetryPolicy | None = None,
                          session: FailoverSession | None = None,
                          dp_backend: str = "torch",
                          device: str = DEFAULT_DEVICE) -> FailoverResult:
    """One-shot convenience wrapper around ``FailoverSession``.  Pass a
    ``session`` to amortize the optimizer, plan cache and statistics across a
    workload (templated queries then hit the plan cache even after a replan).
    ``dp_backend`` and ``device`` configure the session this call builds; a
    passed ``session`` plans with its own."""
    if session is None:
        session = FailoverSession(fed, stats, retry=retry,
                                  dp_backend=dp_backend, device=device)
    elif retry is not None:
        raise ValueError("pass the retry policy to the FailoverSession, not "
                         "alongside it (a session owns its retry policy)")
    return session.execute(query)
