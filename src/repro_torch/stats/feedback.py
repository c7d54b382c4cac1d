"""Cardinality feedback: observed execution closes the statistics loop.

Odyssey's statistics are computed once per source and drift as endpoints
ingest data.  The operator pipeline (``repro_torch.engine.pipeline``) records, for
every unbound single-star dispatch, the estimate the planner priced the
endpoint at (``SubqueryNode.est_source_cards``) next to the row count the
endpoint actually returned.  ``CardinalityFeedback`` aggregates those samples
per source and, when a source's mean log-scale q-error
(``repro_torch.core.cost.estimation_error``) crosses a threshold, marks it dirty;
``apply_pending()`` then re-derives exactly that source's CS/CP state via the
versioned lifecycle (``FederatedStats.refresh_source``), bumping the epoch so
the plan cache lazily evicts exactly the plans priced under the stale
statistics.

Threading contract (matches ``repro_torch.serve.query.QueryServeEngine``):

* ``observe_result`` is thread-safe — the executor thread calls it per
  finished query.
* ``apply_pending`` must run on the *planner* thread (the only thread that
  touches the optimizer/statistics), typically at the top of each planning
  batch.  It mutates ``FederatedStats`` in place; concurrent planning against
  a half-refreshed store would be a race.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.cost import estimation_error


@dataclass
class SourceDrift:
    """Accumulated evidence that one source's statistics have drifted."""

    name: str
    errors: list = field(default_factory=list)

    @property
    def n(self) -> int:
        return len(self.errors)

    @property
    def mean_error(self) -> float:
        return float(np.mean(self.errors)) if self.errors else 0.0


class CardinalityFeedback:
    """Observed-vs-estimated cardinality aggregator driving ``refresh_source``.

    ``threshold_x`` is expressed as a *factor*: the default 4.0 marks a
    source dirty once its scans are off by 4x on (geometric) average.
    ``min_observations`` guards against refreshing on a single noisy scan.
    """

    def __init__(self, stats, fed, threshold_x: float = 4.0,
                 min_observations: int = 3):
        if threshold_x <= 1.0:
            raise ValueError(f"threshold_x must be > 1 (got {threshold_x})")
        self.stats = stats
        self.fed = fed
        self.threshold = float(np.log2(threshold_x))
        self.min_observations = int(min_observations)
        self._lock = threading.Lock()
        self._drift: dict[str, SourceDrift] = {}
        # lifecycle bookkeeping the tests / ServeStats surface
        self.n_observations = 0
        self.refreshes: list[str] = []          # source names, in apply order

    # -- executor side -------------------------------------------------------

    def observe_result(self, result) -> None:
        """Fold one ``ExecutionResult``'s ``card_log`` into the per-source
        drift state.  Only ``kind == "scan"`` samples count: unbound
        single-star dispatches are the one form whose estimate and
        observation measure the same quantity (merged groups split estimates
        evenly; bind-join observations depend on the left side's bindings).
        Thread-safe."""
        log = getattr(result, "card_log", ()) or ()
        with self._lock:
            for ob in log:
                if ob.kind != "scan" or ob.source is None or ob.est is None:
                    continue
                drift = self._drift.setdefault(ob.source, SourceDrift(ob.source))
                drift.errors.append(estimation_error(ob.est, ob.obs))
                self.n_observations += 1

    # -- shared --------------------------------------------------------------

    def dirty_sources(self) -> list[str]:
        """Source names whose mean error crosses the threshold with enough
        observations behind it.  Thread-safe; does not mutate anything."""
        with self._lock:
            return sorted(
                d.name for d in self._drift.values()
                if d.n >= self.min_observations and d.mean_error >= self.threshold)

    def mean_error(self, name: str) -> float:
        with self._lock:
            d = self._drift.get(name)
            return d.mean_error if d is not None else 0.0

    # -- planner side --------------------------------------------------------

    def apply_pending(self) -> list[str]:
        """Refresh every dirty source from its current table and clear its
        accumulated errors.  Must run on the planner thread — it mutates the
        shared ``FederatedStats`` (one epoch bump per refreshed source, so
        the plan cache retires exactly the stale entries).  Returns the
        refreshed source names."""
        dirty = self.dirty_sources()
        applied: list[str] = []
        for name in dirty:
            try:
                src = self.fed.by_name(name)
            except (KeyError, StopIteration):
                continue                      # excluded mid-flight; drop it
            self.stats.refresh_source(src.sid, src.table)
            applied.append(name)
        if applied:
            with self._lock:
                for name in applied:
                    self._drift.pop(name, None)
                self.refreshes.extend(applied)
        return applied
