"""The unified serving surface shared by the token engine and the query
engine (a copy of the reference's ``serve/base.py``).

Both engines expose the same four verbs over the same stats shape
(``ServeBase``):

- ``submit(item, deadline=None)`` — enqueue one request.  ``deadline`` is a
  per-request SLO *budget in seconds* (relative to submission); ``None``
  takes the engine's default latency target.  The admission layer may hold a
  request up to its deadline waiting for batch-mates; past a configured
  queue-depth watermark, ``submit`` rejects (``BackpressureError``) or
  blocks, with counters on ``ServeStats``.
- ``step()`` — synchronously advance the engine by one scheduling quantum
  (one admitted batch for queries, one decode token for the LM).
- ``poll()`` — streaming completion: return the requests that finished since
  the last ``step()``/``poll()``/``drain()`` report.  A request is reported
  exactly once across all three verbs; the cumulative history stays on
  ``.finished``.
- ``drain(max_steps=...)`` — run until everything submitted has completed
  and return the requests completed by this call.  Exhausting ``max_steps``
  with work still pending raises ``RuntimeError`` (a partial drain must not
  be mistakable for a full one); the leftover stays queued.

``run_until_done`` survives as a thin deprecated wrapper over ``drain`` with
the identical partial-drain contract.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Protocol, runtime_checkable


class BackpressureError(RuntimeError):
    """``submit`` rejected: the admission queue is at its watermark."""


@dataclass
class ServeStats:
    """Cumulative serving counters — one shape for every engine.  The token
    engine leaves the planner fields at zero; the query engine fills them
    from ``BatchPlanReport``."""

    n_served: int = 0                  # requests completed
    n_steps: int = 0                   # scheduling quanta executed
    n_rejected: int = 0                # submits rejected at the watermark
    n_blocked: int = 0                 # submits that waited at the watermark
    n_deadline_flushes: int = 0        # batches flushed by an expiring SLO
    n_full_flushes: int = 0            # batches flushed by a full group
    n_forced_flushes: int = 0          # batches flushed by step()/drain()
    plan_cache_hits: int = 0           # incl. in-batch exact duplicates
    n_planned: int = 0                 # requests that ran the full pipeline
    n_shapes: int = 0                  # shape groups swept (summed over steps)
    n_stats_refreshes: int = 0         # feedback-triggered refresh_source calls
    plan_ms: float = 0.0
    exec_ms: float = 0.0


@runtime_checkable
class ServeBase(Protocol):
    """Structural protocol of a serving engine (see the module docstring).
    ``ServeEngine`` and ``QueryServeEngine`` both satisfy it."""

    serve_stats: ServeStats

    def submit(self, item, deadline: "float | None" = None): ...

    def step(self): ...

    def poll(self) -> list: ...

    def drain(self, max_steps: int = 10_000) -> list: ...


def warn_run_until_done(cls_name: str) -> None:
    """The shared deprecation notice behind both engines' wrappers."""
    warnings.warn(
        f"{cls_name}.run_until_done is deprecated; call drain() "
        "(same semantics, including the partial-drain RuntimeError)",
        DeprecationWarning, stacklevel=3)
