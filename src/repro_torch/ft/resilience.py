"""Fault-tolerance utilities used by the launchers and the federated engine.

* ``RetryPolicy`` — exponential-backoff retry around endpoint dispatch /
  step execution; the federated engine treats a failing endpoint like the
  paper treats a timed-out SPARQL endpoint (retry, then surface partiality).
* ``StragglerMitigator`` — tracks per-worker (endpoint/subquery) latency
  EWMAs; when a dispatch exceeds ``factor`` × EWMA it issues a *backup
  request* (speculative duplicate), keeping whichever answer lands first —
  the classic tail-latency mitigation, applied to federated subqueries.
* ``Heartbeat`` — deadline-based liveness bookkeeping that the multi-node
  launcher would wire to its control plane; simulated in-process here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class RetryPolicy:
    """Exponential-backoff retry.  ``sleep`` is injectable (a virtual clock's
    ``advance``, or a no-op) so fault-injection tests and benchmarks retry
    deterministically without wall-clock sleeps."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    backoff: float = 2.0
    sleep: "object" = time.sleep

    def run(self, fn, *args, on_retry=None, **kw):
        delay = self.base_delay_s
        last_exc: Exception | None = None
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kw)
            # repro: ignore[RPR102] -- deliberate retry boundary: any endpoint
            # failure is retried with backoff, and the terminal RuntimeError
            # below chains the last exception so nothing is swallowed
            except Exception as exc:  # noqa: BLE001 - deliberate boundary
                last_exc = exc
                if on_retry is not None:
                    on_retry(attempt, exc)
                if attempt + 1 < self.max_attempts:
                    self.sleep(delay)
                    delay *= self.backoff
        raise RuntimeError(f"retries exhausted: {last_exc}") from last_exc


@dataclass
class StragglerMitigator:
    factor: float = 3.0
    alpha: float = 0.3
    min_samples: int = 3
    _ewma: dict[object, float] = field(default_factory=dict)
    _count: dict[object, int] = field(default_factory=dict)
    backups_issued: int = 0

    def observe(self, worker, latency_s: float) -> None:
        prev = self._ewma.get(worker)
        self._ewma[worker] = (latency_s if prev is None
                              else self.alpha * latency_s + (1 - self.alpha) * prev)
        self._count[worker] = self._count.get(worker, 0) + 1

    def deadline_s(self, worker) -> float | None:
        if self._count.get(worker, 0) < self.min_samples:
            return None
        return self.factor * self._ewma[worker]

    def run_with_backup(self, worker, fn, backup_fn):
        """Run ``fn``; if it exceeds the worker's deadline, also run
        ``backup_fn`` and take the first (sequential simulation of
        speculative execution)."""
        t0 = time.perf_counter()
        result = fn()
        dt = time.perf_counter() - t0
        dl = self.deadline_s(worker)
        self.observe(worker, dt)
        if dl is not None and dt > dl:
            self.backups_issued += 1
            return backup_fn()
        return result


@dataclass
class Heartbeat:
    timeout_s: float = 10.0
    _last: dict[object, float] = field(default_factory=dict)

    def beat(self, node) -> None:
        self._last[node] = time.monotonic()

    def dead(self) -> list[object]:
        now = time.monotonic()
        return [n for n, t in self._last.items() if now - t > self.timeout_s]
