"""Mean host-clock milliseconds per executed request of the window in
the host rows: the valid-row filter, secondary join keys, projection and
DISTINCT (span ``odyssey.exec.rows``): ``DistMetrics.rows_ms``."""


def read(obs):
    ms = [getattr(r[0].metrics, "rows_ms", None) for r in obs.records if r[0].done]
    ms = [m for m in ms if m is not None]
    return sum(ms) / len(ms) if ms else None
