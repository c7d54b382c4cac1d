"""Mean host-clock milliseconds per executed request of the window in
the stars: pattern encoding, the scans and subject joins, and the
overflow read (span ``odyssey.exec.star``): ``DistMetrics.star_ms``."""


def read(obs):
    ms = [getattr(r[0].metrics, "star_ms", None) for r in obs.records if r[0].done]
    ms = [m for m in ms if m is not None]
    return sum(ms) / len(ms) if ms else None
