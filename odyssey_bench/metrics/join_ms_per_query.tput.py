"""Mean host-clock milliseconds per executed request of the window in
the joins: the exchange and the read of its overflow flag and shipped
count (span ``odyssey.exec.join``): ``DistMetrics.join_ms``."""


def read(obs):
    ms = [getattr(r[0].metrics, "join_ms", None) for r in obs.records if r[0].done]
    ms = [m for m in ms if m is not None]
    return sum(ms) / len(ms) if ms else None
