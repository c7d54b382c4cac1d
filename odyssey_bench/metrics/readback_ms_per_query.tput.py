"""Mean host-clock milliseconds per executed request of the window in
the read-back: the collect and the copy of the padded result to the host
(span ``odyssey.exec.readback``): ``DistMetrics.readback_ms``."""


def read(obs):
    ms = [getattr(r[0].metrics, "readback_ms", None) for r in obs.records if r[0].done]
    ms = [m for m in ms if m is not None]
    return sum(ms) / len(ms) if ms else None
