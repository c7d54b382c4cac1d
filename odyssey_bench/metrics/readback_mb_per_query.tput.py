"""Megabytes (1e6 bytes) the executor read back to the host per executed
request of the window: the collected result's rows and valid flags,
``DistMetrics.readback_bytes``."""


def read(obs):
    got = [getattr(r[0].metrics, "readback_bytes", None) for r in obs.records if r[0].done]
    got = [b for b in got if b is not None]
    return sum(got) / len(got) / 1e6 if got else None
