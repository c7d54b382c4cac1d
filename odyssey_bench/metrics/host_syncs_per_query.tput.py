"""Reads back to the host per executed request of the window: one after
each star and each join, two for the collected result,
``DistMetrics.host_syncs``."""


def read(obs):
    got = [getattr(r[0].metrics, "host_syncs", None) for r in obs.records if r[0].done]
    got = [n for n in got if n is not None]
    return sum(got) / len(got) if got else None
