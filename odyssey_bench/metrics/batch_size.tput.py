"""Requests per executed batch over the window: the server's ``n_served``
over its ``n_steps`` (``ServeStats``)."""


def read(obs):
    steps = obs.stats.get("n_steps", 0)
    return obs.stats["n_served"] / steps if steps else None
