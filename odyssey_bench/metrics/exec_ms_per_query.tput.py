"""Host-clock execution time per served request over the window: the
server's ``exec_ms`` over its ``n_served`` (``ServeStats``)."""


def read(obs):
    served = obs.stats.get("n_served", 0)
    return obs.stats["exec_ms"] / served if served else None
