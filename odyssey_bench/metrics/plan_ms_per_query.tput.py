"""Host-clock planning time per served request over the window: the
server's ``plan_ms`` over its ``n_served`` (``ServeStats``)."""


def read(obs):
    served = obs.stats.get("n_served", 0)
    return obs.stats["plan_ms"] / served if served else None
