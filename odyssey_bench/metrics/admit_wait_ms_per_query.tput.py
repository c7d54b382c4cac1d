"""Mean wait in admission per executed request of the window: from its
submission to the release of its batch to planning,
``QueryRequest.t_flushed - t_submit`` (engine clock)."""


def read(obs):
    waits = [(r[0].t_flushed - r[0].t_submit) * 1e3 for r in obs.records
             if r[0].done and hasattr(r[0], "t_flushed")]
    return sum(waits) / len(waits) if waits else None
