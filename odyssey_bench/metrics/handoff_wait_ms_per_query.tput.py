"""Mean wait between planning and execution per executed request of the
window: ``QueryRequest.t_exec - t_planned`` (engine clock), the planned
batch's time in the handoff and behind its batch-mates."""


def read(obs):
    waits = [(r[0].t_exec - r[0].t_planned) * 1e3 for r in obs.records
             if r[0].done and hasattr(r[0], "t_exec")]
    return sum(waits) / len(waits) if waits else None
