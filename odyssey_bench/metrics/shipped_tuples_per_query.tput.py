"""Tuples the executor moved between shards per executed request of the
window: ``DistMetrics.transferred_tuples`` (the plan's NTT on the mesh)."""


def read(obs):
    shipped = [getattr(r[0].metrics, "transferred_tuples", None)
               for r in obs.records if r[0].done]
    shipped = [s for s in shipped if s is not None]
    return sum(shipped) / len(shipped) if shipped else None
