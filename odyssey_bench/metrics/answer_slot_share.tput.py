"""Share of the row slots read back that held an answer row, over the
executed requests of the window: the sum of ``DistMetrics.answer_rows``
over the sum of ``DistMetrics.readback_slots`` (d * m * cap each)."""


def read(obs):
    rows = slots = 0
    for r in obs.records:
        m = r[0].metrics
        if r[0].done and hasattr(m, "readback_slots"):
            rows += m.answer_rows
            slots += m.readback_slots
    return rows / slots if slots else None
