"""The comparison that decides ``correct`` fails the control and a broken
program: the control (the reference with every answer made distinct) in
every cell, and each fault the cells can have planted under the timed path."""
import dataclasses

import numpy as np
import pytest

from odyssey_bench.control import ControlSystem
from odyssey_bench.system import _import_program
from odyssey_bench.tests.small import CELLS, run_small


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    out = run_small(workload, system_factory=ControlSystem)
    assert out["correct"] is False
    assert out["checks"]["wrong_answers"]["value"] > 0


def _altered_answer(mp):
    from repro_torch.engine.distributed import DistributedEngine
    execute = DistributedEngine.execute

    def altered(self, plan):
        res = execute(self, plan)
        rows = {v: c[:-1] if len(c) else np.zeros(1, c.dtype) for v, c in res.rows.items()}
        return dataclasses.replace(res, rows=rows)
    mp.setattr(DistributedEngine, "execute", altered)


def _stale_answer(mp):
    from repro_torch.engine.distributed import DistributedEngine
    execute = DistributedEngine.execute
    first = []

    def stale(self, plan):
        res = execute(self, plan)
        if not first:
            first.append(res.rows)
        return dataclasses.replace(res, rows=first[0])
    mp.setattr(DistributedEngine, "execute", stale)


def _half_batch(mp):
    from repro_torch.serve.query import QueryServeEngine
    run = QueryServeEngine._execute_batch

    def half(self, batch):
        keep = batch[: len(batch) // 2]
        with self._cond:
            self._n_pending -= len(batch) - len(keep)
        run(self, keep)
    mp.setattr(QueryServeEngine, "_execute_batch", half)


def _no_exchange(mp):
    from repro_torch.launch.mesh import Mesh
    mp.setattr(Mesh, "all_to_all", lambda self, x, axis="model": x)


FAULTS = {"answer altered where produced": _altered_answer,
          "state returned unchanged": _stale_answer,
          "half of each batch left out": _half_batch,
          "exchange between shards left out": _no_exchange}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_program_is_not_correct(fault, monkeypatch):
    _import_program()
    FAULTS[fault](monkeypatch)
    out = run_small("cdls.queries.closed", seconds=1.5, grace_s=1.0)
    assert out["correct"] is False and out["failed"] > 0
