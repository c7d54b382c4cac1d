"""The control of the comparison that decides ``correct``: the reference put
in the program's place with one guarantee of the configuration broken.  It
answers every query as if it said ``DISTINCT``, so duplicate rows are lost
where the configuration promises SPARQL's bag semantics.  The comparison
has to find such runs not correct.

    python3 -m odyssey_bench.control --workload <cell> --seconds <s> --seeds 1 2 3

runs the cell's traffic against the control, one window a seed, and prints
each seed's checks.  The benchmark's own runs never use it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from odyssey_bench.reference import bgp


class _Request:
    def __init__(self, query, now: float) -> None:
        self.query = query
        self.t_submit = now
        self.done = False
        self.t_done = 0.0
        self.rows = None
        self.metrics = None


class _ControlServer:
    """Answers in ``poll``, one request after another, in arrival order,
    each computed afresh as the program would."""

    def __init__(self, graph: bgp.Graph) -> None:
        self.graph = graph
        self._queue: list = []

    def submit(self, query) -> _Request:
        req = _Request(query, time.perf_counter())
        self._queue.append(req)
        return req

    def poll(self) -> list:
        done, self._queue = self._queue, []
        for req in done:
            q = req.query
            cols = bgp.evaluate(self.graph, q.patterns, q.projection, distinct=True)
            req.rows = dict(zip(q.projection, cols))
            req.done = True
            req.t_done = time.perf_counter()
        return done

    def drain(self) -> list:
        return self.poll()


class ControlSystem:
    """Stands where ``system.PortSystem`` stands in a run."""

    def __init__(self, cfg: dict, fd, device: str) -> None:
        self.server = _ControlServer(bgp.Graph(
            *(np.concatenate([getattr(sd, c) for sd in fd.sources]) for c in "spo")))

    def query(self, q):
        return q

    def close(self) -> None:
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    args = ap.parse_args(argv)

    from odyssey_bench.harness import run_cell

    for seed in args.seeds:
        out = run_cell(args.workload, seed, args.seconds, False, device="cpu",
                       system_factory=ControlSystem)
        print(json.dumps(dict(seed=seed, correct=out["correct"], attempted=out["attempted"],
                              checks=out["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
