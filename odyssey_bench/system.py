"""The system under test: the port's query server over a configuration's
federation, built from the benchmark's generated data.

This is the one module of the benchmark that imports the program
(``repro_torch``, from ``src/`` beside the benchmark).  It hands the program
the generated triples and terms, lets the program's default path build the
statistics, and serves through ``QueryServeEngine`` with the executor the
configuration names.
"""
from __future__ import annotations

import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def _import_program() -> None:
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


class PortSystem:
    """``server`` is the port's ``QueryServeEngine``; ``query`` turns a
    benchmark query into the port's ``BGPQuery``."""

    def __init__(self, cfg: dict, fd, device: str) -> None:
        _import_program()
        from repro_torch.core.federation import build_federated_stats
        from repro_torch.engine.distributed import DistributedEngine
        from repro_torch.engine.local import LocalEngine
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.query.algebra import BGPQuery, Const, TriplePattern, Var
        from repro_torch.rdf.dataset import Federation, Source, TripleTable
        from repro_torch.rdf.dictionary import TermDict, TermKind
        from repro_torch.serve.query import QueryServeEngine

        self._types = (BGPQuery, Const, TriplePattern, Var)
        terms = TermDict()
        for term, kind, auth in zip(fd.terms, fd.kinds.tolist(), fd.authorities):
            terms.add(term, TermKind(kind), authority=auth)
        fed = Federation([Source(sd.name, TripleTable.from_triples(sd.s, sd.p, sd.o))
                          for sd in fd.sources], terms)
        stats = build_federated_stats(fed)
        executor = cfg["executor"]
        if executor == "spmd":
            self.engine = DistributedEngine(
                fed, make_test_mesh(tuple(cfg["mesh"]), device=device),
                cap=cfg["cap"], partition_aware=cfg.get("partition_aware", True))
            self.table_cap = self.engine.table_cap
            self.table_bytes = self.engine.tables.numel() * self.engine.tables.element_size()
        elif executor == "local":
            self.engine = LocalEngine(fed)
            self.table_cap = self.table_bytes = None
        else:
            raise ValueError(f"unknown executor {executor!r}")
        self.server = QueryServeEngine(
            fed, stats, engine=self.engine, dp_backend=cfg.get("dp_backend", "torch"),
            device=device, admission=cfg.get("admission", "affinity"),
            pipeline=cfg.get("pipeline", True))

    def query(self, q):
        BGPQuery, Const, TriplePattern, Var = self._types

        def term(t):
            return Var(t) if isinstance(t, str) else Const(int(t))

        return BGPQuery([TriplePattern(*(term(t) for t in tp)) for tp in q.patterns],
                        distinct=q.distinct, projection=list(q.projection), name=q.name)

    def close(self) -> None:
        self.server.close()
