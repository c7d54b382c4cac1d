"""Distributed-engine self-test: run the federated workload through the SPMD
executor on a small mesh and compare it against the exact host engine and
``naive_evaluate``.  Every shard of the mesh lives on one device, so no
device count or subprocess is needed.

Usage: python -m repro_torch.launch.dist_selftest [d] [m]
           [--device cuda|cpu] [--[no-]partition-aware]
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("d", type=int, nargs="?", default=4, help="data shards")
    ap.add_argument("m", type=int, nargs="?", default=2, help="model shards")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--partition-aware", action=argparse.BooleanOptionalAction,
                    default=True)
    args = ap.parse_args(argv)

    from repro_torch.core.federation import build_federated_stats
    from repro_torch.core.planner import OdysseyOptimizer
    from repro_torch.engine.distributed import DistributedEngine, UnsupportedShapeError
    from repro_torch.engine.local import LocalEngine, naive_evaluate
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.rdf.generator import (FederationSpec, LinkSpec, SourceSpec,
                                           generate_federation, generate_workload)

    _d, _m = args.d, args.m
    spec = FederationSpec(sources=[
        SourceSpec("A", n_entities=160, n_templates=6, n_local_preds=10),
        SourceSpec("B", n_entities=120, n_templates=5, n_local_preds=8,
                   links=[LinkSpec("owl:sameAs", "A", 0.5)]),
        SourceSpec("C", n_entities=100, n_templates=4, n_local_preds=8,
                   links=[LinkSpec("c:ref", "B", 0.4), LinkSpec("c:self", "C", 0.3)]),
        SourceSpec("D", n_entities=80, n_templates=4, n_local_preds=8,
                   links=[LinkSpec("owl:sameAs", "A", 0.4)]),
    ][:_d], seed=21)
    fed, gt = generate_federation(spec)
    stats = build_federated_stats(fed)
    queries = generate_workload(fed, gt, n_star=6, n_hybrid=4, n_path=2, seed=9)
    mesh = make_test_mesh((_d, _m), device=args.device)
    opt = OdysseyOptimizer(stats, device=args.device)
    local = LocalEngine(fed)
    dist = DistributedEngine(fed, mesh, cap=4096,
                             partition_aware=args.partition_aware)

    n_ok = 0
    n_run = 0
    for q in queries:
        plan = opt.optimize(q)
        if plan.fallback:
            continue
        res_l = local.execute(plan)
        rel_l = res_l.rows
        proj = q.effective_projection()
        nl = len(next(iter(rel_l.values()))) if rel_l else 0
        want = set(zip(*[rel_l[v].tolist() for v in proj])) if nl else set()
        # gold standard too
        gold = naive_evaluate(fed, q)
        try:
            res_d = dist.execute(plan)
        except UnsupportedShapeError:
            continue  # plan shape unsupported (e.g. cartesian) -- skip
        rel_d, m_d = res_d.rows, res_d.metrics
        nd = len(next(iter(rel_d.values()))) if rel_d else 0
        got = set(zip(*[rel_d[v].tolist() for v in proj])) if nd else set()
        n_run += 1
        if m_d.overflowed:
            print(f"OVERFLOW {q.name}")
            continue
        if got == gold and (not q.distinct or got == want):
            n_ok += 1
        else:
            print(f"FAIL {q.name}: dist={len(got)} gold={len(gold)}")
            a = sorted(gold - got)[:3]
            b = sorted(got - gold)[:3]
            print("  missing:", a, " extra:", b)
    print(f"dist_selftest: {n_ok}/{n_run} queries OK on mesh ({_d},{_m}) "
          f"on {args.device}")
    return 0 if (n_run > 0 and n_ok == n_run) else 1


if __name__ == "__main__":
    sys.exit(main())
