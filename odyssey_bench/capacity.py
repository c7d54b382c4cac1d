"""Measure the shard buffer a configuration needs: the largest relation any
query of the named mixes builds on one shard, before the executor's ``cap``
bounds it.

    python3 -m odyssey_bench.capacity --config fedbench-cdls \
        --traffic cdls-queries.closed --seeds 1 2 3 --cap 524288

Runs every query of each mix's pool and warm-up pool once per seed through
the port's planner and SPMD executor at ``--cap``, with the operators that
bound a relation wrapped to record the rows they were asked to hold: pattern
scans (``compact``), joins (``merge_join``) and the exchange's buckets
(rows a shard sends to one peer, times the model axis).  Prints one JSON
line per seed and the largest over all.  A tool for sizing a configuration;
the benchmark's runs never call it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--cap", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, help="rehearse small: the configuration's scale")
    ap.add_argument("--object-hub", type=float,
                    help="rehearse small: the configuration's object_hub")
    ap.add_argument("--only", nargs="*", default=None,
                    help="run only these queries, as <traffic>:<name> (the largest "
                         "ones of an earlier seed: seeds only rename terms)")
    args = ap.parse_args(argv)

    from odyssey_bench.harness import BENCH, make_inputs
    from odyssey_bench.system import PortSystem, _import_program

    cfg = json.loads((BENCH / "configs" / f"{args.config}.json").read_text())
    cfg["cap"] = args.cap
    if args.scale is not None:
        cfg["scale"] = args.scale
    if args.object_hub is not None:
        cfg["object_hub"] = args.object_hub
    mixes = [json.loads((BENCH / "traffic" / f"{t}.json").read_text())
             for t in args.traffic]

    import torch
    _import_program()
    from repro_torch.engine import distributed, operators

    need = {"scan": 0, "join": 0, "bucket": 0}
    compact, merge_join, join = operators.compact, operators.merge_join, \
        distributed.DistributedEngine._join

    def rec(kind, n):
        need[kind] = max(need[kind], int(n))

    def w_compact(mask, cap):
        rec("scan", mask.sum(-1).max())
        return compact(mask, cap)

    def w_merge_join(left, lvalid, lkey, right, rvalid, rkey, cap):
        _, _, _, offsets = operators._probe(left, lvalid, lkey, right, rvalid, rkey,
                                            lambda lv, counts: counts)
        rec("join", offsets[..., -1].max())
        return merge_join(left, lvalid, lkey, right, rvalid, rkey, cap)

    def w_join(self, left, right, join_vars, metrics):
        key = left.data[..., left.columns.index(join_vars[0])] % self.m
        for j in range(self.m):
            rec("bucket", ((key == j) & left.valid).sum(-1).max() * self.m)
        return join(self, left, right, join_vars, metrics)

    operators.compact = w_compact
    operators.merge_join = w_merge_join
    distributed.DistributedEngine._join = w_join
    worst = dict(need)
    for seed in args.seeds:
        t0 = time.perf_counter()
        seed_need = dict(scan=0, join=0, bucket=0)
        overflowed = 0
        queries = []
        for traffic, mix in zip(args.traffic, mixes):
            fd, pool, warm = make_inputs(cfg, mix, seed)
            queries += [(f"{traffic}:{q.name}", q) for q in pool]
            queries += [(f"{traffic}:warm-{q.name}", q) for q in warm]
        if args.only is not None:
            queries = [(k, q) for k, q in queries if k in args.only]
        system = PortSystem(cfg, fd, args.device)
        opt, eng = system.server.optimizer, system.engine
        seen = set()
        per_query = {}
        for key, q in queries:
            if q.patterns in seen:
                continue
            seen.add(q.patterns)
            need.update(scan=0, join=0, bucket=0)
            res = eng.execute(opt.optimize(system.query(q)))
            overflowed += bool(res.metrics.overflowed)
            per_query[key] = max(need.values())
            seed_need = {k: max(seed_need[k], need[k]) for k in need}
        system.close()
        if args.device != "cpu":
            torch.cuda.synchronize()
        worst = {k: max(worst[k], seed_need[k]) for k in need}
        top = sorted(per_query.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps(dict(seed=seed, queries=len(seen), overflowed=overflowed,
                              table_cap=system.table_cap, **seed_need, top=top,
                              seconds=time.perf_counter() - t0)), flush=True)
        del system
    pow2 = int(2 ** np.ceil(np.log2(max(worst.values()))))
    print(json.dumps(dict(worst=worst, smallest_power_of_two=pow2)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
