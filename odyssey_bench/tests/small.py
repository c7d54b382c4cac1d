"""The cells at a size the CPU runs in seconds: the same configurations and
mixes with a small scale, links and properties drawn onto fewer targets (so
that every FedBench query still has instances at that scale), a small shard
buffer, and two instances of each query (one to warm up)."""
import json

from odyssey_bench.harness import BENCH

CELLS = ("cdls.queries.closed", "ls.queries.closed")
SCALE = {"cdls.queries.closed": 0.001, "ls.queries.closed": 0.001}


def overrides(workload: str) -> dict:
    traffic = workload.split(".", 1)[0] + "-queries.closed"
    mix = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    return {"scale": SCALE[workload], "object_hub": 16, "cap": 4096,
            "pool": {"queries": [{**q, "count": 2} for q in mix["pool"]["queries"]]},
            "warm": {"queries": [{**q, "count": 1} for q in mix["warm"]["queries"]]}}


def run_small(workload: str, seed: int = 2**31 + 77, seconds: float = 1.0, **kw) -> dict:
    import torch

    from odyssey_bench.harness import run_cell

    # test workers run side by side: one thread each keeps them from
    # crowding the cores
    torch.set_num_threads(1)
    kw.setdefault("log", lambda *a: None)
    kw.setdefault("grace_s", 5.0)
    return run_cell(workload, seed, seconds, kw.pop("trace", False), device="cpu",
                    overrides=overrides(workload), **kw)
