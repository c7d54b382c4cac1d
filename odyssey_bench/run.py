"""Run one cell of the benchmark once and print its result line.

    python3 -m odyssey_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program under ``src/``.  Loads, warms up, serves the cell's traffic for
``--seconds``, checks every answer against the reference and prints one
JSON line, last on standard output.  Needs as many CUDA cards as the cell
asks for; without them it exits with code 3 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (0 where /proc is missing)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    t_start = time.perf_counter() - _process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from odyssey_bench.harness import ROOT, cell_inputs, forbidden_modules, load_benchmark, run_cell

    build = ROOT / "build"
    # every cache of the program inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")

    bench = load_benchmark()
    cell = cell_inputs(bench, args.workload)[0]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"error: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", process_start=t_start, bench=bench)
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
