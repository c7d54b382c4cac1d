#!/usr/bin/env python3
"""Tabulate the port's dry-run beside the reference's, cell by cell.

    python3 scripts/dryrun_compare.py PORT.json REFERENCE.json

``PORT.json`` is ``python -m repro_torch.launch.dryrun --arch all --mesh
both``'s output, ``REFERENCE.json`` the reference dry-run's
(``python -m repro.launch.dryrun`` on the same flags).  Prints one markdown
row per (architecture, shape) with both meshes in each column ("single /
multi"): per-device flops, HBM bytes and collective bytes (the port's, then
the reference's), the bottleneck and the useful-flops fraction of each, and
the port's trace time.  Then the port's FP32-pipe kernel work (the
selective scan's, priced apart at 67 TFLOP/s in the compute term), and for
every cell where a count differs by more than 2x, the port's ops that carry
it: the op with the most HBM bytes and the collective kinds with their
bytes.  Reads JSON only.
"""
from __future__ import annotations

import json
import sys

METRICS = (("flops_per_dev", "flops"), ("hbm_bytes_per_dev", "HBM"),
           ("collective_bytes_per_dev", "coll"))


def _num(x) -> str:
    return f"{x:.3g}"


def _pair(port: dict, ref: dict, key: str) -> str:
    return f"{_num(port[key])} ({_num(ref[key])})"


def _ratio(a: float, b: float) -> float:
    if a == b:
        return 1.0
    if min(a, b) <= 0:
        return float("inf")
    return max(a, b) / min(a, b)


def main(argv) -> int:
    port = json.load(open(argv[1]))
    ref = json.load(open(argv[2]))
    # the acceptance counts: statuses, skip reasons, useful flops
    same_status = all(port.get(k, {}).get("status") == v["status"]
                      and port[k].get("reason") == v.get("reason")
                      for k, v in ref.items())
    same_flops = all(port.get(k, {}).get("model_flops_total")
                     == v["model_flops_total"]
                     for k, v in ref.items() if v["status"] == "ok")
    count = {s: sum(r.get("status") == s for r in port.values())
             for s in ("ok", "skipped", "error")}
    print(f"cells: port {count}, reference {len(ref)}; statuses and skip "
          f"reasons equal: {same_status}; model_flops_total equal: "
          f"{same_flops}\n")
    cells = sorted({k.rsplit("|", 1)[0] for k in port})
    print("| Cell | flops/dev, port (ref) | HBM B/dev, port (ref) | "
          "collective B/dev, port (ref) | bottleneck, port (ref) | "
          "useful fraction, port (ref) | trace s |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    notes, skipped = [], {}
    for cell in cells:
        pair = [port.get(f"{cell}|{m}", {}) for m in ("single", "multi")]
        if all(p.get("status") == "skipped" for p in pair):
            skipped.setdefault(pair[0]["reason"], []).append(cell)
            continue
        cols = {k: [] for k in ("flops", "HBM", "coll", "bn", "uf", "t")}
        for mesh in ("single", "multi"):
            key = f"{cell}|{mesh}"
            p, r = port.get(key, {}), ref.get(key, {})
            if p.get("status") != "ok" or r.get("status") != "ok":
                for c in cols.values():
                    c.append(p.get("status", "missing"))
                continue
            for field, short in METRICS:
                cols[short].append(_pair(p, r, field))
                if _ratio(p[field], r[field]) > 2:
                    coll = ", ".join(f"{k} {_num(v)}" for k, v in
                                     sorted(p["by_collective"].items(),
                                            key=lambda kv: -kv[1]))
                    rcoll = ", ".join(f"{k} {_num(v)}" for k, v in
                                      sorted(r["by_collective"].items(),
                                             key=lambda kv: -kv[1]))
                    top = next(iter(p.get("top_ops", {}).get("bytes", {})), "")
                    topf = next(iter(p.get("top_ops", {}).get("flops", {})), "")
                    notes.append(f"- {key} {short}: {_num(p[field])} against "
                                 f"{_num(r[field])}; port top bytes {top}, top "
                                 f"flops {topf}; port collectives {coll}; "
                                 f"reference {rcoll}")
            cols["bn"].append(f"{p['bottleneck']} ({r['bottleneck']})")
            cols["uf"].append(f"{p['useful_flops_fraction']:.3g} "
                              f"({r['useful_flops_fraction']:.3g})")
            cols["t"].append(f"{p['compile_s']:.1f}")
        print(f"| {cell} | " + " | ".join(" / ".join(cols[k]) for k in
                                          ("flops", "HBM", "coll", "bn", "uf", "t"))
              + " |")
    for reason, which in skipped.items():
        print(f"| {', '.join(which)} | skipped on both meshes: {reason} "
              f"| | | | | |")
    print()
    # the port's FP32-pipe kernel work (the scan's), not in flops/dev
    for key in sorted(port):
        p = port[key]
        if p.get("fp32_flops_per_dev"):
            print(f"- {key} fp32: {_num(p['fp32_flops_per_dev'])} FP32-pipe "
                  f"instructions a device, {_num(p['fp32_flops_per_dev'] / 67e12)} s "
                  f"of its {_num(p['compute_s'])} s compute term")
    print()
    print("\n".join(notes))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
