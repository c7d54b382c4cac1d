#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

    python3 chip_smoke.py

Each phase prints one JSON line:

``build``       compile both CUDA kernels from ``src/repro_torch/kernels/csrc``
                with nvcc for sm_90a (into the ignored ``build/kernels/``);
``kernels``     each kernel against its plain PyTorch version on the card,
                exact equality: a 12-star-clique schedule with 8 members,
                injected cost ties, exclusive seeds and source-less leaves,
                and a dense layer tile at the 20-star chain's tile shape;
``fedbench``    FedBench-like federation at scale 1.0: statistics, planning
                with the default optimizer (torch DP on cuda), execution;
                answers equal ``naive_evaluate`` and plans equal the numpy
                DP backend's;
``large_star``  the four large-star DP sweeps (12-clique B=8 and 14-clique
                B=1 resident, 20-chain B=4 and 16-tree B=8 tiled), trees
                equal the numpy backend's, with device timings.

The main path is ``fedbench`` and ``large_star`` planning and executing once,
with the launch counts set to 0 just before and read just after; their
comparisons with the numpy backend and their timings run after that read, so
their own launches are not counted.  Then the card's name and power limit,
one JSON line with every kernel's launches on the main path, error against
its plain version, time and bound, and last ``{"ok": true, "device": ...}``.
No phase catches its own failure: any failure exits non-zero.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float64 (non-tensor
# core) rate; the bound of a kernel is the larger of bytes / HBM and
# operations / FP64.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
PRICE_OPS = 10            # float64 operations to price one (pair, member)

LARGE_STAR = (("clique", 12, 8, "resident"), ("clique", 14, 1, "resident"),
              ("chain", 20, 4, "tiled"), ("tree", 16, 8, "tiled"))
SHAPE_SEED = 45


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median device time of ``fn`` in ms, from CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def max_abs_err(got, want) -> float:
    """Largest |got - want| over float outputs (0 where both are inf);
    integer outputs must agree exactly."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            same = (g == w) | (torch.isnan(g) & torch.isnan(w))
            d = torch.where(same, 0.0, (g - w).abs())
            err = max(err, float(d.max()) if d.numel() else 0.0)
        elif not torch.equal(g, w):
            err = float("inf")
    return err


def sweep_bound(sched, B: int, size: int) -> "tuple[float, str]":
    """Least time for one ``dp_sweep`` call: its inputs read once (the real
    pairs of the schedule, ``col_ptr``, ``layer_cols`` and six (B, 2^n)
    float64 planes), its outputs written once (cost f64, strat and split
    i32), against pricing every real (pair, member)."""
    nbytes = (sched.n_pairs * 8 + sched.col_ptr.nbytes
              + sched.layer_cols.nbytes + B * size * (6 * 8 + 8 + 4 + 4))
    ops = sched.n_pairs * B * PRICE_OPS
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def tile_bound(args) -> "tuple[float, str]":
    """Least time for one ``dp_layer`` call: the dense tile read once, the
    (B, C) outputs written once, against pricing every valid (row, column,
    member)."""
    cost_a, valid = args[0], args[6]
    B, R, C = cost_a.shape
    nbytes = B * R * C * (5 * 8 + 1) + R * C + B * C * (8 + 8 + 4 + 1)
    ops = int((valid != 0).sum()) * B * PRICE_OPS
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def same_tree(a, b, path: str = "") -> None:
    if (a.kind, a.stars, a.cardinality, a.cost, a.sources, a.strategy) != (
            b.kind, b.stars, b.cardinality, b.cost, b.sources, b.strategy):
        raise AssertionError(f"join trees differ at {path or 'root'}: "
                             f"{a.kind}/{a.cost!r}/{a.strategy} vs "
                             f"{b.kind}/{b.cost!r}/{b.strategy}")
    if a.kind == "join":
        same_tree(a.left, b.left, path + "L")
        same_tree(a.right, b.right, path + "R")


def member_selection(sel, b: int):
    """Member-specific selections for a stacked sweep: the trims of the
    reference tests' ``_vary_sources``, and (the shaped federations have a
    single source, which those trims never touch) some stars pruned to zero
    sources, so members differ in cardinalities, bindability and exclusive
    groups."""
    from repro_torch.core.source_selection import SourceSelection

    ss = []
    for i, srcs in enumerate(sel.star_sources):
        keep = list(srcs)
        if len(srcs) > 1 and (i + b) % 3 == 0:
            keep = list(srcs[:1] if b % 2 else srcs[1:])
        elif b and (3 * i + b) % 5 == 0:
            keep = []
        ss.append(keep)
    return SourceSelection(star_sources=ss, star_cs=sel.star_cs,
                           edge_pairs=sel.edge_pairs)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_build(state: dict) -> None:
    from repro_torch.kernels import dp_layer as K

    t0 = time.perf_counter()
    built = K.build_kernels()
    secs = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in K.BUILD_LOG.items()}
    state["smi"] = nvidia_smi()
    emit("build", seconds=secs, built=built, nvidia_smi=state["smi"],
         build_dir=str(K.build_dir()), ptxas=ptxas)


def phase_kernels(state: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.core import join_order as jo
    from repro_torch.kernels import dp_layer as K
    from repro_torch.rdf.shapes import shaped_planning_inputs

    dev = torch.device(DEVICE)
    before = dict(K.LAUNCHES)

    # dp_sweep: the 12-clique schedule with 8 members, the seed recipe of
    # the reference's test_dp_sweep_resident_matches_scalar_ref
    g, _, _, _ = shaped_planning_inputs("clique", 12, seed=SHAPE_SEED)
    B, n = 8, 12
    size = 1 << n
    sched = jo._dp_schedule(g, jo.DP_BLOCK_BYTES, B)
    if not jo._resident_fits(sched, B, jo.DP_BLOCK_BYTES):
        raise AssertionError("12-clique B=8 must fit the resident budget")
    rng = np.random.default_rng(17)
    card = rng.integers(1, 5, (B, size)).astype(np.float64)
    cost0 = np.full((B, size), np.inf)
    n_src0 = np.zeros((B, size))
    src_w0 = np.ones((B, size))
    for i in range(n):
        m = 1 << i
        cost0[:, m] = rng.integers(1, 6, B)
        n_src0[:, m] = rng.integers(0, 3, B)          # source-less leaves
        src_w0[:, m] = rng.choice([1.0, 1.5], B)
    excl_cost = np.full((B, size), np.inf)
    excl_w = np.ones((B, size))
    conn = sched.layer_cols[sched.layer_cols < size]
    pick = rng.choice(conn, 400, replace=False)
    excl_cost[:, pick] = rng.integers(1, 8, (B, len(pick)))
    excl_w[:, pick] = rng.choice([1.0, 2.0], (B, len(pick)))
    t = [torch.from_numpy(x).to(dev) for x in (card, excl_cost, excl_w,
                                                cost0, n_src0, src_w0)]
    params = (1.0, 1.0, 5.0, 20)
    sargs = (params, *sched.device_arrays(dev), *t)
    got = K.dp_sweep(*sargs)
    want = K.dp_sweep_plain(*sargs)
    torch.cuda.synchronize()
    sweep_err = max_abs_err(got, want)
    if sweep_err != 0.0:
        raise AssertionError(f"dp_sweep differs from its plain version: "
                             f"{sweep_err}")
    if int((got[1] != 0).sum()) == 0:
        raise AssertionError("dp_sweep wrote no subset")

    # dp_layer: one dense tile at the 20-chain's (B=4) largest tile shape
    tile_elems = max(jo.DP_BLOCK_BYTES // (jo._PAIR_BYTES * 4),
                     jo.MIN_TILE_ELEMS)
    R = min((1 << 20) - 2, tile_elems)
    C = max(1, tile_elems // max(R, 20))
    Bt = 4
    shp = (Bt, R, C)
    tile = (rng.integers(1, 9, shp).astype(np.float64),
            rng.integers(1, 9, shp).astype(np.float64),
            rng.integers(0, 50, shp).astype(np.float64),
            rng.integers(0, 3, shp).astype(np.float64),
            rng.choice([1.0, 1.5], shp),
            (rng.random(shp) < 0.5).astype(np.int8),
            (rng.random((R, C)) < 0.7).astype(np.int8),
            rng.integers(0, 9, (Bt, C)).astype(np.float64))
    targs = tuple(torch.from_numpy(x).to(dev) for x in tile)
    got = K.dp_layer(*targs, params)
    want = K.dp_layer_plain(*targs, params)
    torch.cuda.synchronize()
    layer_err = max_abs_err(got, want)
    if layer_err != 0.0:
        raise AssertionError(f"dp_layer differs from its plain version: "
                             f"{layer_err}")
    state["err"] = {"dp_sweep": sweep_err, "dp_layer": layer_err}
    emit("kernels", dp_sweep={"shape": "clique12", "B": B,
                              "pairs": sched.n_pairs, "max_abs_err": sweep_err},
         dp_layer={"tile": list(shp), "max_abs_err": layer_err},
         launches={k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES})


def phase_fedbench(state: dict) -> None:
    """The main path on FedBench: plan every query with the default
    optimizer, execute it, and hold its answers against the oracle.  The
    plan comparisons with the numpy backend run later, in
    ``check_fedbench``, outside the counted window."""
    from repro_torch.core import join_order as jo
    from repro_torch.core.federation import build_federated_stats
    from repro_torch.core.planner import OdysseyOptimizer
    from repro_torch.engine.local import LocalEngine, naive_evaluate
    from repro_torch.rdf.generator import (fedbench_like_spec,
                                           generate_federation,
                                           generate_workload)

    t0 = time.perf_counter()
    fed, gt = generate_federation(fedbench_like_spec(scale=1.0))
    stats = build_federated_stats(fed)
    queries = generate_workload(fed, gt, seed=5)
    t_setup = time.perf_counter() - t0
    before = dict(jo.DP_SWEEP_COUNTERS)
    opt = OdysseyOptimizer(stats)                     # torch DP on cuda
    if (opt.dp_backend, opt.device) != ("torch", DEVICE):
        raise AssertionError("the default optimizer must run on cuda")
    eng = LocalEngine(fed)
    ntt = answers = 0
    t_plan = t_exec = 0.0
    plans = []
    for q in queries:
        t1 = time.perf_counter()
        plan = opt.optimize(q)
        t_plan += time.perf_counter() - t1
        plans.append(plan)
        t1 = time.perf_counter()
        res = eng.execute(plan)
        t_exec += time.perf_counter() - t1
        rel = res.rows
        proj = q.effective_projection()
        nrow = len(next(iter(rel.values()))) if rel else 0
        got = set(zip(*[rel[v].tolist() for v in proj])) if nrow else set()
        if got != naive_evaluate(fed, q):
            raise AssertionError(f"{q.name}: answers differ from the oracle")
        ntt += res.metrics.transferred_tuples
        answers += len(got)
    delta = {k: jo.DP_SWEEP_COUNTERS[k] - before[k]
             for k in ("resident", "tiled")}
    if delta["resident"] + delta["tiled"] == 0:
        raise AssertionError("no FedBench query reached the device DP")
    state["fedbench_run"] = (stats, queries, opt, plans)
    state["fedbench"] = dict(
        sources=len(fed.sources), triples=fed.total_triples(),
        queries=len(queries), answers=answers, ntt=ntt, sweeps=delta,
        setup_s=t_setup, plan_s=t_plan, exec_s=t_exec)


def check_fedbench(state: dict) -> None:
    """Every FedBench plan of the main path against the numpy backend's:
    the physical plan, and the join tree of ``dp_join_order`` on both
    backends (kind, stars, cardinality, cost, sources, strategy,
    recursively).  Its own sweeps on the card are not main-path launches."""
    from repro_torch.core import join_order as jo
    from repro_torch.core.decomposition import decompose
    from repro_torch.core.planner import OdysseyOptimizer
    from repro_torch.core.source_selection import select_sources

    stats, queries, opt, plans = state.pop("fedbench_run")
    opt_np = OdysseyOptimizer(stats, dp_backend="numpy")
    for q, plan in zip(queries, plans):
        if plan.root != opt_np.optimize(q).root:
            raise AssertionError(f"{q.name}: plan differs from numpy backend")
        g = decompose(q)
        sel = select_sources(g, stats)
        same_tree(jo.dp_join_order(g, stats, sel, opt.cost_model, q.distinct),
                  jo.dp_join_order(g, stats, sel, opt.cost_model, q.distinct,
                                   dp_backend="numpy"), q.name)
    emit("fedbench", **state["fedbench"])


class _Recorder:
    """Wraps the kernel wrappers the planner calls to keep their inputs
    (for replays) and, when ``timing`` is on, to time each call's kernel
    and its plain version on the same inputs with CUDA events."""

    def __init__(self, K):
        self.K = K
        self.real = (K.dp_sweep, K.dp_layer)
        self.sweeps: list = []
        self.tiles: list = []
        self.timing = False
        self.n_tiles = 0
        self.kernel_ms = self.plain_ms = 0.0
        self.err = 0.0

    def install(self) -> None:
        self.K.dp_sweep, self.K.dp_layer = self._sweep, self._layer

    def remove(self) -> None:
        self.K.dp_sweep, self.K.dp_layer = self.real

    def _timed(self, kernel, plain, args):
        import torch

        if not self.timing:
            return kernel(*args)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        out = kernel(*args)
        ev[1].record()
        ev[2].record()
        ref = plain(*args)
        ev[3].record()
        ev[3].synchronize()
        self.kernel_ms += ev[0].elapsed_time(ev[1])
        self.plain_ms += ev[2].elapsed_time(ev[3])
        self.err = max(self.err, max_abs_err(out, ref))
        return out

    def _sweep(self, *args):
        self.sweeps.append(args)
        return self._timed(self.real[0], self.K.dp_sweep_plain, args)

    def _layer(self, *args):
        big = max(self.tiles, key=lambda a: a[0].numel(), default=None)
        if big is None or args[0].numel() > big[0].numel():
            self.tiles = [args]                 # keep the largest tile only
        self.n_tiles += 1
        return self._timed(self.real[1], self.K.dp_layer_plain, args)


def _plan_large_star(case, backend: str = "torch"):
    from repro_torch.core import join_order as jo
    from repro_torch.core.cost import CostModel

    _, _, B, _, g, stats, sels, q = case
    return jo.dp_join_order_batch([g] * B, stats, sels, CostModel(),
                                  q.distinct, dp_backend=backend)


def phase_large_star(state: dict) -> None:
    """The main path on the large stars: each sweep once on the card, in
    the mode the budget decides.  Checks and timings run later, in
    ``check_large_star``, outside the counted window."""
    from repro_torch.core import join_order as jo
    from repro_torch.kernels import dp_layer as K
    from repro_torch.rdf.shapes import shaped_planning_inputs

    cases = []
    for shape, n, B, mode in LARGE_STAR:
        g, stats, sel, q = shaped_planning_inputs(shape, n, seed=SHAPE_SEED)
        sels = [member_selection(sel, b) for b in range(B)]
        cases.append((shape, n, B, mode, g, stats, sels, q))

    runs = []
    for case in cases:
        shape, n, B, mode = case[:4]
        rec = _Recorder(K)
        rec.install()
        before = dict(jo.DP_SWEEP_COUNTERS)
        l0 = dict(K.LAUNCHES)
        try:
            trees = _plan_large_star(case)
        finally:
            rec.remove()
        launches = {k: K.LAUNCHES[k] - l0[k] for k in K.LAUNCHES}
        ran = {k: jo.DP_SWEEP_COUNTERS[k] - before[k]
               for k in ("resident", "tiled")}
        if ran[mode] != 1 or sum(ran.values()) != 1:
            raise AssertionError(f"{shape}{n} B={B}: expected one {mode} "
                                 f"sweep, counters moved {ran}")
        kname = "dp_sweep" if mode == "resident" else "dp_layer"
        if launches[kname] == 0:
            raise AssertionError(f"{shape}{n}: {kname} never launched")
        runs.append((case, trees, rec, launches))
    state["large_star_runs"] = runs


def check_large_star(state: dict) -> None:
    """Each large-star plan of the main path against the numpy backend's,
    then the timings: the planning call, its kernel and the kernel's plain
    version on the inputs the main path gave it (CUDA events)."""
    import torch

    from repro_torch.core import join_order as jo
    from repro_torch.kernels import dp_layer as K

    rows = []
    for case, trees, rec, launches in state.pop("large_star_runs"):
        shape, n, B, mode, g = case[:5]
        trees_np = _plan_large_star(case, "numpy")
        for b, (t_dev, t_np) in enumerate(zip(trees, trees_np)):
            same_tree(t_dev, t_np, f"{shape}{n}[{b}]")
        if len({repr(t.cost) for t in trees}) < min(B, 2):
            raise AssertionError(f"{shape}{n}: members did not differ")
        torch.cuda.reset_peak_memory_stats()
        sweep_ms = cuda_ms(lambda: _plan_large_star(case), reps=3)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        _plan_large_star(case, "numpy")
        numpy_ms = (time.perf_counter() - t0) * 1e3
        row = {"case": f"{shape}{n}", "B": B, "mode": mode,
               "plan_ms": sweep_ms, "numpy_plan_ms": numpy_ms,
               "launches": launches, "peak_device_bytes": peak}
        if mode == "resident":
            args = rec.sweeps[0]
            sched = jo._dp_schedule(g, jo.DP_BLOCK_BYTES, B)
            kms = cuda_ms(lambda: K.dp_sweep(*args))
            pms = cuda_ms(lambda: K.dp_sweep_plain(*args))
            err = max_abs_err(K.dp_sweep(*args), K.dp_sweep_plain(*args))
            bound, by = sweep_bound(sched, B, 1 << n)
            # the DP state on the card: six seed planes in, the working
            # cost/n_src/src_w copies (float64) and strat/split (int32)
            row.update(kernel_ms=kms, plain_ms=pms, max_abs_err=err,
                       bound_ms=bound, bound_by=by, pairs=sched.n_pairs,
                       device_busy_share=kms / sweep_ms,
                       schedule_bytes=sum(int(a.numel() * a.element_size())
                                          for a in args[1:5]),
                       state_bytes=B * (1 << n) * (9 * 8 + 2 * 4))
        else:
            timer = _Recorder(K)
            timer.timing = True
            timer.install()
            try:
                _plan_large_star(case)
            finally:
                timer.remove()
            big = rec.tiles[0]
            kms = cuda_ms(lambda: K.dp_layer(*big))
            pms = cuda_ms(lambda: K.dp_layer_plain(*big))
            err = max(timer.err, max_abs_err(K.dp_layer(*big),
                                             K.dp_layer_plain(*big)))
            bound, by = tile_bound(big)
            row.update(tiles=timer.n_tiles, kernel_ms_sum=timer.kernel_ms,
                       plain_ms_sum=timer.plain_ms, max_abs_err=err,
                       device_busy_share=timer.kernel_ms / sweep_ms,
                       largest_tile=list(big[0].shape), kernel_ms=kms,
                       plain_ms=pms, bound_ms=bound, bound_by=by)
        if err != 0.0:
            raise AssertionError(f"{shape}{n}: kernel differs from its "
                                 f"plain version by {err}")
        rows.append(row)
    state["large_star"] = {r["case"]: r for r in rows}
    emit("large_star", nvidia_smi=state["smi"], sweeps=rows)


def summary(state: dict) -> dict:
    ls = state["large_star"]
    sweep, tile = ls["clique12"], ls["chain20"]
    err = state["err"]
    return {"kernels": [
        {"name": "dp_sweep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dp_sweep.cu",
         "replaces": "src/repro/kernels/dp_layer.py:267",
         "launches": state["main_launches"]["dp_sweep"],
         "max_abs_err": max(err["dp_sweep"], sweep["max_abs_err"]),
         "ms": sweep["kernel_ms"], "plain_ms": sweep["plain_ms"],
         "bound_ms": sweep["bound_ms"], "bound_by": sweep["bound_by"],
         "library_ms": None},
        {"name": "dp_layer", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dp_layer.cu",
         "replaces": "src/repro/kernels/dp_layer.py:183",
         "launches": state["main_launches"]["dp_layer"],
         "max_abs_err": max(err["dp_layer"], tile["max_abs_err"]),
         "ms": tile["kernel_ms"], "plain_ms": tile["plain_ms"],
         "bound_ms": tile["bound_ms"], "bound_by": tile["bound_by"],
         "library_ms": None},
    ]}


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import join_order as jo
    from repro_torch.kernels import dp_layer as K

    state: dict = {}
    phase_build(state)
    phase_kernels(state)
    # the main path: counts set to 0 just before, read just after; the
    # checks against the numpy backend and the timings come after the read
    K.reset_launches()
    for k in jo.DP_SWEEP_COUNTERS:
        jo.DP_SWEEP_COUNTERS[k] = 0
    phase_fedbench(state)
    phase_large_star(state)
    state["main_launches"] = dict(K.LAUNCHES)
    for k, v in state["main_launches"].items():
        if v == 0:
            raise AssertionError(f"{k} was never launched on the main path")
    check_fedbench(state)
    check_large_star(state)
    print(state["smi"], flush=True)
    print(json.dumps(summary(state)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
