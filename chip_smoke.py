#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

    python3 chip_smoke.py

Each phase prints one JSON line:

``analysis``    the port's static analyzer (``repro_torch.analysis``) over its
                default paths in this checkout (``src/repro_torch``,
                ``chip_smoke.py``, ``scripts``): files, active and
                suppressed findings per rule; any active finding (or a
                stale baseline entry) fails the run.  Host code only: it
                launches no kernel;
``build``       compile the ten CUDA kernels from ``src/repro_torch/kernels/csrc``
                with nvcc for sm_90a (into the ignored ``build/kernels/``),
                one nvcc per source, all started together;
``kernels``     each kernel against its plain PyTorch version on the card,
                exact equality: a 12-star-clique schedule with 8 members,
                injected cost ties, exclusive seeds and source-less leaves,
                and a dense layer tile at the 20-star chain's tile shape for
                the DP kernels; for the four statistics kernels, inputs at
                or above the ``stats`` phase's largest extents and ragged
                ones (ties, duplicate build keys, empty lists, ``seg = -1``
                rows; ``seg_bitmap``'s rows in and out of segment order,
                each call's path read back and held to the rows' order;
                ``summary_probe`` in both its forms and on rows off a
                16-byte boundary);
``fedbench``    FedBench-like federation at scale 1.0: statistics, planning
                with the default optimizer (torch DP on cuda), execution
                through the operator pipeline; answers equal
                ``naive_evaluate``, plans equal the numpy DP backend's, and
                rows and metrics equal the recursive evaluator's (timed
                beside it);
``query_serve`` the reference's query-serving scenario
                (``benchmarks/serve_bench.py``) on the ``fedbench`` phase's
                federation and statistics: 96 instances of its 6-8-star
                subject-bound chain templates (each template kept when its
                first instance's execution makes no more endpoint scans
                than it has triple patterns), planned by the numpy backend
                in an ``optimize`` loop (the oracle) and on the card in
                ``optimize_batch`` calls of 16, every plan equal to the
                oracle's; then the same open-loop trace served twice on the
                card by ``QueryServeEngine``, arrival-order drain
                (synchronous) and affinity admission with the planner
                thread, rows byte-equal between the runs and answers equal
                to ``naive_evaluate``; outside the counted window each
                run's batches replayed on the card and on the numpy
                backend, one batch split on the host clock, and
                ``dp_sweep`` at the largest stacked group against its
                plain version;
``large_star``  the four large-star DP sweeps (12-clique B=8 and 14-clique
                B=1 resident, 20-chain B=4 and 16-tree B=8 tiled), trees
                equal the numpy backend's, with device timings;
``stats``       the statistics path on a FedBench-like federation at scale
                100 (11.1 M triples): per source, the device CS signatures
                and predicate bitmaps against the host CS statistics; then
                ``compute_federated_cps_ops`` for every ordered source pair:
                its signature probe against ``candidate_cs_pairs`` and its
                federated CP counts, through ``intersect_counts`` and
                through ``match_counts_segments`` (one launch each per
                source pair), against ``build_federated_stats``'s;
                then, outside the counted window, each statistics kernel
                against its plain version on its largest main-path input
                (for the two list kernels the largest source pair's
                launch, every pair's launch timed and summed, and one
                single-list call), with device times of calls queued back
                to back; ``seg_bitmap`` also on the main path's rows
                shuffled, ``summary_probe`` also on a 1000 x 600 block of
                512 words, beside the launch floor (a queued
                ``torch.cuda._sleep(0)``), each row naming the path or
                form that ran; and Algorithm 1 once more, split on the
                host clock into its probe calls, pair building, exact
                checks, CP tables and the rest;
``baselines``   the paper's comparison (``benchmarks/common.py``) on its own
                fixture, FedBench scale 1.0 (seed 7) and 25 queries: each
                query enters as SPARQL text (``parse_sparql`` of its
                serialization, equal to the query), and all eight engines
                of ``make_optimizers`` (Odyssey, FedX cold and warm,
                HiBISCuS, DP-VOID, SPLENDID, Odyssey-FedX, FedX-Odyssey;
                the two DP engines on their defaults, the torch DP on cuda)
                plan and execute it once through ``LocalEngine``; every
                answer equals ``naive_evaluate``, each engine's NTT equals
                the reference's, and (outside the counted window) the two
                DP engines' plans equal the numpy backend's; one line per
                engine: optimization time, NSS, NSQ, NTT, requests, ASK
                count, execution time;
``failover``    on the same federation, every source a ``FlakySource`` and
                every session planning on its defaults (cuda): (a) one
                transient failure per source, retried; (b) the hub
                ``DBpedia`` dead, salvaged mid-query; (c) the same with
                exclude-and-replan (the replans sweep on the card); (d) the
                hub dying mid-scan inside ``execute_batch`` over the 25
                queries (completed results kept, the rest replanned in one
                ``optimize_batch``); (e) the hub restored; answers equal
                ``naive_evaluate`` over the whole federation or the
                survivors, as each result's ``partial`` says; outside the
                window the whole scenario again on the numpy backend, every
                plan and replan equal;
``spmd``        the SPMD federation executor (``DistributedEngine``) with the
                whole ``(9, 4)`` mesh resident on the card (one FedBench
                source per data shard, each source's triples hash-partitioned
                by subject over 4 model shards): (a) the ``fedbench``
                phase's federation and card plans at ``cap`` 4096, the build
                side gathered over the whole mesh and then partition-aware;
                (b) FedBench at scale 10 (1,068,934 triples, tables
                ``(9, 4, 131072, 3)`` int32), its 25 queries planned on the
                card, ``cap`` 32768, partition-aware; (c) the ``baselines``
                phase's Odyssey plans at ``cap`` 4096, partition-aware.
                Each plan runs twice (equal results); no result overflows,
                the answers of (a) and (c) equal ``naive_evaluate``, and
                outside the counted window the rows (order, dtype) and
                ``DistMetrics`` of (a) and (b) equal the CPU port's at the
                same mesh and ``cap``.  One line per cell: table bytes,
                transferred tuples, collective bytes, skipped plans, warm
                times per query (host clock closed by a sync) beside the
                host engine's on the same plans for (a) and (c), host syncs
                per query, peak device memory, and for (a)'s partition-aware
                run and (b) a ``torch.profiler`` pass (device busy share,
                the operators and kernels with the most device time);
``lm``          LM serving at full published width, float32, TF32 off:
                ``qwen2-0.5b`` (24 layers, 494 M params; 8 requests of
                512-3072 prompt tokens, 32 new each, on 4 slots of a 4096
                cache) and ``falcon-mamba-7b`` (64 layers, 7.27 G params,
                29.1 GB; 4 requests of 256-1024 tokens, 16 new each, on 2
                slots), weights drawn on the card from a seeded generator,
                through ``ServeEngine`` with prefill admission: the flash
                attention kernel in every qwen2 prefill layer, the
                selective-scan kernel in every falcon-mamba one.  Then,
                outside the counted window, the shortest and longest request
                of each again token by token (plain decode), tokens and
                logits held to the prefill run's, and each LM kernel against
                its plain version at the main path's full-width shapes, with
                device times, bounds and a library yardstick; the scan also
                at the longest prompt;
``lm_zoo``      the rest of the zoo at full published width, float32, TF32
                off, one run at a time, depth cut only where 80 GB force it
                (``depth_cut`` says why): (a) ``phi3.5-moe-42b-a6.6b``, 8
                of 32 layers, and (b) ``deepseek-v2-236b``, 4 of 60 (the
                dense layer 0 and 3 MoE layers, MLA), served with prefill
                admission; (c) ``chameleon-34b``, 8 of 48, ``forward`` on
                1 x 2,048 tokens with patch embeddings over its 1,024-position
                prefix, then text-only serving; (d) ``whisper-tiny`` in
                full, the enc-dec ``forward`` on 2 x 1,500 frames (the
                flash kernel non-causal in the encoder) and token-by-token
                serving; (e) ``qwen2-0.5b`` with the int8 KV cache, the
                ``lm`` phase's first 4 requests.  Each run's window holds
                its forward and serving; flash and scan launches must equal
                the layers of their kind times the prefills and forwards.
                Then, outside it: the same requests with both kernels
                routed to their plain versions (a, b, c, e) and (b)'s
                absorbed MLA decode, each under the near-tie rule; (c) and
                (d)'s forward on the plain path within the logit
                tolerance; each MoE layer's dropped assignments on the
                longest prompt; the KV-cache bytes; and the flash kernel
                against its plain version at (a)'s hd 128 (causal) and (d)'s
                encoder shape (non-causal, hd 64), with times, bounds and
                SDPA's;
``train``       LM training at full published width, float32, TF32 off,
                weights drawn on the card from a seeded generator, through
                the port's launcher (``repro_torch.launch.train``): (a)
                ``qwen2-0.5b`` (24 layers, 494 M params), AdamW, remat,
                batch 4 x 512 tokens, 8 steps, a checkpoint at steps 4 and
                8; (b) ``falcon-mamba-7b`` at full width cut to 8 of its 64
                layers (1.38 G params; ``depth_cut`` says why), Adafactor,
                two microbatches, int8 gradient compression, batch 2 x 512,
                6 steps.  Every attention layer runs the flash kernel and its
                backward kernel, every Mamba layer the scan and its backward
                kernel.  Then, outside the counted window: the launches
                against what remat predicts (two forwards and one backward
                per layer and microbatch step), finite losses whose last
                three steps beat the first three, (a) restarted from its
                step-4 checkpoint with steps 4-7 replayed (``rtol`` 1e-5),
                (b) trained again with both kernels routed to their plain
                versions (each step's loss within 1e-3 relative), one
                step's gradients of the kernel path against the plain
                path per leaf (within 1e-3 of each leaf's largest; (a) at
                full depth, (b) at 2 layers of full width; every leaf
                gets one), and each backward kernel against autograd through
                its plain version at the main path's shapes, two launches
                bit-identical, with device times, bounds, (flash) the
                time of ``scaled_dot_product_attention``'s backward, and
                one ``torch.profiler`` pass over a single call of each
                (``launch_split``: every device kernel the call launches,
                in launch order, with its device time).
``dryrun``      the port's dry-run (``repro_torch.launch.dryrun``) and the
                federated step at its sizes: (a) five cells traced on fake
                tensors in processes of their own -- the federated query
                step on the ``(16, 16)`` and ``(2, 16, 16)`` meshes, and
                ``qwen2-0.5b``, ``falcon-mamba-7b`` and
                ``phi3.5-moe-42b-a6.6b`` at ``decode_32k`` on ``(16, 16)``
                (DTensor over a fake process group; ``torch.__version__`` is
                printed, since the fake group is PyTorch's internal module)
                -- each with its three roofline terms and bottleneck on H100
                peaks; (b) the federated step for real on the ``(16, 16)``
                mesh resident on the card, ``cap`` 8192, ``table_cap`` 2^20
                (3.2 GB of triples drawn from ``FED_SEED``, 268 MB of row
                flags), its rows, overflow and shipped counts, its warm time
                beside the trace's one-card bound (the per-device HBM bytes
                times 256 over 3.35 TB/s), and the same step at ``table_cap``
                2^16 on the card and on the CPU, every output equal; (c)
                flash attention and the scan traced at the ``lm_kernels``
                shapes, their booked work and bytes equal to that line's
                (flash's as tensor-core flops, the scan's as FP32-pipe
                instructions, ``fp32_flops``).

The main paths are ``fedbench``, ``query_serve``, ``large_star``,
``stats``, ``baselines``, ``failover`` and ``spmd`` running once, then
``lm``, then each ``lm_zoo`` run, then ``train``, each
window with the launch counts set to 0 just before and read just after
(``dryrun``'s step launches none of the hand-written kernels; its line
shows the counts of its window);
the kernel checks, all timings and the plan comparisons with the numpy
backend (but ``query_serve``'s, which launch nothing) run outside those
windows, so their own launches are not counted.  Then the card's name and power limit, one JSON line with every
kernel's launches on the main paths, error against its plain version, time
and bound (``dp_sweep`` at clique12 with clique14's and the serving path's
largest group's times beside it, ``dp_layer`` twice, at the largest tile of
each tiled cell), and
last ``{"ok": true, "device": ...}``.
No phase catches its own failure: any failure exits non-zero.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
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

STATS_KERNELS = (        # (kernel, the TPU kernel's pallas_call it replaces)
    ("seg_bitmap", "src/repro/kernels/seg_bitmap.py:53"),
    ("summary_probe", "src/repro/kernels/summary_probe.py:50"),
    ("sorted_intersect", "src/repro/kernels/sorted_intersect.py:48"),
    ("join_count", "src/repro/kernels/join_count.py:39"))
STATS_SCALE = 100.0       # fedbench_like_spec scale of the stats phase
INT32_MAX = 2**31 - 1

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


def queued_ms(fn, k: int = 20) -> "tuple[float, bool]":
    """Device time of one call of ``fn`` in ms: ``k`` calls queued behind a
    device-side sleep and timed with CUDA events from the sleep's end, so
    the card runs them back to back while the host's per-call work
    (argument checks, allocation, the launch) overlaps the sleep.  Returns
    ``(ms, queued)``; ``queued`` is false when the host could not enqueue
    all ``k`` calls before the sleep ended (``fn`` waits on the card, as a
    data-dependent size does), and the interval then holds host time too."""
    import torch

    fn()
    torch.cuda.synchronize()
    for cycles in (20_000_000, 200_000_000, 1_000_000_000):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        queued = host_ms < 0.9 * ev[0].elapsed_time(ev[1])
        if queued:
            break
    return ev[1].elapsed_time(ev[2]) / k, queued


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
    """Least time for one ``dp_sweep`` call: the inputs the DP function
    needs read once (the real pairs of the schedule, ``col_ptr``,
    ``layer_cols`` and six (B, 2^n) float64 planes; not the kernel's work
    list), its outputs written once (cost f64, strat and split i32),
    against pricing every real (pair, member)."""
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

def phase_analysis(state: dict) -> None:
    from repro_torch.analysis import analyze_paths, diff_baseline, load_baseline
    from repro_torch.analysis.cli import DEFAULT_BASELINE, DEFAULT_PATHS
    from repro_torch.kernels import build

    before = sum(build.LAUNCHES.values())
    t0 = time.perf_counter()
    result = analyze_paths([str(ROOT / p) for p in DEFAULT_PATHS],
                           root=str(ROOT))
    new, stale = diff_baseline(result,
                               load_baseline(str(ROOT / DEFAULT_BASELINE)))
    secs = time.perf_counter() - t0
    suppressed: dict = {}
    for f in result.suppressed:
        suppressed[f.rule] = suppressed.get(f.rule, 0) + 1
    state["analysis"] = dict(
        paths=list(DEFAULT_PATHS), files=result.files, findings=len(new),
        baselined=len(result.findings) - len(new), stale=len(stale),
        findings_by_rule=dict(sorted(result.by_rule.items())),
        suppressed=len(result.suppressed),
        suppressed_by_rule=dict(sorted(suppressed.items())),
        launches=sum(build.LAUNCHES.values()) - before, host_seconds=secs)
    emit("analysis", **state["analysis"])
    if new or stale or state["analysis"]["launches"]:
        for f in new:
            print(f.render(), file=sys.stderr)
        raise AssertionError(f"analysis: {len(new)} finding(s), {len(stale)} "
                             "stale baseline entr(y/ies)")


def phase_build(state: dict) -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_kernels()
    secs = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in build.BUILD_LOG.items()}
    spills = {k: [ln for ln in v if "spill" in ln
                  and ln.count(" 0 bytes spill") < 2] for k, v in ptxas.items()}
    state["smi"] = nvidia_smi()
    emit("build", seconds=secs, built=built, nvidia_smi=state["smi"],
         build_dir=str(build.build_dir()), ptxas=ptxas,
         spills={k: v for k, v in spills.items() if v})


def phase_kernels(state: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.core import join_order as jo
    from repro_torch.kernels import dp_layer as K
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.rdf.shapes import shaped_planning_inputs

    dev = torch.device(DEVICE)
    before = dict(LAUNCHES)

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
    got = K.dp_sweep(*sargs, **sched.device_work(dev))
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
    stats_cases = stats_kernel_cases(dev)
    state["err"] = {"dp_sweep": sweep_err, "dp_layer": layer_err,
                    **{k: v["max_abs_err"] for k, v in stats_cases.items()}}
    emit("kernels", dp_sweep={"shape": "clique12", "B": B,
                              "pairs": sched.n_pairs, "max_abs_err": sweep_err},
         dp_layer={"tile": list(shp), "max_abs_err": layer_err},
         **stats_cases,
         launches={k: LAUNCHES[k] - before[k] for k in LAUNCHES})


def _sorted_ids(rng, n: int, hi: int, unique: bool):
    import numpy as np

    if unique:
        return np.sort(rng.choice(hi, n, replace=False)).astype(np.int32)
    return np.sort(rng.integers(0, hi, n)).astype(np.int32)


def _segment_pack(lists):
    """List pairs ``(a, aw, b, bw)`` as segments of shared base arrays, in
    order: the four int32 bases and the int64 ``(a_off, a_len, b_off,
    b_len)``."""
    import numpy as np

    cols = list(zip(*lists)) or [[], [], [], []]
    base = [np.concatenate([np.asarray(x, np.int64) for x in c]).astype(
        np.int32) if c else np.zeros(0, np.int32) for c in cols]
    lens = [np.asarray([len(x) for x in cols[c]], np.int64) for c in (0, 2)]
    offs = [np.cumsum(n) - n for n in lens]
    return base, (offs[0], lens[0], offs[1], lens[1])


# seg_bitmap's row layouts beyond the main path's (``seg_layout``), with
# their plane heights
SEG_LAYOUTS = (("interspersed_pads", 3000), ("long_segment", 40),
               ("gaps", 5000), ("out_of_plane", 2000), ("sparse", 300_000),
               ("long_pad_run", 300), ("unordered", 3000))


def seg_layout(rng, case: str):
    """``(seg, bucket)`` rows of one of ``SEG_LAYOUTS``: rows in segment
    order with padding (``seg = -1``) between them, as the main path lays
    them out; one segment of 5,000 rows among short ones; runs of empty
    segments at the start, in the middle and at the end of the plane;
    ordered rows with rows past the plane and buckets outside ``[0, 128)``
    among them; gaps of 50,000 and more missing ids; a run of 5,000 pads;
    and rows in no order over several thousand rows."""
    import numpy as np

    if case == "interspersed_pads":
        seg = np.sort(rng.integers(0, 3000, 20_000))
        seg[rng.random(20_000) < 0.3] = -1
        return seg, rng.integers(0, 128, 20_000)
    if case == "long_segment":
        seg = np.sort(np.concatenate([rng.integers(0, 40, 3000),
                                      np.full(5000, 17)]))
        seg[rng.random(8000) < 0.2] = -1
        return seg, rng.integers(0, 128, 8000)
    if case == "gaps":                 # present: [700, 1500) and [3000, 3500)
        seg = np.sort(np.concatenate([rng.integers(700, 1500, 6000),
                                      rng.integers(3000, 3500, 4000)]))
        seg[rng.random(10_000) < 0.3] = -1
        return seg, rng.integers(0, 128, 10_000)
    if case == "out_of_plane":
        seg = np.sort(rng.integers(0, 2000, 12_000))
        seg[rng.random(12_000) < 0.1] = -1
        far = rng.random(12_000) < 0.05
        seg[far] = rng.integers(2000, 2**31 - 1, int(far.sum()))
        return seg, rng.integers(-3, 131, 12_000)
    if case == "sparse":               # gaps of 50,000 and more missing ids
        seg = np.sort(np.concatenate([rng.integers(0, 100, 3000),
                                      rng.integers(50_000, 50_100, 3000),
                                      rng.integers(200_000, 200_050, 3000)]))
        seg[rng.random(9000) < 0.3] = -1
        return seg, rng.integers(0, 128, 9000)
    if case == "long_pad_run":         # 5,000 pads between two segments
        seg = np.sort(rng.integers(0, 300, 8000))
        seg[1000:6000] = -1
        return seg, rng.integers(0, 128, 8000)
    if case == "unordered":
        return rng.integers(-1, 3000, 20_000), rng.integers(0, 128, 20_000)
    raise KeyError(case)


def seg_path(seg, n_seg: int) -> str:
    """The path ``seg_bitmap``'s kernel must take on the rows ``seg``:
    ``"ordered"`` when some row is in the plane and ``seg`` does not
    decrease over those rows, else ``"unordered"``."""
    inside = seg[(seg >= 0) & (seg < n_seg)]
    ordered = inside.numel() > 0 and bool((inside[1:] >= inside[:-1]).all())
    return "ordered" if ordered else "unordered"


def stats_kernel_cases(dev) -> dict:
    """The four statistics kernels against their plain versions on the card,
    exact: one case at or above the ``stats`` phase's largest extents (the
    longest objects list at scale 100, 227,110 entities, against the longest
    subjects list, 400,000; DBpedia's 3.6 M (s, p) rows over 400,000
    subjects; a 1000 x 600 signature block of 512 words)
    and ragged ones: ties, duplicate build keys, unsorted and negative
    probes, empty lists, int32 wrap-around, ``seg = -1`` and out-of-plane
    rows, ``seg_bitmap``'s rows in and out of segment order
    (``SEG_LAYOUTS``, and the large case's rows shuffled), signature blocks
    on both sides of ``summary_probe``'s form threshold with word counts of
    1, 3, 5 and 512 and rows that start off a 16-byte boundary; and the two list
    kernels segmented: 301 list pairs in one launch, a build window above
    the shared-memory budget beside staged ones, no segments."""
    import numpy as np
    import torch

    from repro_torch.kernels import join_count as JC
    from repro_torch.kernels import seg_bitmap as SB
    from repro_torch.kernels import sorted_intersect as SI
    from repro_torch.kernels import summary_probe as SP

    rng = np.random.default_rng(23)

    def up(*xs):
        return [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
                for x in xs]

    # (a, aw, b, bw): a is also join_count's probe, b its build side
    lists = [
        (_sorted_ids(rng, 227_110, 4_000_000, True),
         rng.integers(1, 100, 227_110), _sorted_ids(rng, 400_000, 4_000_000,
                                                    False),
         rng.integers(1, 100, 400_000)),
        ([5, 5, 7, 7, 7, 9, 2], [1, 2, 3, 4, 5, 6, 7],
         [2, 5, 5, 5, 7, 8, 9, 9], [1, 1, 2, 3, 5, 8, 13, 21]),
        (rng.permutation(300) - 50, rng.integers(-9, 9, 300),
         _sorted_ids(rng, 500, 250, False) - 40, rng.integers(-9, 9, 500)),
        (np.zeros(1000), np.full(1000, 2**30 + 7), np.zeros(999),
         np.full(999, 2**29 + 3)),                     # wraps int32
        ([], [], [1, 2, 3], [1, 1, 1]),
        ([1, 2, 3], [1, 1, 1], [], []),
        ([3], [2], [3], [5]),
    ]
    si_err = jc_err = 0.0
    for a, aw, b, bw in lists:
        ta, taw, tb, tbw = up(a, aw, b, bw)
        si_err = max(si_err, max_abs_err([SI.sorted_intersect(ta, taw, tb, tbw)],
                                         [SI.sorted_intersect_plain(ta, taw, tb, tbw)]))
        jc_err = max(jc_err, max_abs_err([JC.join_count(ta, tb, tbw)],
                                         [JC.join_count_plain(ta, tb, tbw)]))
    # segmented: many short list pairs (unsorted, duplicate and negative
    # keys, empty lists on either side, a wrapping pair) in one launch; a
    # build window above the shared-memory budget (unsorted probes over a
    # long build) beside staged ones; no segments at all
    short = []
    for k in range(300):
        na, nb = (0 if k % 37 == 0 else int(rng.integers(1, 400)),
                  0 if k % 41 == 0 else int(rng.integers(1, 400)))
        short.append((rng.integers(-50, 500, na), rng.integers(-9, 9, na),
                      np.sort(rng.integers(-50, 500, nb)),
                      rng.integers(-9, 9, nb)))
    short.append(lists[3])
    wide = 4 * SI.SMEM_KEYS
    batches = [short, [
        (rng.integers(0, 100_000, 3000), rng.integers(1, 9, 3000),
         _sorted_ids(rng, wide, 100_000, False), rng.integers(1, 9, wide)),
        (_sorted_ids(rng, 20_000, 100_000, False), rng.integers(1, 9, 20_000),
         _sorted_ids(rng, wide, 100_000, False), rng.integers(1, 9, wide))],
        []]
    for batch in batches:
        base, bounds = _segment_pack(batch)
        ta, taw, tb, tbw = up(*base)
        a_off, a_len, b_off, b_len = bounds
        si_err = max(si_err, max_abs_err(
            [SI.sorted_intersect_segments(ta, taw, *bounds[:2], tb, tbw,
                                          *bounds[2:])],
            [SI.sorted_intersect_segments_plain(ta, taw, *bounds[:2], tb, tbw,
                                                *bounds[2:])]))
        jc_err = max(jc_err, max_abs_err(
            [JC.join_count_segments(ta, *bounds[:2], tb, tbw, *bounds[2:])],
            [JC.join_count_segments_plain(ta, *bounds[:2], tb, tbw,
                                          *bounds[2:])]))

    n_big, n_subj = 3_600_000, 400_000
    seg_big = np.sort(rng.integers(0, n_subj, n_big))
    seg_big[rng.random(n_big) < 0.3] = -1
    seg_cases = [
        (seg_big, rng.integers(0, 128, n_big), n_subj),
        (rng.permutation(seg_big), rng.integers(0, 128, n_big), n_subj),
        (rng.integers(-3, 40, 1000), rng.integers(-2, 131, 1000), 35),
        (np.zeros(5000), np.full(5000, 7), 1),          # one hot cell
        ([], [], 10), ([0, 1], [3, 4], 0),
    ] + [(*seg_layout(rng, case), n_seg) for case, n_seg in SEG_LAYOUTS]
    sb_err = 0.0
    paths = {"ordered": 0, "unordered": 0, None: 0}
    for seg, bkt, n_seg in seg_cases:
        ts, tk = up(seg, bkt)
        got, path = SB.seg_bitmap_path(ts, tk, n_seg)
        want = None if not (len(seg) and n_seg) else seg_path(ts, n_seg)
        if path != want:
            raise AssertionError(f"seg_bitmap took its {path} path where the "
                                 f"rows call for {want}")
        paths[path] += 1
        sb_err = max(sb_err, max_abs_err([got],
                                         [SB.seg_bitmap_plain(ts, tk, n_seg)]))

    def words(n, w):
        return rng.integers(-2**31, 2**31, (n, w))

    def rows_at(n, w, shift):
        # n rows of w words starting `shift` words into a buffer on the card
        return up(words(1, n * w + shift).ravel())[0][shift:].view(n, w)

    sig_cases = [(words(1000, 512), words(600, 512)),
                 (words(7, 512), words(40, 512)),
                 (words(33, 31), words(65, 31)), (words(1, 1), words(1, 1)),
                 (words(0, 8), words(5, 8)), (words(4, 0), words(3, 0))]
    # both forms (8 x 40 and 300 x 200 below the threshold, 400 x 400
    # above it) at word counts of every parity
    sig_cases += [(words(na, w), words(nb, w)) for w in (1, 3, 5, 512)
                  for na, nb in ((8, 40), (300, 200), (400, 400))]
    sp_err = 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forms = {"warp": 0, "tiled": 0}
    for x, y in sig_cases:
        tx, ty = up(x, y)
        forms[SP.form(len(x), len(y), sms)] += 1
        sp_err = max(sp_err, max_abs_err([SP.summary_probe(tx, ty)],
                                         [SP.summary_probe_plain(tx, ty)]))
    # rows off a 16-byte boundary: one side shifted by a word, or both
    shifted = [(na, nb, w, sa, sb) for w in (3, 5, 512)
               for na, nb in ((8, 40), (400, 400))
               for sa, sb in ((1, 0), (1, 1), (2, 3))]
    for na, nb, w, sa, sb in shifted:
        tx, ty = rows_at(na, w, sa), rows_at(nb, w, sb)
        forms[SP.form(na, nb, sms)] += 1
        sp_err = max(sp_err, max_abs_err([SP.summary_probe(tx, ty)],
                                         [SP.summary_probe_plain(tx, ty)]))
    torch.cuda.synchronize()
    out = {"sorted_intersect": {"cases": len(lists), "segmented_cases":
                                len(batches), "max_abs_err": si_err},
           "join_count": {"cases": len(lists), "segmented_cases":
                          len(batches), "max_abs_err": jc_err},
           "seg_bitmap": {"cases": len(seg_cases), "max_abs_err": sb_err,
                          "ordered": paths["ordered"],
                          "unordered": paths["unordered"]},
           "summary_probe": {"cases": len(sig_cases) + len(shifted),
                             "max_abs_err": sp_err, **forms}}
    for k, v in out.items():
        if v["max_abs_err"] != 0.0:
            raise AssertionError(f"{k} differs from its plain version: "
                                 f"{v['max_abs_err']}")
    return out


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
    plans, want, exec_ms = [], [], {}
    for q in queries:
        t1 = time.perf_counter()
        plan = opt.optimize(q)
        t_plan += time.perf_counter() - t1
        plans.append(plan)
        t1 = time.perf_counter()
        res = eng.execute(plan)
        exec_ms[q.name] = (time.perf_counter() - t1) * 1e3
        t_exec += exec_ms[q.name] / 1e3
        got = answer_set(res, q)
        want.append(naive_evaluate(fed, q))
        if got != want[-1]:
            raise AssertionError(f"{q.name}: answers differ from the oracle")
        ntt += res.metrics.transferred_tuples
        answers += len(got)
    delta = {k: jo.DP_SWEEP_COUNTERS[k] - before[k]
             for k in ("resident", "tiled")}
    if delta["resident"] + delta["tiled"] == 0:
        raise AssertionError("no FedBench query reached the device DP")
    state["fedbench_run"] = (stats, queries, opt, plans)
    # the oracle's answers (LocalEngine's equal them) and LocalEngine's
    # time per query, for the spmd phase on the same plans
    state["fedbench_spmd"] = (want, exec_ms)
    state["fedbench_fs"] = (fed, stats)
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
    from repro_torch.engine.local import LocalEngine

    stats, queries, opt, plans = state.pop("fedbench_run")
    # the recursive evaluator (the pipeline's oracle) on the same plans:
    # equal rows and metrics, and its time beside the pipeline's
    fed = state["fedbench_fs"][0]
    eng = LocalEngine(fed)
    t_rec = 0.0
    for q, plan in zip(queries, plans):
        t1 = time.perf_counter()
        rec = eng.execute_recursive(plan)
        t_rec += time.perf_counter() - t1
        res = eng.execute(plan)
        if list(res.rows) != list(rec.rows) or any(
                res.rows[v].tobytes() != rec.rows[v].tobytes()
                for v in res.rows) or (
                res.metrics.transferred_tuples, res.metrics.requests) != (
                rec.metrics.transferred_tuples, rec.metrics.requests):
            raise AssertionError(f"{q.name}: the pipeline differs from the "
                                 f"recursive evaluator")
    state["fedbench"]["exec_recursive_s"] = t_rec
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
    """Wraps the kernel wrappers the planner calls to keep their inputs, for
    replays outside the counted window: each ``dp_sweep`` call with the
    schedule ``_resident_sweep`` handed it, each ``dp_layer`` tile."""

    def __init__(self, K, jo):
        self.K, self.jo = K, jo
        self.real = (K.dp_sweep, K.dp_layer, jo._resident_sweep)
        self.sweeps: list = []
        self.tiles: list = []
        self._sched = None

    def install(self) -> None:
        self.K.dp_sweep, self.K.dp_layer = self._sweep, self._layer
        self.jo._resident_sweep = self._resident

    def remove(self) -> None:
        self.K.dp_sweep, self.K.dp_layer, self.jo._resident_sweep = self.real

    def _resident(self, sched, *args, **kw):
        self._sched = sched
        return self.real[2](sched, *args, **kw)

    def _sweep(self, *args, **kw):
        self.sweeps.append((self._sched, args, kw))
        return self.real[0](*args, **kw)

    def _layer(self, *args):
        self.tiles.append(args)
        return self.real[1](*args)


# ---------------------------------------------------------------------------
# query serving: the reference's serving scenario (benchmarks/serve_bench.py)
# ---------------------------------------------------------------------------

SERVE_N = 96                  # serve_bench.N_QUICK
SERVE_MAX_BATCH = 16          # serve_bench.MAX_BATCH
SERVE_TEMPLATES = ((7, 702), (8, 801), (8, 803), (6, 605), (7, 704),
                   (7, 706), (6, 601), (7, 701))     # serve_bench.TEMPLATES
SERVE_VARIANTS = 16           # serve_bench.VARIANTS_PER_TEMPLATE
SERVE_HANDOFF = 32


def _chain_query(stats, n_stars: int, k_extra: int, rng):
    """Chain of ``n_stars`` star meta-nodes linked via CP-backed predicates
    (a copy of ``benchmarks/planner_bench.py::chain_query`` over the port's
    types)."""
    from repro_torch.query.algebra import BGPQuery, Const, TriplePattern, Var

    pats = []
    cur = int(rng.integers(len(stats.cs)))
    last_cs = 0

    def outgoing(src: int):
        out = [(stats.intra_cp[src], src)] if stats.intra_cp[src].n_cp else []
        for (a, b), fcp in stats.fed_cp.items():
            if a == src and fcp.n_cp:
                out.append((fcp, b))
        return out

    for i in range(n_stars - 1):
        cand = outgoing(cur)
        if not cand:
            starts = [s for s in range(len(stats.cs)) if outgoing(s)]
            if not starts:
                raise RuntimeError("federation has no CP-linked sources")
            cur = starts[int(rng.integers(len(starts)))]
            cand = outgoing(cur)
        cp, nxt = cand[int(rng.integers(len(cand)))]
        r = int(rng.integers(cp.n_cp))
        pred, cs1, cs2 = int(cp.pred[r]), int(cp.cs1[r]), int(cp.cs2[r])
        extras = [int(p) for p in stats.cs[cur].preds_of(cs1) if int(p) != pred]
        rng.shuffle(extras)
        for j, p in enumerate(extras[:k_extra]):
            pats.append(TriplePattern(Var(f"x{i}"), Const(p), Var(f"x{i}_v{j}")))
        pats.append(TriplePattern(Var(f"x{i}"), Const(pred), Var(f"x{i + 1}")))
        cur, last_cs = nxt, cs2
    extras = [int(p) for p in stats.cs[cur].preds_of(last_cs)]
    for j, p in enumerate(extras[:k_extra]):
        pats.append(TriplePattern(Var(f"x{n_stars - 1}"), Const(p),
                                  Var(f"x{n_stars - 1}_v{j}")))
    return BGPQuery(pats, distinct=True, projection=["x0"],
                    name=f"CH{n_stars}")


def _planner_query(stats, n_stars: int, seed: int, k_extra: int = 3):
    """A chain query whose stars all survive source selection
    (``planner_bench.planner_query``)."""
    import numpy as np

    from repro_torch.core.decomposition import decompose
    from repro_torch.core.source_selection import select_sources

    rng = np.random.default_rng(seed)
    for _ in range(80):
        q = _chain_query(stats, n_stars, k_extra, rng)
        graph = decompose(q)
        sel = select_sources(graph, stats)
        if len(graph.stars) == n_stars and all(len(s) for s in sel.star_sources):
            return q
    return q


def _object_variants(q, fed, k: int) -> list:
    """``k`` instances of ``q`` differing only in a constant object bound to
    a non-link pattern (``planner_bench.object_variants``)."""
    import numpy as np

    from repro_torch.core.decomposition import decompose
    from repro_torch.query.algebra import BGPQuery, Const, TriplePattern, Var

    g = decompose(q)
    structural = {e.var for e in g.edges if e.var}
    structural |= {s.subject.name for s in g.stars if isinstance(s.subject, Var)}
    structural |= set(q.projection)
    for star in reversed(g.stars):
        for tp in star.patterns:
            if isinstance(tp.p, Const) and isinstance(tp.o, Var) \
                    and tp.o.name not in structural \
                    and not any(e.pattern is tp for e in g.edges):
                objs = sorted({int(o) for src in fed.sources for o in
                               np.unique(src.table.o[src.table.p == tp.p.tid])})
                if len(objs) >= 2:
                    return [BGPQuery([TriplePattern(p.s, p.p,
                                                    Const(objs[j % len(objs)])
                                                    if p is tp else p.o)
                                      for p in q.patterns], distinct=q.distinct,
                                     projection=q.projection,
                                     name=f"{q.name}o{j}")
                            for j in range(k)]
    return []


def _subject_variants(q, fed, k: int) -> list:
    """``k`` instances of ``q`` with the first star's subject bound to
    different entities (``planner_bench.subject_variants``)."""
    import numpy as np

    from repro_torch.core.decomposition import decompose
    from repro_torch.query.algebra import BGPQuery, Const, TriplePattern, Var

    g = decompose(q)
    star = g.stars[0]
    if not isinstance(star.subject, Var):
        return []
    name = star.subject.name
    if any(isinstance(tp.o, Var) and tp.o.name == name
           for st in g.stars for tp in st.patterns):
        return []
    proj = [v for v in q.projection if v != name] or \
        [v for s in g.stars[1:] if isinstance(s.subject, Var)
         for v in (s.subject.name,)][:1]
    if not proj:
        return []
    preds = set(star.bound_preds())
    out: list = []
    seen: set = set()
    for src in fed.sources:
        t = src.table
        for sid in np.unique(t.s):
            sid = int(sid)
            if sid not in seen and preds <= set(t.p[t.s == sid].tolist()):
                seen.add(sid)
                pats = [TriplePattern(Const(sid) if isinstance(p.s, Var)
                                      and p.s.name == name else p.s, p.p, p.o)
                        for p in q.patterns]
                out.append(BGPQuery(pats, distinct=q.distinct, projection=proj,
                                    name=f"{q.name}s{sid}"))
                if len(out) >= k:
                    return out
    return out


def serve_workload(stats, fed, size: int, seed: int = 23):
    """The reference's templated, planning-bound serving mix
    (``serve_bench.serve_workload``): subject-bound large-star chains served
    as object-constant instances, shuffled, the first few repeated verbatim.
    The reference keeps a template when its first instance executes within
    half its planning time, a clock test; this copy keeps it when that
    instance's execution (the operator pipeline, planned on the numpy
    backend) makes no more physical endpoint scans than the query has triple
    patterns, i.e. no bind-join fan-out, so every machine serves the same
    wave.  Returns the wave and one row per probed template."""
    import numpy as np

    from repro_torch.core.planner import OdysseyOptimizer
    from repro_torch.engine.pipeline import compile_plan

    opt = OdysseyOptimizer(stats, plan_cache_size=0, dp_backend="numpy")
    kept, probed, rows = [], [], []
    for stars, tseed in SERVE_TEMPLATES:
        q = _planner_query(stats, stars, seed=tseed, k_extra=3)
        bound = _subject_variants(q, fed, 2)
        variants = _object_variants(bound[0] if bound else q, fed,
                                    SERVE_VARIANTS)
        if len(variants) < 2:
            rows.append({"template": [stars, tseed], "variants": 0})
            continue
        ex = compile_plan(opt.optimize(variants[0]), fed)
        ex.run()
        keep = ex.physical_scans <= len(variants[0].patterns)
        probed.append(variants)
        if keep:
            kept.append(variants)
        rows.append({"template": [stars, tseed], "name": variants[0].name,
                     "patterns": len(variants[0].patterns),
                     "variants": len(variants),
                     "physical_scans": ex.physical_scans,
                     "physical_tuples": ex.physical_tuples, "kept": keep})
        if len(kept) * SERVE_VARIANTS >= size:
            break
    if len(kept) < 3:
        kept = probed
    wave = [v for variants in kept for v in variants]
    wave += wave[: max(size // 12, 1)]
    base = list(wave)
    while len(wave) < size:
        wave.append(base[len(wave) % len(base)])
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(wave))
    return [wave[i] for i in order][:size], rows


def _poisson_offsets(n: int, window_s: float, seed: int = 29):
    """Cumulative open-loop arrival offsets covering about ``window_s``
    seconds (``serve_bench.poisson_offsets``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1.0, size=n)
    return np.cumsum(gaps) * (window_s / max(float(gaps.sum()), 1e-9))


def _serve_trace(eng, wave, offsets, service):
    """Drive one engine through the open-loop arrival trace
    (``serve_bench._serve_trace``): a submitter thread pins each ``submit``
    to its offset; this thread repeats ``service(eng)`` until everything
    completes.  Returns (requests, wall seconds)."""
    import threading

    t0 = time.perf_counter()

    def arrivals():
        for q, off in zip(wave, offsets):
            lag = off - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
            eng.submit(q)

    sub = threading.Thread(target=arrivals, name="chip-smoke-arrivals")
    sub.start()
    done = []
    while sub.is_alive() or len(done) < len(wave):
        got = service(eng)
        done.extend(got)
        if not got:
            time.sleep(0.0005)
    sub.join()
    done.extend(eng.drain())
    return done, time.perf_counter() - t0


def same_plan(a, b, name: str) -> None:
    """Two physical plans equal node for node (exact floats), with the same
    selection, epoch and cache flag."""
    if (a.root != b.root or a.selection.star_sources != b.selection.star_sources
            or a.stats_epoch != b.stats_epoch or a.cached != b.cached
            or a.fallback != b.fallback):
        raise AssertionError(f"{name}: plan differs from the numpy backend's")


def _recording(eng, log: list):
    """Wrap ``eng._plan_batch`` to log each planned batch: its request ids
    and the planning time the engine charged it."""
    real = eng._plan_batch

    def plan_batch(batch):
        before = eng.serve_stats.plan_ms
        real(batch)
        log.append(([r.qid for r in batch], eng.serve_stats.plan_ms - before))
    eng._plan_batch = plan_batch


def _pct(xs, p: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs, float), p))


def phase_query_serve(state: dict) -> None:
    """The main path of query serving on FedBench scale 1.0 (the
    ``fedbench`` phase's federation and statistics): the reference's
    serving wave planned with the numpy backend in an ``optimize`` loop (the
    oracle), then on the card in ``optimize_batch`` calls of 16, every plan
    held to the oracle's; then the same open-loop trace served twice on the
    card, arrival-order drain (synchronous) and affinity admission with the
    background planner.  Answers and timings are checked in
    ``check_query_serve``, outside the counted window."""
    import dataclasses

    from repro_torch.core import join_order as jo
    from repro_torch.core.planner import OdysseyOptimizer
    from repro_torch.kernels import dp_layer as K
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.serve import QueryServeEngine

    fed, stats = state["fedbench_fs"]
    t0 = time.perf_counter()
    wave, templates = serve_workload(stats, fed, SERVE_N)
    setup_s = time.perf_counter() - t0
    if len(wave) != SERVE_N:
        raise AssertionError(f"{len(wave)} queries, expected {SERVE_N}")

    opt_np = OdysseyOptimizer(stats, dp_backend="numpy")
    t0 = time.perf_counter()
    oracle = [opt_np.optimize(q) for q in wave]
    loop_ms = (time.perf_counter() - t0) * 1e3

    rec = _Recorder(K, jo)
    rec.install()
    try:
        opt = OdysseyOptimizer(stats)                  # torch DP on cuda
        if (opt.dp_backend, opt.device) != ("torch", DEVICE):
            raise AssertionError("the default optimizer must run on cuda")
        batches = []
        for i in range(0, len(wave), SERVE_MAX_BATCH):
            part = wave[i:i + SERVE_MAX_BATCH]
            l0 = LAUNCHES["dp_sweep"]
            t0 = time.perf_counter()
            plans = opt.optimize_batch(part)
            ms = (time.perf_counter() - t0) * 1e3
            for j, p in enumerate(plans):
                same_plan(p, oracle[i + j], part[j].name)
            rep = dataclasses.asdict(opt.last_batch_report)
            batches.append({"plan_ms": ms,
                            "dp_sweep_launches": LAUNCHES["dp_sweep"] - l0,
                            "report": rep})
    finally:
        rec.remove()
    batch_launches = sum(b["dp_sweep_launches"] for b in batches)
    if batch_launches == 0:
        raise AssertionError("optimize_batch never launched dp_sweep")

    # overload calibration as in the reference: the whole wave planned as
    # one batch bounds the server's best-case planning; arrivals land in
    # 1.5x that window, and admission may hold a request 0.4x of it
    t0 = time.perf_counter()
    OdysseyOptimizer(stats, plan_cache_size=0).optimize_batch(wave)
    window_s = (time.perf_counter() - t0) * 1.5
    slo_s = window_s * 0.4
    offsets = _poisson_offsets(len(wave), window_s)

    runs = {}
    for name, kw, service in (
            ("arrival_drain", {"admission": "arrival"}, lambda e: e.drain()),
            ("affinity_pipeline", {"admission": "affinity", "pipeline": True,
                                   "handoff_depth": SERVE_HANDOFF},
             lambda e: e.poll())):
        l0 = LAUNCHES["dp_sweep"]
        eng = QueryServeEngine(fed, stats, max_batch=SERVE_MAX_BATCH,
                               default_slo_ms=slo_s * 1e3, **kw)
        if (eng.optimizer.dp_backend, eng.optimizer.device) != ("torch",
                                                                DEVICE):
            raise AssertionError("QueryServeEngine must plan on cuda")
        log: list = []
        _recording(eng, log)
        try:
            done, wall = _serve_trace(eng, wave, offsets, service)
        finally:
            eng.close()
        launches = LAUNCHES["dp_sweep"] - l0       # read after close
        if sorted(r.qid for r in done) != list(range(len(wave))):
            raise AssertionError(f"{name}: {len(done)} of {len(wave)} served")
        if launches == 0:
            raise AssertionError(f"{name}: dp_sweep never launched")
        st = eng.serve_stats
        lat = [r.planning_latency_s() * 1e3 for r in done]
        runs[name] = {"done": {r.qid: r for r in done}, "batches": log,
                      "row": {"wall_s": wall, "qps": len(wave) / wall,
                              "plan_latency_p50_ms": _pct(lat, 50),
                              "plan_latency_p99_ms": _pct(lat, 99),
                              "full_flushes": st.n_full_flushes,
                              "deadline_flushes": st.n_deadline_flushes,
                              "forced_flushes": st.n_forced_flushes,
                              "batches": st.n_steps,
                              "plan_ms": st.plan_ms, "exec_ms": st.exec_ms,
                              "plan_ms_per_batch": st.plan_ms / st.n_steps,
                              "plan_cache_hits": st.plan_cache_hits,
                              "planned": st.n_planned, "shapes": st.n_shapes,
                              "dp_sweep_launches": launches}}
    state["query_serve_run"] = (wave, oracle, rec, runs)
    state["query_serve"] = dict(
        queries=len(wave), distinct=len({id(q) for q in wave}),
        max_batch=SERVE_MAX_BATCH, templates=templates, setup_s=setup_s,
        numpy_loop_ms=loop_ms, optimize_batch=batches,
        optimize_batch_dp_sweep_launches=batch_launches,
        window_s=window_s, slo_ms=slo_s * 1e3,
        runs={k: v["row"] for k, v in runs.items()})


def _replay_plan_ms(stats, wave, cuts, backend: str) -> list:
    """Host time of each batch of ``cuts`` (lists of request ids) planned
    again, in order, by one fresh optimizer on ``backend``."""
    from repro_torch.core.planner import OdysseyOptimizer

    opt = OdysseyOptimizer(stats, dp_backend=backend)
    out = []
    for qids in cuts:
        t0 = time.perf_counter()
        opt.optimize_batch([wave[i] for i in qids])
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _batch_split(stats, batch, reps: int = 5) -> dict:
    """Host clock over one card ``optimize_batch`` call (fresh optimizer,
    cold plan cache), split four ways: the ``dp_sweep`` calls closed by a
    sync, the rest of ``_resident_sweep`` (seed math, uploads, copy back,
    merge), the rest of ``dp_join_order_batch`` (statistics and the host
    sweep around the kernel), and the rest of ``plan_batch`` (signatures,
    decomposition, source selection, emission).  Medians over ``reps``
    calls, in ms."""
    import torch

    from repro_torch.core import batch_planner as bp
    from repro_torch.core import join_order as jo
    from repro_torch.core.planner import OdysseyOptimizer
    from repro_torch.kernels import dp_layer as K

    real = (K.dp_sweep, jo._resident_sweep, bp.dp_join_order_batch)
    clock = {}

    def timed(key, fn, sync=False):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            clock[key] += time.perf_counter() - t0
            return out
        return run

    runs = []
    K.dp_sweep = timed("sweep", real[0], sync=True)
    jo._resident_sweep = timed("resident", real[1])
    bp.dp_join_order_batch = timed("dp", real[2])
    try:
        for _ in range(reps):
            clock.update(sweep=0.0, resident=0.0, dp=0.0)
            opt = OdysseyOptimizer(stats)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.optimize_batch(batch)
            total = time.perf_counter() - t0
            runs.append((clock["sweep"], clock["resident"] - clock["sweep"],
                         clock["dp"] - clock["resident"],
                         total - clock["dp"], total))
    finally:
        K.dp_sweep, jo._resident_sweep, bp.dp_join_order_batch = real
    return {k: statistics.median(r[i] for r in runs) * 1e3 for i, k in
            enumerate(("dp_sweep_calls_ms", "seed_and_merge_ms",
                       "rest_of_dp_ms", "rest_of_plan_batch_ms",
                       "total_ms"))}


def check_query_serve(state: dict) -> None:
    """Outside the counted window: per request, rows byte-equal between the
    two serving runs and answers equal to ``naive_evaluate`` for every
    distinct query; each run's batches replayed on fresh optimizers, card
    against the numpy backend; one batch split on the host clock; and
    ``dp_sweep`` at the serving path's largest stacked group against its
    plain version, timed with ``queued_ms`` beside its bytes bound."""
    from repro_torch.engine.local import naive_evaluate
    from repro_torch.kernels import dp_layer as K

    fed, stats = state["fedbench_fs"]
    wave, oracle, rec, runs = state.pop("query_serve_run")
    a, b = runs["arrival_drain"]["done"], runs["affinity_pipeline"]["done"]
    oracle_sets = {}
    nonempty = 0
    for qid, q in enumerate(wave):
        ra, rb = a[qid], b[qid]
        if list(ra.rows) != list(rb.rows):
            raise AssertionError(f"qid {qid}: columns differ between runs")
        for v in ra.rows:
            if ra.rows[v].tobytes() != rb.rows[v].tobytes():
                raise AssertionError(f"qid {qid}: scheduling changed rows")
        if any(getattr(ra.metrics, m) != getattr(rb.metrics, m) for m in
               ("transferred_tuples", "requests", "intermediate_rows")):
            raise AssertionError(f"qid {qid}: scheduling changed metrics")
        if id(q) not in oracle_sets:
            oracle_sets[id(q)] = naive_evaluate(fed, q)
        got = answer_set(ra, q)
        if got != oracle_sets[id(q)]:
            raise AssertionError(f"qid {qid} ({q.name}): answers differ "
                                 f"from the oracle")
        nonempty += bool(got)

    for name, run in runs.items():
        cuts = [qids for qids, _ in run["batches"]]
        card = _replay_plan_ms(stats, wave, cuts, "torch")
        host = _replay_plan_ms(stats, wave, cuts, "numpy")
        run["row"].update(
            served_plan_ms=[ms for _, ms in run["batches"]],
            replay_plan_ms=card, replay_numpy_plan_ms=host,
            replay_plan_ms_per_batch=sum(card) / len(card),
            replay_numpy_plan_ms_per_batch=sum(host) / len(host),
            replay_plan_ms_median=statistics.median(card),
            replay_numpy_plan_ms_median=statistics.median(host))
    first = [wave[i] for i in runs["arrival_drain"]["batches"][0][0]]
    split = _batch_split(stats, first)

    # the largest stacked group of the main path: most members, then most
    # stars
    sched, args, kw = max(rec.sweeps, key=lambda c: (c[1][5].shape[0],
                                                     c[0].n))
    B, n = args[5].shape[0], sched.n
    want = K.dp_sweep_plain(*args)
    err = max_abs_err(K.dp_sweep(*args, **kw), want)
    if err != 0.0:
        raise AssertionError(f"dp_sweep at the serving group differs from "
                             f"its plain version: {err}")
    kms, queued = queued_ms(lambda: K.dp_sweep(*args, **kw))
    if not queued:
        raise AssertionError("dp_sweep at the serving group: the host could "
                             "not queue the calls")
    pms, plain_queued = queued_ms(lambda: K.dp_sweep_plain(*args), k=3)
    bound, by = sweep_bound(sched, B, 1 << n)
    sizes = sorted({(c[1][5].shape[0], c[0].n) for c in rec.sweeps})
    state["query_serve_sweep"] = {
        "B": B, "n": n, "pairs": sched.n_pairs, "max_abs_err": err,
        "kernel_ms": kms, "plain_ms": pms, "plain_queued": plain_queued,
        "call_ms": cuda_ms(lambda: K.dp_sweep(*args, **kw)),
        "bound_ms": bound, "bound_by": by,
        "sweeps_recorded": len(rec.sweeps),
        "group_shapes": [list(s) for s in sizes]}
    out = state["query_serve"]
    for name, run in runs.items():
        out["runs"][name] = run["row"]
    emit("query_serve", nvidia_smi=state["smi"], **out,
         nonempty_answers=nonempty, distinct_checked=len(oracle_sets),
         host_split_first_batch=split,
         dp_sweep_largest_group=state["query_serve_sweep"])




def _plan_large_star(case, backend: str = "torch"):
    from repro_torch.core import join_order as jo
    from repro_torch.core.cost import CostModel

    _, _, B, _, g, stats, sels, q = case
    return jo.dp_join_order_batch([g] * B, stats, sels, CostModel(),
                                  q.distinct, dp_backend=backend)


def _item_sizes(sched, args) -> dict:
    """``dp_sweep``'s device time (``queued_ms``) on one main-path input
    with the work list cut at ``ITEM_PAIRS`` and at its neighbours (half and
    twice as many pairs), each held exactly to the plain version; fails
    when a reading holds host time."""
    import torch

    from repro_torch.kernels import dp_layer as K

    want = K.dp_sweep_plain(*args)
    dev = args[1].device
    out = {}
    for k in (K.ITEM_PAIRS // 2, K.ITEM_PAIRS, 2 * K.ITEM_PAIRS):
        items, item_ptr = (torch.from_numpy(x).to(dev) for x in
                           K.work_items(sched.layer_cols, sched.col_ptr,
                                        1 << sched.n, k=k))

        def run():
            return K.dp_sweep(*args, items=items, item_ptr=item_ptr)

        err = max_abs_err(run(), want)
        if err != 0.0:
            raise AssertionError(f"dp_sweep with {k}-pair items differs "
                                 f"from its plain version: {err}")
        ms, queued = queued_ms(run)
        if not queued:
            raise AssertionError(f"dp_sweep with {k}-pair items: the host "
                                 f"could not queue the calls")
        out[k] = ms
    return out


def _resident_split(case, reps: int = 5) -> dict:
    """Host clock over resident planning calls, split three ways: the
    ``dp_sweep`` wrapper call closed by a sync, the rest of
    ``_resident_sweep`` (its seed math, the uploads, the copy back and the
    merge) and everything else in ``dp_join_order_batch``.  Medians over
    ``reps`` calls, in ms."""
    import torch

    from repro_torch.core import join_order as jo
    from repro_torch.kernels import dp_layer as K

    real_sweep, real_resident = K.dp_sweep, jo._resident_sweep
    clock = {}

    def sweep(*args, **kw):
        t0 = time.perf_counter()
        out = real_sweep(*args, **kw)
        torch.cuda.synchronize()
        clock["sweep"] += time.perf_counter() - t0
        return out

    def resident(*args, **kw):
        t0 = time.perf_counter()
        real_resident(*args, **kw)
        clock["resident"] += time.perf_counter() - t0

    runs = []
    K.dp_sweep, jo._resident_sweep = sweep, resident
    try:
        for _ in range(reps):
            clock.update(sweep=0.0, resident=0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _plan_large_star(case)
            total = time.perf_counter() - t0
            runs.append((clock["sweep"], clock["resident"] - clock["sweep"],
                         total - clock["resident"], total))
    finally:
        K.dp_sweep, jo._resident_sweep = real_sweep, real_resident
    return {k: statistics.median(r[i] for r in runs) * 1e3 for i, k in
            enumerate(("dp_sweep_call_ms", "seed_and_merge_ms", "rest_ms",
                       "total_ms"))}


def phase_large_star(state: dict) -> None:
    """The main path on the large stars: each sweep once on the card, in
    the mode the budget decides.  Checks and timings run later, in
    ``check_large_star``, outside the counted window."""
    from repro_torch.core import join_order as jo
    from repro_torch.kernels import dp_layer as K
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.rdf.shapes import shaped_planning_inputs

    cases = []
    for shape, n, B, mode in LARGE_STAR:
        g, stats, sel, q = shaped_planning_inputs(shape, n, seed=SHAPE_SEED)
        sels = [member_selection(sel, b) for b in range(B)]
        cases.append((shape, n, B, mode, g, stats, sels, q))

    runs = []
    for case in cases:
        shape, n, B, mode = case[:4]
        rec = _Recorder(K, jo)
        rec.install()
        before = dict(jo.DP_SWEEP_COUNTERS)
        l0 = dict(LAUNCHES)
        try:
            trees = _plan_large_star(case)
        finally:
            rec.remove()
        launches = {k: LAUNCHES[k] - l0[k] for k in LAUNCHES}
        ran = {k: jo.DP_SWEEP_COUNTERS[k] - before[k]
               for k in ("resident", "tiled")}
        if ran[mode] != 1 or sum(ran.values()) != 1:
            raise AssertionError(f"{shape}{n} B={B}: expected one {mode} "
                                 f"sweep, counters moved {ran}")
        kname = "dp_sweep" if mode == "resident" else "dp_layer"
        if launches[kname] == 0:
            raise AssertionError(f"{shape}{n}: {kname} never launched")
        if mode == "resident" and launches[kname] != 1:
            raise AssertionError(f"{shape}{n}: {launches[kname]} dp_sweep "
                                 f"launches, expected one per sweep")
        runs.append((case, trees, rec, launches))
    state["large_star_runs"] = runs


def check_large_star(state: dict) -> None:
    """Each large-star plan of the main path against the numpy backend's,
    then the timings: the planning call (CUDA events), its kernel and the
    kernel's plain version on the inputs the main path gave it, as device
    time of calls queued back to back (``queued_ms``; the resident sweep
    also as one call timed with CUDA events, ``call_ms``), and for the
    resident cells a host-clock split of the planning call
    (``_resident_split``)."""
    import torch

    from repro_torch.kernels import dp_layer as K

    rows = []
    for case, trees, rec, launches in state.pop("large_star_runs"):
        shape, n, B, mode = case[:4]
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
            sched, args, work = rec.sweeps[0]
            # device time of calls queued back to back, and one call timed
            # with CUDA events (which carries the wrapper's host work)
            kms, queued = queued_ms(lambda: K.dp_sweep(*args, **work))
            pms, plain_queued = queued_ms(lambda: K.dp_sweep_plain(*args),
                                          k=3)
            call = cuda_ms(lambda: K.dp_sweep(*args, **work))
            err = max_abs_err(K.dp_sweep(*args, **work),
                              K.dp_sweep_plain(*args))
            bound, by = sweep_bound(sched, B, 1 << n)
            # the DP state on the card: six seed planes in, the working
            # (cost, card, n_src, src_w) records, the cost plane (float64)
            # and strat/split (int32)
            row.update(kernel_ms=kms, queued=queued, call_ms=call,
                       plain_ms=pms, plain_queued=plain_queued,
                       max_abs_err=err, bound_ms=bound, bound_by=by,
                       # repro: ignore[RPT003] -- a busy share: the sweep's
                       # device time over the whole plan's elapsed time, two
                       # boundaries by definition, and no rival pair
                       pairs=sched.n_pairs, device_busy_share=kms / sweep_ms,
                       schedule_bytes=sum(int(a.numel() * a.element_size())
                                          for a in (*args[1:5],
                                                    *work.values())),
                       state_bytes=B * (1 << n) * (11 * 8 + 2 * 4),
                       items=int(work["items"].shape[0]),
                       item_pairs_ms=_item_sizes(sched, args),
                       host_split=_resident_split(case))
        else:
            # every tile of the main path replayed on the card: device time
            # of calls queued back to back (a few microseconds a tile is
            # below what one timed call can resolve from the host)
            kms_all = [queued_ms(lambda: K.dp_layer(*a))[0]
                       for a in rec.tiles]
            pms_all = [queued_ms(lambda: K.dp_layer_plain(*a), k=3)[0]
                       for a in rec.tiles]
            err = max(max_abs_err(K.dp_layer(*a), K.dp_layer_plain(*a))
                      for a in rec.tiles)
            i_big = max(range(len(rec.tiles)),
                        key=lambda i: rec.tiles[i][0].numel())
            big = rec.tiles[i_big]
            bound, by = tile_bound(big)
            row.update(tiles=len(rec.tiles), kernel_ms_sum=sum(kms_all),
                       plain_ms_sum=sum(pms_all), max_abs_err=err,
                       device_busy_share=sum(kms_all) / sweep_ms,
                       largest_tile=list(big[0].shape),
                       kernel_ms=kms_all[i_big], plain_ms=pms_all[i_big],
                       bound_ms=bound, bound_by=by,
                       bound_ms_sum=sum(tile_bound(a)[0] for a in rec.tiles))
        if err != 0.0:
            raise AssertionError(f"{shape}{n}: kernel differs from its "
                                 f"plain version by {err}")
        rows.append(row)
    state["large_star"] = {r["case"]: r for r in rows}
    emit("large_star", nvidia_smi=state["smi"], sweeps=rows)


def _cs_checks(cs, dev_cs, n_subj: int, bitmaps, name: str) -> None:
    """One source's device CS tuple and predicate bitmaps against its host
    ``CSStats``: subject ids, degrees and wrapping signature sums per
    subject, zeros past the last subject, and each subject's bitmap equal to
    ``{p % 128}`` over its CS's predicates."""
    import numpy as np

    from repro_torch.common.hashing import splitmix64

    subj_ids, sig_sum, deg, _, _ = dev_cs
    if n_subj != len(cs.ent_ids):
        raise AssertionError(f"{name}: {n_subj} subjects on the card, "
                             f"{len(cs.ent_ids)} on the host")
    sizes = np.diff(cs.indptr)
    owner = np.repeat(np.arange(cs.n_cs), sizes)
    with np.errstate(over="ignore"):
        cs_sig = np.zeros(cs.n_cs, np.uint64)
        np.add.at(cs_sig, owner, splitmix64(cs.pred_ids.astype(np.uint64)))
    ids, sums, degs = (t.cpu().numpy() for t in (subj_ids, sig_sum, deg))
    if not (np.array_equal(ids[:n_subj], cs.ent_ids)
            and np.array_equal(degs[:n_subj], sizes[cs.ent_cs])
            and np.array_equal(sums[:n_subj].view(np.uint64),
                               cs_sig[cs.ent_cs])):
        raise AssertionError(f"{name}: device CS signatures differ from the "
                             f"host CS statistics")
    if ids[n_subj:].any() or sums[n_subj:].any() or degs[n_subj:].any():
        raise AssertionError(f"{name}: nonzero entries past the last subject")
    if int(degs.max()) >= 2**24:
        raise AssertionError(f"{name}: a bucket count could reach 2^24")
    cs_bm = np.zeros((cs.n_cs, 128), bool)
    cs_bm[owner, cs.pred_ids % 128] = True
    if not np.array_equal(bitmaps, cs_bm[cs.ent_cs]):
        raise AssertionError(f"{name}: predicate bitmaps differ")


def _algorithm1_checks(stats, fed_cps) -> None:
    """Each ordered source pair of ``compute_federated_cps_ops`` against the
    host statistics: the probe's candidates equal ``candidate_cs_pairs``,
    the exact checks the build's, and the CP counts from ``intersect_count``
    and from ``match_counts`` both equal ``build_federated_stats``'s, zeros
    absent."""
    import numpy as np

    from repro_torch.core.summaries import candidate_cs_pairs

    for (i, j), res in fed_cps.items():
        if not np.array_equal(res.candidates, candidate_cs_pairs(
                stats.summaries[i], stats.summaries[j])):
            raise AssertionError(f"({i}, {j}): signature probe candidates "
                                 f"differ from candidate_cs_pairs")
        if res.n_checked_pairs != stats._pair_pruning[(i, j)][0]:
            raise AssertionError(f"({i}, {j}): {res.n_checked_pairs} exact "
                                 f"checks, the build made "
                                 f"{stats._pair_pruning[(i, j)][0]}")
        want = stats.fed_cp.get((i, j))
        if want is not None and int(want.count.max()) > INT32_MAX:
            raise AssertionError(f"({i}, {j}): a CP count exceeds int32")
        for how, got in (("intersect_count", res.cps),
                         ("match_counts", res.match_cps)):
            if want is None:
                if got.n_cp:
                    raise AssertionError(f"({i}, {j}): CPs from {how} where "
                                         f"the build has none")
                continue
            for f in ("pred", "cs1", "cs2", "count"):
                if not np.array_equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"({i}, {j}): federated CP {f} from "
                                         f"{how} differ")


def phase_stats(state: dict) -> None:
    """The statistics path on the card, once: device CS signatures and
    predicate bitmaps per source, then Algorithm 1 for every ordered source
    pair through ``compute_federated_cps_ops`` (signature probe, exact
    intersections), each result held against the host statistics of
    ``build_federated_stats`` (which itself stays on the host, as in the
    reference).  Kernel-against-plain replays and timings run later, in
    ``check_stats``."""
    import torch

    from repro_torch.core.characteristic_sets import \
        compute_characteristic_sets_torch
    from repro_torch.core.federation import (build_federated_stats,
                                             compute_federated_cps_ops)
    from repro_torch.kernels import ops
    from repro_torch.rdf.generator import (fedbench_like_spec,
                                           generate_federation)

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    fed, _ = generate_federation(fedbench_like_spec(scale=STATS_SCALE))
    stats = build_federated_stats(fed)
    t_setup = time.perf_counter() - t0

    t1 = time.perf_counter()
    subjects = rows = 0
    big_rows = None               # seg_bitmap's largest main-path input
    for k, src in enumerate(fed.sources):
        tab = src.table
        s_d = torch.from_numpy(tab.s).to(dev)
        p_d = torch.from_numpy(tab.p).to(dev)
        dev_cs = compute_characteristic_sets_torch(s_d, p_d, device=DEVICE)
        n_subj = int(dev_cs[3][-1]) + 1
        # bitmaps: the table is sorted by (s, p, o), so its rows are in the
        # function's (s, p) order; each unique (s, p) row counts under its
        # subject's segment, repeats are padding (seg -1); bucket = p % 128
        first = torch.ones(1, dtype=torch.bool, device=dev)
        new_sp = torch.cat([first, (s_d[1:] != s_d[:-1])
                            | (p_d[1:] != p_d[:-1])])
        seg = torch.where(new_sp, dev_cs[3], -1).to(torch.int32)
        bucket = (p_d % 128).to(torch.int32)
        bitmaps = ops.predicate_bitmaps(seg, bucket, n_subj, device=DEVICE)
        _cs_checks(stats.cs[k], dev_cs, n_subj, bitmaps, src.name)
        if big_rows is None or len(seg) > len(big_rows[0]):
            big_rows = (seg, bucket, n_subj)
        subjects += n_subj
        rows += len(p_d)
    t_cs = time.perf_counter() - t1

    t1 = time.perf_counter()
    fed_cps = compute_federated_cps_ops(stats.exports, stats.summaries,
                                        device=DEVICE)
    t_alg1 = time.perf_counter() - t1
    _algorithm1_checks(stats, fed_cps)
    checked = sum(r.n_checked_pairs for r in fed_cps.values())
    if checked != stats.pruning_checked:
        raise AssertionError(f"{checked} exact checks, the build made "
                             f"{stats.pruning_checked}")
    state["stats_run"] = (stats, fed_cps, big_rows)
    state["stats"] = dict(
        scale=STATS_SCALE, sources=len(fed.sources),
        triples=fed.total_triples(), subjects=subjects, rows=rows,
        probe_blocks=sum(len(r.blocks) for r in fed_cps.values()),
        exact_checks=checked, possible_pairs=stats.pruning_possible,
        fed_cps=sum(c.n_cp for c in stats.fed_cp.values()), setup_s=t_setup,
        cs_s=t_cs, algorithm1_s=t_alg1)


def _largest_calls(stats, fed_cps, big_rows, dev) -> dict:
    """The kernel arguments of ``summary_probe``'s and ``seg_bitmap``'s
    largest main-path calls: the largest probe block, the source with the
    most rows."""
    import numpy as np
    import torch

    def words(sig):               # uint64 words as int32, low half first
        return torch.from_numpy(np.ascontiguousarray(sig).view(np.int32)).to(dev)

    block = None
    for (i, j), res in fed_cps.items():
        for orows, srows in res.blocks:
            if block is None or len(orows) + len(srows) > block[0]:
                block = (len(orows) + len(srows), i, j, orows, srows)
    _, i, j, orows, srows = block
    return {"summary_probe": (words(stats.summaries[i].obj_sig[orows]),
                              words(stats.summaries[j].subj_sig[srows])),
            "seg_bitmap": big_rows}


def _pair_batches(stats, fed_cps, dev) -> list:
    """Algorithm 1's exact checks as the main path launches them: for every
    source pair with a check, the arguments of its one
    ``sorted_intersect_segments`` call (objects weighted by their
    multiplicities, subjects by 1; ``join_count_segments`` takes the same
    lists without ``aw``), each source's export on the card once."""
    import torch

    from repro_torch.core.federation import exact_check_segments

    up: dict = {}

    def source(k):
        if k not in up:
            e = stats.exports[k]
            up[k] = tuple(torch.from_numpy(x).to(dev) for x in
                          (e.obj_ents, e.obj_mult, e.subj_ents))
        return up[k]

    batches = []
    for (i, j), res in fed_cps.items():
        _, a_off, a_len, b_off, b_len = exact_check_segments(
            stats.exports[i], stats.exports[j], res.pairs)
        if len(a_off):
            ents, mult, _ = source(i)
            subj = source(j)[2]
            ones = torch.ones(subj.shape[0], dtype=torch.int32, device=dev)
            batches.append(((i, j), (ents, mult, a_off, a_len, subj, ones,
                                     b_off, b_len)))
    return batches


def _jc_args(si_args) -> tuple:
    """``join_count_segments``'s arguments from ``sorted_intersect_segments``'s
    (the same lists, no probe weights)."""
    return (si_args[0], *si_args[2:])


def _list_bytes(a, b) -> "tuple[int, int]":
    """Compulsory bytes of one list pair: ``sorted_intersect`` reads both
    key lists once, a weight only where its key has a match, and writes one
    sum; ``join_count`` reads the probes and writes their counts, reads the
    build keys once and a build weight only where its key is probed."""
    import torch

    ma, mb = (int(torch.isin(x, y).sum()) for x, y in ((a, b), (b, a)))
    n, m = a.shape[0], b.shape[0]
    return 4 * (n + m) + 4 * (ma + mb) + 4, 8 * n + 4 * m + 4 * mb


def _batch_bytes(args) -> "tuple[int, int]":
    """Compulsory bytes of one segmented launch, as ``_list_bytes`` counts
    them, over the union of its segments: a key (or a weight) that several
    segments share is read once.  Each ``join_count`` count and each
    ``sorted_intersect`` sum is written once."""
    import torch

    a, _, a_off, a_len, b, _, b_off, b_len = args
    seen = [torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
            for x in (a, b, a, b)]          # keys read, weights read
    for o, n, p, m in zip(a_off.tolist(), a_len.tolist(), b_off.tolist(),
                          b_len.tolist()):
        x, y = a[o:o + n], b[p:p + m]
        seen[0][o:o + n] = True
        seen[1][p:p + m] = True
        seen[2][o:o + n] |= torch.isin(x, y)
        seen[3][p:p + m] |= torch.isin(y, x)
    na, nb, ma, mb = (int(x.sum()) for x in seen)
    return (4 * (na + nb + ma + mb) + 4 * len(a_off),
            4 * (na + nb + mb) + 4 * int(a_len.sum()))


def _time_kernel(name, kernel, plain, args) -> dict:
    """One call of ``kernel`` against ``plain`` (exact), with device times
    of both (``queued_ms``) and the wrapper's time per call."""
    err = max_abs_err([kernel(*args)], [plain(*args)])
    if err != 0.0:
        raise AssertionError(f"{name} differs from its plain version on "
                             f"its largest main-path input: {err}")
    kms, queued = queued_ms(lambda: kernel(*args))
    if not queued:
        raise AssertionError(f"{name}: the host fell behind the card, so "
                             f"its time would hold host time")
    pms, plain_queued = queued_ms(lambda: plain(*args))
    return {"max_abs_err": err, "kernel_ms": kms,
            "call_ms": cuda_ms(lambda: kernel(*args), reps=20),
            "plain_ms": pms, "plain_queued": plain_queued, "library_ms": None}


def _kernel_alone_ms(name: str, args) -> float:
    """Device time (``queued_ms``) of ``name``'s segmented launch on the
    wrapper's arguments ``args`` with its table uploaded once beforehand:
    the kernel without the table copy that each wrapper call makes, its
    result held to the wrapper's."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import join_count as JC
    from repro_torch.kernels import sorted_intersect as SI

    dev = torch.device(DEVICE)
    if name == "sorted_intersect":
        a, aw, a_off, a_len, b, bw, b_off, b_len = args
        table, n_tiles = SI.segment_table(a_off, a_len, b_off, b_len,
                                          (a_len > 0) & (b_len > 0), dev)
        ptrs = (a.data_ptr(), aw.data_ptr(), b.data_ptr(), bw.data_ptr())
        out = torch.zeros(len(a_off), dtype=torch.int32, device=dev)
        want = SI.sorted_intersect_segments(*args)
    else:
        a, a_off, a_len, b, bw, b_off, b_len = args
        table, n_tiles = SI.segment_table(a_off, a_len, b_off, b_len,
                                          a_len > 0, dev,
                                          out_off=np.cumsum(a_len) - a_len)
        ptrs = (a.data_ptr(), b.data_ptr(), bw.data_ptr())
        out = torch.empty(int(a_len.sum()), dtype=torch.int32, device=dev)
        want = JC.join_count_segments(*args)

    def run():
        build.launch(name, *ptrs, table.data_ptr(), len(a_off), n_tiles, 0,
                     0, out.data_ptr())

    run()                         # sorted_intersect's sums start from zero
    if not torch.equal(out, want):
        raise AssertionError(f"{name}: the launch alone differs from the "
                             f"wrapper's result")
    ms, queued = queued_ms(run)
    if not queued:
        raise AssertionError(f"{name}: the host fell behind the card")
    return ms


def check_exact_checks(stats, fed_cps) -> dict:
    """Rows 5-6 (``sorted_intersect``, ``join_count``) as the main path
    runs them, one segmented launch per source pair: the largest pair's
    launch (most ids) against its segmented plain version, timed with and
    without the wrapper's table copy, with the compulsory bytes of the
    whole batch; every pair's launch timed, summed
    beside the bytes bound of all lists; and one single-list call (K = 1)
    at the longest exact check, timed as one launch per list was."""
    import torch

    from repro_torch.kernels import join_count as JC
    from repro_torch.kernels import sorted_intersect as SI

    batches = _pair_batches(stats, fed_cps, torch.device(DEVICE))
    rows = {"sorted_intersect": {}, "join_count": {}}
    total = {k: {"kernel_ms": 0.0, "bound_ms": 0.0} for k in rows}
    largest = longest = None
    for pair, args in batches:
        si_bytes, jc_bytes = _batch_bytes(args)
        ids = int(args[3].sum() + args[7].sum())
        for name, fn, a, nbytes in (
                ("sorted_intersect", SI.sorted_intersect_segments, args,
                 si_bytes),
                ("join_count", JC.join_count_segments, _jc_args(args),
                 jc_bytes)):
            ms, queued = queued_ms(lambda: fn(*a))
            if not queued:
                raise AssertionError(f"{name}: the host fell behind the card "
                                     f"at pair {pair}")
            total[name]["kernel_ms"] += ms
            total[name]["bound_ms"] += _bytes_bound(nbytes)[0]
        if largest is None or ids > largest[0]:
            largest = (ids, pair, args, si_bytes, jc_bytes)
        k = int((args[3] + args[7]).argmax())
        n = int(args[3][k] + args[7][k])
        if longest is None or n > longest[0]:
            longest = (n, args, k)
    ids, pair, args, si_bytes, jc_bytes = largest
    for name, kernel, plain, a, nbytes in (
            ("sorted_intersect", SI.sorted_intersect_segments,
             SI.sorted_intersect_segments_plain, args, si_bytes),
            ("join_count", JC.join_count_segments,
             JC.join_count_segments_plain, _jc_args(args), jc_bytes)):
        row = _time_kernel(name, kernel, plain, a)
        row.update(pair=list(pair), segments=len(args[2]),
                   ids=[int(args[3].sum()), int(args[7].sum())],
                   kernel_alone_ms=_kernel_alone_ms(name, a))
        row["bound_ms"], row["bound_by"] = _bytes_bound(nbytes)
        row["all_pairs"] = {"launches": len(batches),
                            "segments": sum(len(b[1][2]) for b in batches),
                            **total[name]}
        rows[name] = row
    # one list pair alone (K = 1): the longest exact check
    _, (e, m, a_off, a_len, s, ones, b_off, b_len), k = longest
    a = e[a_off[k]:a_off[k] + a_len[k]]
    aw = m[a_off[k]:a_off[k] + a_len[k]]
    b = s[b_off[k]:b_off[k] + b_len[k]]
    w = ones[:b.shape[0]]
    si_bytes, jc_bytes = _list_bytes(a, b)
    for name, kernel, plain, a1, nbytes in (
            ("sorted_intersect", SI.sorted_intersect,
             SI.sorted_intersect_plain, (a, aw, b, w), si_bytes),
            ("join_count", JC.join_count, JC.join_count_plain, (a, b, w),
             jc_bytes)):
        one = _time_kernel(name, kernel, plain, a1)
        one.update(shape=[a.shape[0], b.shape[0]],
                   bound_ms=_bytes_bound(nbytes)[0])
        rows[name]["single_list"] = one
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        one["max_abs_err"])
    return rows


def _bytes_bound(nbytes: int) -> "tuple[float, str]":
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def _seg_bitmap_extra(seg, bucket, n_seg) -> dict:
    """``seg_bitmap``'s shape, bound and library yardstick on one input:
    every segment read, a bucket only where its row is in the plane, the
    ``(n_seg, 128)`` float32 plane written once; ``torch.bincount`` over
    the in-plane rows' cells, timed (``library_ms``) and returned as
    ``library_out`` for the caller to hold against the kernel."""
    import torch

    ok = (seg >= 0) & (seg < n_seg)
    n_ok = int(ok.sum())
    key = (seg[ok].long() * 128 + bucket[ok].long()).contiguous()
    lib = torch.bincount(key, minlength=n_seg * 128)
    ms, lib_queued = queued_ms(
        lambda: torch.bincount(key, minlength=n_seg * 128))
    bound, by = _bytes_bound(4 * seg.shape[0] + 4 * n_ok + 4 * 128 * n_seg)
    return {"shape": [seg.shape[0], n_seg], "rows_in_plane": n_ok,
            "bound_ms": bound, "bound_by": by, "library_ms": ms,
            "library_queued": lib_queued,
            "library_out": lib.view(n_seg, 128).float()}


def _probe_extra(a_sig, b_sig) -> dict:
    """``summary_probe``'s shape, bound and form on one input: both
    signature blocks read once, the int32 output written once."""
    import torch

    from repro_torch.kernels import summary_probe as SP

    na, w = a_sig.shape
    nb = b_sig.shape[0]
    bound, by = _bytes_bound(4 * w * (na + nb) + 4 * na * nb)
    sms = torch.cuda.get_device_properties(a_sig.device).multi_processor_count
    return {"shape": [na, nb, w], "bound_ms": bound, "bound_by": by,
            "form": SP.form(na, nb, sms)}


class _Alg1Clock:
    """Host time of ``compute_federated_cps_ops``'s parts while installed:
    the signature probe calls (``_probe_ops``, each ending in its own copy
    back), the export-pair building (``_export_pairs``), the exact checks
    (``exact_check_segments``, the two segmented launches and
    ``_segment_sums``, closed by a device synchronisation so that their
    device time is theirs) and the CP tables (``_cp_rows``); the rest of
    the call is the exports' upload, the copy back of each pair's counts
    and the loop over the checks."""

    def __init__(self):
        from repro_torch.core import federation
        from repro_torch.kernels import ops

        self.sites = [(federation, "_probe_ops", "probe"),
                      (federation, "_export_pairs", "pairs"),
                      (federation, "exact_check_segments", "checks"),
                      (ops, "intersect_counts", "checks"),
                      (ops, "match_counts_segments", "checks"),
                      (federation, "_segment_sums", "checks"),
                      (federation, "_cp_rows", "cp_rows")]
        self.secs = {k: 0.0 for _, _, k in self.sites}
        self.calls = {k: 0 for _, _, k in self.sites}
        self.saved = []

    def _wrap(self, fn, part, sync):
        import torch

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            self.secs[part] += time.perf_counter() - t0
            self.calls[part] += 1
            return out
        return timed

    def __enter__(self):
        for mod, attr, part in self.sites:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, part, attr == "_segment_sums"))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)

    def split(self, total: float) -> dict:
        out = {f"{k}_s": v for k, v in self.secs.items()}
        out["copy_back_and_rest_s"] = total - sum(self.secs.values())
        out["total_s"] = total
        out["probe_calls"] = self.calls["probe"]
        return out


def check_stats(state: dict) -> None:
    """Each statistics kernel against its plain version on its largest
    main-path input, with device times of both (``queued_ms``), the
    wrapper's time per call, the compulsory-bytes bound of that input, and
    for ``seg_bitmap`` the one PyTorch call that computes the same counts
    (``torch.bincount``), timed as a yardstick only.  The list kernels'
    largest input is a source pair's segmented launch
    (``check_exact_checks``).  Also timed, each against its plain version:
    ``seg_bitmap`` on the main path's rows shuffled (``unordered``),
    ``summary_probe`` on a 1000 x 600 block of 512 words (``large``), and
    the launch floor, a queued ``torch.cuda._sleep(0)``
    (``launch_floor_ms``); and a third Algorithm 1 call split on the host
    clock (``algorithm1_split``, ``_Alg1Clock``)."""
    import numpy as np
    import torch

    from repro_torch.core.federation import (compute_federated_cps,
                                             compute_federated_cps_ops)
    from repro_torch.kernels import seg_bitmap as SB
    from repro_torch.kernels import summary_probe as SP

    stats, fed_cps, big_rows = state.pop("stats_run")
    # the host's own Algorithm 1 (numpy probe and np.intersect1d) over the
    # same pairs, for comparison with the card's (``algorithm1_s``)
    t0 = time.perf_counter()
    for i, j in fed_cps:
        compute_federated_cps(stats.exports[i], stats.exports[j],
                              stats.summaries[i], stats.summaries[j])
    state["stats"]["host_algorithm1_s"] = time.perf_counter() - t0
    # the card's Algorithm 1 again: the main path's call is the process's
    # first use of several PyTorch operations and kernels, whose modules
    # load at first launch; a long-lived statistics service pays that once
    t0 = time.perf_counter()
    warm = compute_federated_cps_ops(stats.exports, stats.summaries,
                                     device=DEVICE)
    state["stats"]["algorithm1_warm_s"] = time.perf_counter() - t0
    _algorithm1_checks(stats, warm)
    with _Alg1Clock() as clock:
        t0 = time.perf_counter()
        split = compute_federated_cps_ops(stats.exports, stats.summaries,
                                          device=DEVICE)
        total = time.perf_counter() - t0
    _algorithm1_checks(stats, split)
    state["stats"]["algorithm1_split"] = clock.split(total)
    keep = _largest_calls(stats, fed_cps, big_rows, torch.device(DEVICE))
    rows = check_exact_checks(stats, fed_cps)
    seg, bucket, n_seg = keep["seg_bitmap"]
    # the main path's rows shuffled: the same counts from rows in no order
    g = torch.Generator(device=DEVICE).manual_seed(SHAPE_SEED)
    perm = torch.randperm(seg.shape[0], generator=g, device=DEVICE)
    unordered = (seg[perm].contiguous(), bucket[perm].contiguous(), n_seg)
    rng = np.random.default_rng(SHAPE_SEED)
    large = [torch.from_numpy(rng.integers(-2**31, 2**31, (n, 512)).astype(
        np.int32)).to(DEVICE) for n in (1000, 600)]
    for name, kernel, plain in (
            ("seg_bitmap", SB.seg_bitmap, SB.seg_bitmap_plain),
            ("summary_probe", SP.summary_probe, SP.summary_probe_plain)):
        args = keep[name]
        row = _time_kernel(name, kernel, plain, args)
        if name == "seg_bitmap":
            row.update(_seg_bitmap_extra(*args))
            if not torch.equal(row.pop("library_out"), kernel(*args)):
                raise AssertionError("torch.bincount disagrees with seg_bitmap")
            # the same rows in no order: the kernel's unordered path
            row["unordered"] = _time_kernel(name, kernel, plain, unordered)
            extra = _seg_bitmap_extra(*unordered)
            extra.pop("library_out")
            row["unordered"].update(extra)
            for r, a in ((row, args), (row["unordered"], unordered)):
                r["path"] = SB.seg_bitmap_path(*a)[1]
                if r["path"] != seg_path(a[0], n_seg):
                    raise AssertionError(f"seg_bitmap took its {r['path']} "
                                         f"path on {seg_path(a[0], n_seg)} "
                                         f"rows")
        else:
            row.update(_probe_extra(*args))
            # a block above the form threshold (stats_kernel_cases' largest)
            row["large"] = _time_kernel(name, kernel, plain, large)
            row["large"].update(_probe_extra(*large))
        rows[name] = row
    # the least time of a launch: a device sleep of 0 cycles, queued
    rows["launch_floor_ms"], _ = queued_ms(lambda: torch.cuda._sleep(0))
    state["stats_kernels"] = rows
    emit("stats", nvidia_smi=state["smi"], **state["stats"], kernels=rows)


# --------------------------------------------------------------------------
# baselines and failover: the paper's comparison (benchmarks/common.py) and
# the fault-tolerance path on the comparison's own fixture
# --------------------------------------------------------------------------

# transferred tuples (NTT) of each engine over the comparison's 25 queries,
# as the reference's ``benchmarks.common.run_all(1.0, repeats=1)`` counts
# them; counts, so they do not depend on the device
REF_NTT = {"Odyssey": 25502, "FedX-Cold": 29995, "FedX-Warm": 29995,
           "HiBISCuS": 25213, "DP-VOID": 92480, "SPLENDID": 92480,
           "Odyssey-FedX": 24564, "FedX-Odyssey": 25502}
DP_ENGINES = ("Odyssey", "FedX-Odyssey")     # the two that run the exact DP
HUB = "DBpedia"                              # the source failover kills


def comparison_fixture():
    """``benchmarks/common.py``'s ``fixture(1.0)`` over the port: FedBench
    scale 1.0 (seed 7), its statistics, and 25 queries named after the
    paper's groups (LS star, CD hybrid, LD path)."""
    from repro_torch.core.federation import build_federated_stats
    from repro_torch.rdf.generator import (fedbench_like_spec,
                                           generate_federation,
                                           generate_workload)

    fed, gt = generate_federation(fedbench_like_spec(scale=1.0, seed=7))
    stats = build_federated_stats(fed)
    queries = generate_workload(fed, gt, n_star=11, n_hybrid=7, n_path=7,
                                seed=13)
    for q in queries:
        q.name = (q.name.replace("ST", "LS").replace("HY", "CD")
                  .replace("PA", "LD"))
    return fed, stats, queries


def make_optimizers(fed, stats, **dp) -> dict:
    """``benchmarks/common.py``'s ``make_optimizers`` over the port's
    classes, Odyssey's plan cache off; ``dp`` (``dp_backend``, ``device``)
    goes to the two DP engines, which otherwise keep their defaults (the
    torch DP on cuda)."""
    from repro_torch.baselines import (FedXOdyssey, FedXOptimizer,
                                       HibiscusOptimizer, OdysseyFedX,
                                       VoidDPOptimizer)
    from repro_torch.core.planner import OdysseyOptimizer

    return {
        "Odyssey": OdysseyOptimizer(stats, plan_cache_size=0, **dp),
        "FedX-Cold": FedXOptimizer(fed, warm=False),
        "FedX-Warm": FedXOptimizer(fed, warm=True),
        "HiBISCuS": HibiscusOptimizer(fed),
        "DP-VOID": VoidDPOptimizer(fed),
        "SPLENDID": VoidDPOptimizer(fed, use_ask=True),
        "Odyssey-FedX": OdysseyFedX(stats),
        "FedX-Odyssey": FedXOdyssey(stats, fed, **dp),
    }


def answer_set(res, q) -> set:
    """The projected answer set of an execution, as ``naive_evaluate``
    returns it."""
    rel = res.rows
    proj = q.effective_projection()
    n = len(next(iter(rel.values()))) if rel else 0
    return set(zip(*[rel[v].tolist() for v in proj])) if n else set()


def _sweeps(jo, before: dict) -> int:
    return sum(jo.DP_SWEEP_COUNTERS[k] - before[k]
               for k in ("resident", "tiled"))


def phase_baselines(state: dict) -> None:
    """The paper's comparison on the main path: each query enters as SPARQL
    text (``parse_sparql`` of its serialization, as the quickstart does),
    and all eight engines of ``make_optimizers`` plan and execute it once
    through ``LocalEngine``; every answer equals ``naive_evaluate`` and each
    engine's NTT equals the reference's.  The plan comparisons with the
    numpy backend run in ``check_baselines``, outside the counted window."""
    from repro_torch.core import join_order as jo
    from repro_torch.engine.local import LocalEngine, naive_evaluate
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.query import parse_sparql
    from repro_torch.query.sparql import serialize_sparql

    t0 = time.perf_counter()
    fed, stats, queries = comparison_fixture()
    d = fed.dictionary
    parsed = []
    for q in queries:
        p = parse_sparql(serialize_sparql(q, d), d)
        p.name = q.name
        if p != q:
            raise AssertionError(f"{q.name}: the SPARQL round trip differs")
        parsed.append(p)
    want = [naive_evaluate(fed, q) for q in parsed]
    setup_s = time.perf_counter() - t0

    opts = make_optimizers(fed, stats)
    for name in DP_ENGINES:
        if (opts[name].dp_backend, opts[name].device) != ("torch", DEVICE):
            raise AssertionError(f"{name} must plan on cuda by default")
    eng = LocalEngine(fed)
    rows = {name: dict(opt_ms=0.0, plan_ms=0.0, exec_ms=0.0, nss=0, nsq=0,
                       ntt=0, requests=0) for name in opts}
    plans: dict = {name: [] for name in DP_ENGINES}
    odyssey: dict = {}      # per query: LocalEngine's exec_ms and NTT
    before, l0 = dict(jo.DP_SWEEP_COUNTERS), LAUNCHES["dp_sweep"]
    for q, w in zip(parsed, want):
        for name, opt in opts.items():
            t1 = time.perf_counter()
            plan = opt.optimize(q)
            t2 = time.perf_counter()
            res = eng.execute(plan)
            t3 = time.perf_counter()
            if answer_set(res, q) != w:
                raise AssertionError(f"{name}:{q.name}: answers differ from "
                                     f"the oracle")
            r = rows[name]
            r["opt_ms"] += plan.optimization_ms
            r["plan_ms"] += (t2 - t1) * 1e3
            r["exec_ms"] += (t3 - t2) * 1e3
            r["nss"] += plan.n_selected_sources
            r["nsq"] += plan.n_subqueries
            r["ntt"] += res.metrics.transferred_tuples
            r["requests"] += res.metrics.requests
            if name in plans:
                plans[name].append(plan)
            if name == "Odyssey":
                odyssey[q.name] = dict(exec_ms=(t3 - t2) * 1e3,
                                       ntt=res.metrics.transferred_tuples)
    sweeps, launches = _sweeps(jo, before), LAUNCHES["dp_sweep"] - l0
    if sweeps == 0 or launches == 0:
        raise AssertionError("no comparison query reached dp_sweep")
    for name, opt in opts.items():
        rows[name]["ask_count"] = getattr(opt, "ask_count", None)
        rows[name]["ref_ntt"] = REF_NTT[name]
        if rows[name]["ntt"] != REF_NTT[name]:
            raise AssertionError(f"{name}: NTT {rows[name]['ntt']} against "
                                 f"the reference's {REF_NTT[name]}")
    state["baselines_run"] = (fed, stats, parsed, want, plans)
    state["baselines_odyssey"] = odyssey
    state["baselines"] = dict(
        queries=len(parsed), runs=len(parsed) * len(opts), complete=True,
        setup_s=setup_s, dp_sweeps=sweeps, dp_sweep_launches=launches,
        engines=rows)


def check_baselines(state: dict) -> None:
    """Odyssey's and FedX-Odyssey's card plans against the numpy backend's,
    node for node; then one line per engine."""
    fed, stats, parsed, _, plans = state["baselines_run"]
    opts = make_optimizers(fed, stats, dp_backend="numpy")
    for name in DP_ENGINES:
        for q, plan in zip(parsed, plans[name]):
            same_plan(plan, opts[name].optimize(q), f"{name}:{q.name}")
    b = state["baselines"]
    for name, row in b["engines"].items():
        emit("baselines", engine=name, queries=b["queries"],
             card_plans_equal_numpy=name in DP_ENGINES or None, **row)
    emit("baselines", engine="all", **{k: v for k, v in b.items()
                                       if k != "engines"})


def _recorded(session, log: list):
    """Log every plan ``session``'s optimizer emits (``optimize`` and
    ``optimize_batch``), in order, for the replay on the numpy backend."""
    opt = session.optimizer
    one, batch = opt.optimize, opt.optimize_batch

    def optimize(q):
        plan = one(q)
        log.append(("optimize", [plan]))
        return plan

    def optimize_batch(qs):
        out = batch(qs)
        log.append(("optimize_batch", list(out)))
        return out

    opt.optimize, opt.optimize_batch = optimize, optimize_batch
    return session


def failover_scenario(fed, stats, queries, want, survivors_want, **dp):
    """Steps (a)-(e) of the failover phase on ``fed``, every source wrapped
    in a ``FlakySource``; sessions plan with ``dp`` (their defaults when
    empty).  Returns ``(rows, logs)``: per step its counts and host time,
    and every plan its sessions emitted."""
    from repro_torch.core import join_order as jo
    from repro_torch.ft.failover import (FailoverSession, FlakySource,
                                         execute_with_failover)
    from repro_torch.ft.resilience import RetryPolicy
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.rdf.dataset import Federation

    def flaky(**kw_of):
        srcs = [FlakySource(s, **kw_of.get(s.name, {})) for s in fed.sources]
        return Federation(srcs, fed.dictionary), {s.name: s for s in srcs}

    def check(res, i, partial_want, step):
        exp = survivors_want[i] if res.partial else want[i]
        if answer_set(res, queries[i]) != exp:
            raise AssertionError(f"failover {step}: {queries[i].name}: "
                                 f"answers differ from the oracle")
        if res.partial != partial_want(res) or (
                res.partial and res.excluded != [HUB]):
            raise AssertionError(f"failover {step}: {queries[i].name}: "
                                 f"partial {res.partial}, excluded "
                                 f"{res.excluded}")

    rows: dict = {}
    logs: dict = {k: [] for k in "abcde"}

    def step(key, fn):
        before, l0 = dict(jo.DP_SWEEP_COUNTERS), LAUNCHES["dp_sweep"]
        t0 = time.perf_counter()
        res, extra = fn()
        rows[key] = dict(
            seconds=time.perf_counter() - t0,
            replans=sum(r.replans for r in res),
            salvages=sum(r.salvages for r in res),
            rerouted=sum(len(r.rerouted) for r in res),
            partial=sum(r.partial for r in res),
            dp_sweeps=_sweeps(jo, before),
            dp_sweep_launches=LAUNCHES["dp_sweep"] - l0, **extra)
        return res

    def transient():           # (a) one transient failure per source
        fl, srcs = flaky(**{s.name: {"fail_times": 1} for s in fed.sources})
        sleeps: list = []
        session = _recorded(FailoverSession(
            fl, stats, retry=RetryPolicy(max_attempts=3, base_delay_s=0.0,
                                         sleep=sleeps.append), **dp),
            logs["a"])
        res = [session.execute(q) for q in queries]
        for i, r in enumerate(res):
            check(r, i, lambda r: False, "a")
        if not sleeps:
            raise AssertionError("failover a: no transient failure was retried")
        return res, dict(retries=len(sleeps),
                         hub_tuples=srcs[HUB].tuples_served)

    step("a", transient)
    hub_tuples = rows["a"]["hub_tuples"]

    def salvage():             # (b) the hub dead, salvaged mid-query
        fl, _ = flaky(**{HUB: {"dead": True}})
        res = []
        for q in queries:
            session = _recorded(FailoverSession(fl, stats, **dp), logs["b"])
            res.append(execute_with_failover(fl, stats, q, session=session))
        for i, r in enumerate(res):
            check(r, i, lambda r: r.salvages > 0, "b")
            if r.replans:
                raise AssertionError("failover b: a salvaged query replanned")
        if not any(r.salvages for r in res):
            raise AssertionError("failover b: no query touched the hub")
        return res, {}

    res_b = step("b", salvage)

    def replan():              # (c) the same, exclude and replan
        fl, _ = flaky(**{HUB: {"dead": True}})
        res, swept = [], 0
        for q in queries:
            session = _recorded(FailoverSession(fl, stats, salvage=False,
                                                **dp), logs["c"])
            before = dict(jo.DP_SWEEP_COUNTERS)
            res.append(session.execute(q))
            # a multi-star query sweeps for its plan and for its replan
            swept += bool(res[-1].replans) and _sweeps(jo, before) == 2
        for i, (r, rb) in enumerate(zip(res, res_b)):
            check(r, i, lambda r: r.replans > 0, "c")
            if r.salvages or (answer_set(r, queries[i])
                              != answer_set(rb, queries[i])):
                raise AssertionError(f"failover c: {queries[i].name} differs "
                                     f"from its salvaged answer")
        return res, dict(replans_through_dp=swept)

    step("c", replan)

    fl_d, srcs_d = flaky(**{HUB: {"die_after_tuples": hub_tuples // 2}})
    session_d = _recorded(FailoverSession(fl_d, stats, **dp), logs["d"])

    def mid_batch():           # (d) the hub dies inside execute_batch
        res = session_d.execute_batch(queries)
        kill = next((i for i, r in enumerate(res) if r.salvages), None)
        batches = [len(p) for kind, p in logs["d"] if kind == "optimize_batch"]
        if (kill is None or session_d.excluded != [HUB]
                or batches != [len(queries), len(queries) - kill - 1]):
            raise AssertionError(f"failover d: death at {kill}, batches "
                                 f"{batches}, excluded {session_d.excluded}")
        for i, r in enumerate(res):
            check(r, i, lambda r, i=i: i >= kill, "d")
        return res, dict(die_after_tuples=hub_tuples // 2, struck=kill,
                         kept=kill, replanned_batch=batches[1])

    step("d", mid_batch)

    def restore():             # (e) the hub back
        hub = srcs_d[HUB]
        hub.dead, hub.die_after_tuples = False, None
        epoch = session_d.stats.epoch
        sid = session_d.restore(HUB)
        res = session_d.execute_batch(queries)
        for i, r in enumerate(res):
            check(r, i, lambda r: False, "e")
        if session_d.stats.epoch <= epoch or sid != len(fed.sources) - 1:
            raise AssertionError("failover e: restore did not bump the epoch")
        return res, dict(epoch_before=epoch, epoch=session_d.stats.epoch)

    step("e", restore)
    return rows, logs


def phase_failover(state: dict) -> None:
    """The fault-tolerance path on the comparison's federation, sessions
    planning on the card (their defaults): (a) a transient failure per
    source healed by retry, (b) the hub dead with mid-query salvage, (c)
    the same with exclude-and-replan, (d) the hub dying mid-scan inside an
    ``execute_batch`` over the 25 queries, (e) the hub restored.  The replay
    on the numpy backend runs in ``check_failover``."""
    from repro_torch.engine.local import naive_evaluate
    from repro_torch.ft.failover import FailoverSession
    from repro_torch.rdf.dataset import Federation

    fed, stats, parsed, want, _ = state["baselines_run"]
    dev = FailoverSession(fed, stats).optimizer
    if (dev.dp_backend, dev.device) != ("torch", DEVICE):
        raise AssertionError("FailoverSession must plan on cuda by default")
    t0 = time.perf_counter()
    survivors = Federation([s for s in fed.sources if s.name != HUB],
                           fed.dictionary)
    survivors_want = [naive_evaluate(survivors, q) for q in parsed]
    oracle_s = time.perf_counter() - t0
    rows, logs = failover_scenario(fed, stats, parsed, want, survivors_want)
    if rows["c"]["replans_through_dp"] == 0 or rows["c"]["dp_sweep_launches"] == 0:
        raise AssertionError("failover c: no replan reached dp_sweep")
    for k in "de":
        if rows[k]["dp_sweep_launches"] == 0:
            raise AssertionError(f"failover {k}: dp_sweep never launched")
    state["failover_run"] = (survivors_want, logs)
    state["failover"] = dict(queries=len(parsed), killed=HUB,
                             survivor_oracle_s=oracle_s, steps=rows)


def check_failover(state: dict) -> None:
    """The whole failover scenario again on the numpy backend: every plan
    and replan of every step equal to the card's, node for node."""
    fed, stats, parsed, want, _ = state.pop("baselines_run")
    survivors_want, logs = state.pop("failover_run")
    t0 = time.perf_counter()
    _, np_logs = failover_scenario(fed, stats, parsed, want, survivors_want,
                                   dp_backend="numpy")
    n = 0
    for k in "abcde":
        if [(kind, len(p)) for kind, p in logs[k]] != [
                (kind, len(p)) for kind, p in np_logs[k]]:
            raise AssertionError(f"failover {k}: the numpy replay planned "
                                 f"other batches")
        for (_, got), (_, ref) in zip(logs[k], np_logs[k]):
            for a, b in zip(got, ref):
                same_plan(a, b, f"failover {k}: {a.query.name}")
                n += 1
    emit("failover", **state["failover"], plans_equal_numpy=n,
         numpy_replay_s=time.perf_counter() - t0)


# --------------------------------------------------------------------------
# spmd: the SPMD federation executor, the whole (9, 4) mesh on the card
# --------------------------------------------------------------------------

SPMD_MESH = (9, 4)          # one FedBench source per data shard, 4 model shards
SPMD_SCALE = 10.0           # (b): fedbench_like_spec scale, 1,068,934 triples
# (cell, cap, partition_aware, held to the CPU port outside the window)
SPMD_CELLS = (("a_gather", 4096, False, True), ("a_aware", 4096, True, True),
              ("b", 32768, True, True), ("c", 4096, True, False))
SPMD_NAMED = ("CD1", "CD6")   # ROADMAP queue 1 item 11's HY1 and HY6


def _spmd_run(fed, queries, plans, cap: int, aware: bool, device: str,
              passes: int = 2) -> dict:
    """Every plan through ``DistributedEngine`` on a ``SPMD_MESH`` mesh on
    ``device``, ``passes`` times; per query the last pass's result, time
    (host clock, closed by a device sync) and host syncs.  A plan with the
    planner's variable-predicate fallback is skipped, with its reason; any
    other failure raises."""
    import torch
    from repro_torch.engine.distributed import DistributedEngine
    from repro_torch.launch.mesh import make_test_mesh

    def sync():
        if device != "cpu":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    eng = DistributedEngine(fed, make_test_mesh(SPMD_MESH, device=device),
                            cap=cap, partition_aware=aware)
    sync()
    if eng.tables.device.type != torch.device(device).type:
        raise AssertionError(f"the engine's tables are on {eng.tables.device}")
    run = dict(engine_s=time.perf_counter() - t0, table_cap=eng.table_cap,
               table_bytes=eng.tables.numel() * eng.tables.element_size(),
               results={}, first={}, ms={}, first_ms={}, syncs={}, skipped={})
    for p in range(passes):
        for q, plan in zip(queries, plans):
            if plan.fallback:
                run["skipped"][q.name] = "fallback: variable predicate"
                continue
            sync()
            t1 = time.perf_counter()
            res = eng.execute(plan)
            sync()
            ms = (time.perf_counter() - t1) * 1e3
            if p == 0:
                run["first_ms"][q.name] = ms
                run["first"][q.name] = res
            run["ms"][q.name] = ms
            run["syncs"][q.name] = res.metrics.host_syncs
            run["results"][q.name] = res
    return run


def _same_results(got: dict, want: dict, what: str) -> None:
    """Rows (columns, order, dtype, bytes) and ``DistMetrics`` equal."""
    if list(got) != list(want):
        raise AssertionError(f"spmd {what}: other queries ran")
    for name, res in got.items():
        ref = want[name]
        if list(res.rows) != list(ref.rows) or any(
                res.rows[v].dtype != ref.rows[v].dtype
                or res.rows[v].tobytes() != ref.rows[v].tobytes()
                for v in res.rows) or res.metrics != ref.metrics:
            raise AssertionError(f"spmd {what}: {name} differs")


def phase_spmd(state: dict) -> None:
    """The SPMD executor on the card, the whole ``(9, 4)`` mesh resident:
    (a) the ``fedbench`` phase's federation and card plans, the build side
    gathered over the whole mesh and then partition-aware; (b) FedBench at
    scale 10, planned on the card; (c) the ``baselines`` phase's Odyssey
    plans.  No result overflows; the answers of (a) and (c) equal
    ``naive_evaluate`` (which the host engine's equal).  The CPU port's runs
    of (a) and (b) are in ``check_spmd``, outside the counted window."""
    import torch
    from repro_torch.core.federation import build_federated_stats
    from repro_torch.core.planner import OdysseyOptimizer
    from repro_torch.rdf.generator import (fedbench_like_spec,
                                           generate_federation,
                                           generate_workload)

    t0 = time.perf_counter()
    fed_a = state["fedbench_fs"][0]
    _, q_a, _, plans_a = state["fedbench_run"]
    want_a, _ = state["fedbench_spmd"]
    fed_c, _, q_c, want_c, dp_plans = state["baselines_run"]
    fed_b, gt_b = generate_federation(fedbench_like_spec(scale=SPMD_SCALE))
    stats_b = build_federated_stats(fed_b)
    q_b = generate_workload(fed_b, gt_b, seed=5)
    setup_b_s = time.perf_counter() - t0
    opt_b = OdysseyOptimizer(stats_b)                 # torch DP on cuda
    if (opt_b.dp_backend, opt_b.device) != ("torch", DEVICE):
        raise AssertionError("the default optimizer must run on cuda")
    t1 = time.perf_counter()
    plans_b = [opt_b.optimize(q) for q in q_b]
    plan_b_s = time.perf_counter() - t1
    inputs = {"a_gather": (fed_a, q_a, plans_a, want_a),
              "a_aware": (fed_a, q_a, plans_a, want_a),
              "b": (fed_b, q_b, plans_b, None),
              "c": (fed_c, q_c, dp_plans["Odyssey"], want_c)}
    runs = {}
    for cell, cap, aware, _ in SPMD_CELLS:
        fed, qs, plans, want = inputs[cell]
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run = _spmd_run(fed, qs, plans, cap, aware, DEVICE)
        run["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        run["memory_allocated_before"] = mem0
        _same_results(run["results"], run.pop("first"), f"{cell}: the passes")
        for i, q in enumerate(qs):
            res = run["results"].get(q.name)
            if res is None:
                continue
            if res.metrics.overflowed:
                raise AssertionError(f"spmd {cell}: {q.name} overflowed")
            if want is not None and answer_set(res, q) != want[i]:
                raise AssertionError(f"spmd {cell}: {q.name}: answers differ "
                                     f"from the oracle")
        runs[cell] = run
    state["spmd_run"] = (inputs, runs)
    state["spmd"] = dict(seconds=time.perf_counter() - t0, setup_b_s=setup_b_s,
                         plan_b_s=plan_b_s, triples_b=fed_b.total_triples())


def _spmd_trace(fed, plans, cap: int, aware: bool) -> dict:
    """One warm pass of the cell's plans under ``torch.profiler``: the
    kernels' summed device time against the pass's host-clock time (the
    device's busy share), and the operators and kernels that take the most
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine.distributed import DistributedEngine
    from repro_torch.launch.mesh import make_test_mesh

    eng = DistributedEngine(fed, make_test_mesh(SPMD_MESH, device=DEVICE),
                            cap=cap, partition_aware=aware)
    run = [p for p in plans if not p.fallback]
    for plan in run:
        eng.execute(plan)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for plan in run:
            eng.execute(plan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    ops = {a.key: a.self_device_time_total / 1e3 for a in prof.key_averages()
           if a.device_type == DeviceType.CPU and a.self_device_time_total > 0}
    device_ms = sum(kernels.values())

    def top(d):
        return sorted(([k[:80], v] for k, v in d.items()), key=lambda kv: -kv[1])[:8]

    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if wall_ms else None,
                kernel_launches=sum(1 for e in prof.events()
                                    if e.device_type == DeviceType.CUDA),
                top_ops_ms=top(ops), top_kernels_ms=top(kernels))


def check_spmd(state: dict) -> None:
    """The card's rows and ``DistMetrics`` of (a) and (b) against the CPU
    port's at the same mesh and ``cap``; then one line per cell, with the
    host engine's times on the same plans for (a) and (c)."""
    inputs, runs = state.pop("spmd_run")
    _, host_a = state.pop("fedbench_spmd")
    host_c = state.pop("baselines_odyssey")
    for cell, cap, aware, on_cpu in SPMD_CELLS:
        fed, qs, plans, want = inputs[cell]
        run = runs[cell]
        cpu_s = None
        if on_cpu:
            t0 = time.perf_counter()
            cpu = _spmd_run(fed, qs, plans, cap, aware, "cpu", passes=1)
            cpu_s = time.perf_counter() - t0
            _same_results(run["results"], cpu["results"], f"{cell}: card vs cpu")
        res = run.pop("results")
        m = {k: r.metrics for k, r in res.items()}
        line = dict(
            cell=cell, mesh=list(SPMD_MESH), cap=cap, partition_aware=aware,
            table_cap=run["table_cap"], table_bytes=run["table_bytes"],
            triples=fed.total_triples(), queries=len(qs), run=len(res),
            skipped=run["skipped"],
            transferred_tuples=sum(x.transferred_tuples for x in m.values()),
            collective_bytes=sum(x.collective_bytes for x in m.values()),
            overflowed=sum(x.overflowed for x in m.values()),
            oracle="naive_evaluate" if want is not None else "cpu port",
            rows_equal_cpu=on_cpu, cpu_s=cpu_s,
            warm_ms_total=sum(run["ms"].values()),
            first_ms_total=sum(run["first_ms"].values()),
            host_syncs_total=sum(run["syncs"].values()),
            engine_s=run["engine_s"],
            max_memory_allocated=run["max_memory_allocated"],
            memory_allocated_before=run["memory_allocated_before"],
            per_query={k: dict(warm_ms=run["ms"][k], host_syncs=run["syncs"][k],
                               transferred_tuples=m[k].transferred_tuples,
                               rows=len(next(iter(res[k].rows.values()), ())))
                       for k in res},
            nvidia_smi=state["smi"])
        if cell.startswith("a"):
            line["host_exec_ms_total"] = sum(host_a[k] for k in res)
            for k in res:
                line["per_query"][k]["host_exec_ms"] = host_a[k]
        if cell in ("a_aware", "b"):
            line["trace"] = _spmd_trace(fed, plans, cap, aware)
        if cell == "c":
            line["host_exec_ms_total"] = sum(host_c[k]["exec_ms"] for k in res)
            for k in res:
                line["per_query"][k]["host_exec_ms"] = host_c[k]["exec_ms"]
                line["per_query"][k]["host_ntt"] = host_c[k]["ntt"]
            line["named"] = {k: line["per_query"][k] for k in SPMD_NAMED}
        emit("spmd", **line)
    emit("spmd", cell="all", **state["spmd"])


# --------------------------------------------------------------------------
# lm: the serving path of the LM substrate at full width
# --------------------------------------------------------------------------

# (arch, engine slots, cache length, requests, prompt lengths drawn in
# [lo, hi], new tokens per request)
LM_CELLS = (("qwen2-0.5b", 4, 4096, 8, (512, 3072), 32),
            ("falcon-mamba-7b", 2, 2048, 4, (256, 1024), 16))
LM_SEED = 13
# float32 logits of two runs that sum in different orders (prefill through
# the kernels against token-by-token decode through the plain path):
# |a - b| <= LOGIT_ATOL + LOGIT_RTOL * |b|; a top-2 gap under the same bound
# is a near-tie, where the greedy tokens may split
LOGIT_ATOL = LOGIT_RTOL = 1e-3
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_flash_attention.py:38-39
SCAN_TOL = 2e-4                                    # tests/test_ssm_kernel.py:31-32
SCAN_SEQ = 1024
FLASH_WINDOW = 1024
FP32_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
# H100 SXM, 132 SMs at the 1.98 GHz boost clock: the FP32 pipe issues 128
# instructions per SM per clock (FP32_OPS_PER_S counts a multiply-add as
# two), the special-function units 16 exponentials (MUFU.EX2).  An
# exponential can also run on the FP32 pipe as a polynomial: a rounding and
# a degree-3 Horner step, 4 instructions (the exponent's shift is integer
# work, on its own pipe).
FP32_INSTR_PER_S = 128 * 132 * 1.98e9
EXP_PER_S = 16 * 132 * 1.98e9
EXP_POLY_INSTR = 4
BF16_OPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12   # H100 SXM TF32 tensor cores, dense
LM_KERNELS = (("flash_attention", "src/repro/kernels/flash_attention.py:79"),
              ("ssm_scan", "src/repro/kernels/ssm_scan.py:64"))
# keys of an LM kernel's row carried into the summary line beside the common
# ones (flash: its route's bound, the float32 CUDA-core bound, bf16 timings)
LM_EXTRA_KEYS = ("bound_route", "fp32_cuda_core_bound_ms", "bf16_ms",
                 "bf16_library_ms", "bf16_bound_ms", "bf16_max_abs_err",
                 "longest_prompt")


class _StageClock:
    """Host time of the engine's prefill and decode calls, each closed by a
    device synchronisation: wraps the model module's two entry points (the
    engine calls them through the module) while installed."""

    def __init__(self, mdl):
        self.mdl = mdl
        self.s = {"prefill": 0.0, "decode": 0.0}
        self.n = {"prefill": 0, "decode": 0}
        self.orig = (mdl.prefill_with_caches, mdl.decode_step)

    def _wrap(self, stage, fn):
        import torch

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.s[stage] += time.perf_counter() - t0
            self.n[stage] += 1
            return out
        return timed

    def __enter__(self):
        self.mdl.prefill_with_caches = self._wrap("prefill", self.orig[0])
        self.mdl.decode_step = self._wrap("decode", self.orig[1])
        return self

    def __exit__(self, *exc):
        self.mdl.prefill_with_caches, self.mdl.decode_step = self.orig


def _lm_prompts(cfg, n_req: int, lo: int, hi: int):
    import numpy as np

    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(lo, hi + 1, n_req)
    return [rng.integers(1, cfg.vocab, int(n)).tolist() for n in lens]


def _serve(cfg, params, prompts, n_slots: int, ctx: int, max_new: int,
           use_prefill: bool):
    """Serve ``prompts`` on a fresh engine; (finished requests by rid, wall
    seconds, stage clock)."""
    import torch

    from repro_torch.models import model as MDL
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, params, n_slots=n_slots, ctx_len=ctx,
                      use_prefill=use_prefill, device=DEVICE,
                      keep_logits=True)
    torch.cuda.synchronize()
    with _StageClock(MDL) as clock:
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=list(p), max_new=max_new))
        done = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if len(done) != len(prompts):
        raise AssertionError(f"{len(done)} of {len(prompts)} requests served")
    return sorted(done, key=lambda r: r.rid), wall, clock, eng


def phase_lm(state: dict) -> None:
    """Serve each LM configuration at its published width once, with
    prefill admission (the flash attention kernel in qwen2's 24 layers, the
    selective-scan kernel in falcon-mamba's 64), weights drawn on the card
    from a seeded generator.  The token-by-token comparison, the kernels'
    checks and their timings run later, in ``check_lm``."""
    import gc

    import torch

    from repro_torch.configs import get_arch

    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("lm_setup", allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
         float32_matmul_precision=torch.get_float32_matmul_precision(),
         device_bytes_in_use=torch.cuda.memory_allocated())
    state["lm_runs"], state["lm"] = [], {}
    for arch, n_slots, ctx, n_req, (lo, hi), max_new in LM_CELLS:
        cfg = get_arch(arch)
        params, t_init = _init_on_card(cfg)
        prompts = _lm_prompts(cfg, n_req, lo, hi)
        done, row = _serve_row(cfg, params, prompts, n_slots, ctx, max_new,
                               use_prefill=True)
        _check_launches(arch, row["launches"], cfg, prefills=len(prompts))
        state["lm"][arch] = dict(layers=cfg.n_layers, depth_cut=False,
                                 d_model=cfg.d_model, init_s=t_init, **row)
        emit("lm", model=arch, nvidia_smi=state["smi"], **state["lm"][arch])
        state["lm_runs"].append((cfg, params, prompts, done, n_slots, ctx,
                                 max_new))


def _init_on_card(cfg):
    """float32 params of ``cfg`` drawn on the card from ``LM_SEED``, and the
    seconds it took."""
    import torch

    from repro_torch.models import model as MDL

    gen = torch.Generator(device=DEVICE).manual_seed(LM_SEED)
    t0 = time.perf_counter()
    params = MDL.init_params(cfg, gen, torch.float32, DEVICE)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def _kernel_layers(cfg) -> dict:
    """Launches one full-sequence pass of ``cfg`` makes: one flash launch per
    attention layer (for enc-dec, the encoder's layers too), one scan launch
    per Mamba layer; MLA attends without the flash kernel."""
    mamba = sum(cfg.mixer_of(i) == "m" for i in range(cfg.n_layers))
    attn = 0 if cfg.mla is not None else cfg.n_layers - mamba
    return {"flash_attention": attn + (cfg.enc_layers if cfg.encdec else 0),
            "ssm_scan": mamba}


def _check_launches(what: str, launches: dict, cfg, prefills: int = 0,
                    forwards: int = 0) -> dict:
    """The LM kernels' launches of a run against the layers of their kind
    times the full-sequence passes (prefills, and forwards, which for
    enc-dec also run the encoder); returns the expected counts."""
    per = _kernel_layers(cfg)
    dec = dict(per, flash_attention=per["flash_attention"]
               - (cfg.enc_layers if cfg.encdec else 0))
    want = {k: dec[k] * prefills + per[k] * forwards for k in per}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    return want


def _serve_row(cfg, params, prompts, n_slots: int, ctx: int, max_new: int,
               use_prefill: bool):
    """Serve ``prompts`` once on a fresh engine, with the launch counts read
    around it: (finished requests by rid, the run's line: sizes, times,
    rates, peak memory, launches)."""
    import torch

    from repro_torch.kernels.build import LAUNCHES

    l0 = dict(LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    done, wall, clock, eng = _serve(cfg, params, prompts, n_slots, ctx,
                                    max_new, use_prefill=use_prefill)
    peak = torch.cuda.max_memory_allocated()
    launches = {k: LAUNCHES[k] - l0[k] for k in LAUNCHES}
    for r in done:
        if len(r.out) != max_new or not all(0 <= t < cfg.vocab
                                            for t in r.out):
            raise AssertionError(f"{cfg.name}: request {r.rid} gave {r.out}")
        if not all(bool(torch.isfinite(x).all()) for x in r.logits):
            raise AssertionError(f"{cfg.name}: non-finite logits")
    n_prefill = sum(len(p) for p in prompts) if clock.n["prefill"] else 0
    n_gen = sum(len(r.out) for r in done)
    n_decoded = n_gen - clock.n["prefill"]     # tokens from decode steps
    rate = lambda n, t: n / t if t else None  # noqa: E731
    return done, dict(
        params=sum(t.numel() for t in _tensors(params)),
        n_slots=n_slots, ctx_len=ctx, requests=len(prompts),
        prompt_lens=[len(p) for p in prompts], max_new=max_new,
        prefill_tokens=n_prefill, generated_tokens=n_gen,
        decode_tokens=n_decoded, decode_steps=eng.serve_stats.n_steps,
        wall_s=wall, prefill_s=clock.s["prefill"], decode_s=clock.s["decode"],
        host_s=wall - clock.s["prefill"] - clock.s["decode"],
        prefill_tok_s=rate(n_prefill, clock.s["prefill"]),
        decode_tok_s=rate(n_decoded, clock.s["decode"]),
        peak_device_bytes=peak, launches=launches,
        kv_cache_bytes=sum(t.numel() * t.element_size()
                           for c in eng.caches for t in c.values()))


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def _compare_serving(got, want) -> "tuple[int, float]":
    """One request's tokens and logits rows from two runs: equal tokens
    wherever either run's top-2 gap exceeds the logit tolerance, logits
    within it up to the first near-tie that splits the runs.  Returns (near
    ties, largest |logit difference| compared)."""
    import torch

    ties, worst = 0, 0.0
    for i, (a, b) in enumerate(zip(got.out, want.out)):
        ra, rb = got.logits[i], want.logits[i]
        gaps = []
        for row in (ra, rb):
            top = torch.topk(row, 2).values
            gaps.append((float(top[0] - top[1]),
                         LOGIT_ATOL + LOGIT_RTOL * float(top[0].abs())))
        near = all(g <= bound for g, bound in gaps)
        ties += near
        if a != b:
            if not near:
                raise AssertionError(f"request {got.rid}, token {i}: {a} vs "
                                     f"{b} with top-2 gaps {gaps}")
            break
        diff = (ra - rb).abs()
        worst = max(worst, float(diff.max()))
        if bool((diff > LOGIT_ATOL + LOGIT_RTOL * rb.abs()).any()):
            raise AssertionError(f"request {got.rid}, token {i}: logits differ "
                                 f"by up to {float(diff.max())}")
    return ties, worst


def _layer0_flash_inputs(cfg, params, toks):
    """The rope'd q, k, v of layer 0 on the token rows ``toks`` (B, S) (the
    flash kernel's main-path inputs at that shape)."""
    import torch

    from repro_torch.models import layers as L

    lp = params["layers"][0]
    h = L.rmsnorm(params["embed"][toks], lp["mixer_norm"], cfg.norm_eps)
    pos = torch.arange(toks.shape[1], device=toks.device)[None]
    return L._project_qkv(lp["mixer"], cfg, h, pos)


def _layer0_scan_inputs(cfg, params, prompt):
    """The selective scan's inputs of layer 0 on ``prompt``: (dt, B_t, C_t,
    x, A), as ``mamba_prefill`` hands them to ``ops.selective_scan``."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import mamba as M

    toks = torch.tensor([prompt], device=DEVICE)
    lp = params["layers"][0]
    h = L.rmsnorm(params["embed"][toks], lp["mixer_norm"], cfg.norm_eps)
    xc, _, _, _ = M._conv_in(lp["mixer"], cfg, h)
    dt, bt, ct = M._ssm_params(lp["mixer"], cfg, xc)
    return dt, bt, ct, xc.float().contiguous(), \
        (-torch.exp(lp["mixer"]["A_log"])).contiguous()


def check_lm(state: dict) -> None:
    """Per configuration: the shortest and the longest request again on an
    engine without prefill (token by token through the plain attention and
    recurrence, the reference's ``test_serve_prefill_admission_matches_reference``
    contract) against the main path's prefill run; then each LM kernel
    against its plain version at the main path's full-width shapes, with
    device times, bounds and the library yardstick."""
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS

    kernels = {}
    for cfg, params, prompts, done, n_slots, ctx, max_new in state.pop("lm_runs"):
        lens = [len(p) for p in prompts]
        pick = [int(np.argmin(lens)), int(np.argmax(lens))]
        t0 = time.perf_counter()
        plain, _, _, _ = _serve(cfg, params, [prompts[i] for i in pick],
                                n_slots, ctx, max_new, use_prefill=False)
        ties, worst, first = 0, 0.0, 0.0
        for want, i in zip(plain, pick):
            t, w = _compare_serving(done[i], want)
            ties, worst = ties + t, max(worst, w)
            first = max(first, float((done[i].logits[0]
                                      - want.logits[0]).abs().max()))
        state["lm"][cfg.name].update(
            token_by_token=dict(requests=[lens[i] for i in pick],
                                seconds=time.perf_counter() - t0,
                                near_ties=ties, max_logit_diff=worst,
                                prefill_last_logit_diff=first,
                                logit_atol=LOGIT_ATOL, logit_rtol=LOGIT_RTOL))
        longest = prompts[pick[1]]
        if cfg.family == "ssm":
            rng = np.random.default_rng(LM_SEED + 1)
            seq = rng.integers(1, cfg.vocab, SCAN_SEQ).tolist()
            args = _layer0_scan_inputs(cfg, params, seq)
            row = _check_scan(args, SS)
            full = _check_scan(_layer0_scan_inputs(cfg, params, longest), SS)
            row["longest_prompt"] = {k: full[k] for k in (
                "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                "bound_route")}
            kernels["ssm_scan"] = row
        else:
            q, k, v = _layer0_flash_inputs(
                cfg, params, torch.tensor([longest], device=DEVICE))
            kernels["flash_attention"] = _check_flash(q, k, v, FA, F)
        del params, done, plain
        gc.collect()
        torch.cuda.empty_cache()
    state["lm_kernels"] = kernels
    for arch, row in state["lm"].items():
        emit("lm_check", model=arch, nvidia_smi=state["smi"],
             **row["token_by_token"])
    emit("lm_kernels", nvidia_smi=state["smi"], **kernels)


def _allclose(got, want, tol: float) -> bool:
    """Finite, and ``|got - want| <= tol + tol * |want|`` everywhere (the
    reference tests' ``assert_allclose(rtol=tol, atol=tol)``)."""
    import torch

    return bool(torch.isfinite(got).all()) and \
        bool(((got - want).abs() <= tol + tol * want.abs()).all())


def _check_flash(q, k, v, FA, F, causal: bool = True) -> dict:
    """The flash kernel against its plain version at a main path's
    full-width prefill shape (float32 and bfloat16, without and with a
    window; causal as the caller says: the decoders' prefills are causal,
    the whisper encoder's self-attention is not), device times of the call
    without a window in both types, their bounds and the time of
    ``scaled_dot_product_attention`` on the same inputs (KV heads repeated
    beforehand, outside the timing).  ``max_abs_err`` is the float32 one
    (the main path's type), ``bf16_max_abs_err`` the bf16 one."""
    import torch

    from repro_torch.kernels import work

    B, S, H, hd = q.shape
    KV = k.shape[2]
    errs = {}
    for dtype, tol in FLASH_TOL.items():
        dt = getattr(torch, dtype)
        a = [t.to(dt).contiguous() for t in (q, k, v)]
        for window in (0, FLASH_WINDOW):
            got = FA.flash_attention(*a, causal=causal, window=window).float()
            want = FA.flash_attention_plain(*a, causal=causal,
                                            window=window).float()
            if not _allclose(got, want, tol):
                raise AssertionError(f"flash_attention {dtype} causal={causal}"
                                     f" window={window} differs from its "
                                     f"plain version by "
                                     f"{float((got - want).abs().max())}")
            errs[f"{dtype}_window{window}"] = float((got - want).abs().max())
    args = [t.contiguous() for t in (q, k, v)]
    kms, queued = queued_ms(lambda: FA.flash_attention(*args, causal=causal),
                            k=10)
    if not queued:
        raise AssertionError("flash_attention: the host fell behind the card")
    pms, plain_queued = queued_ms(
        lambda: FA.flash_attention_plain(*args, causal=causal), k=3)
    lib_err, lms, lib_queued = _sdpa(FA, F, args, causal)
    bf = [t.to(torch.bfloat16).contiguous() for t in args]
    bf_ms, bf_queued = queued_ms(lambda: FA.flash_attention(*bf, causal=causal),
                                 k=10)
    if not bf_queued:
        raise AssertionError("flash_attention bf16: the host fell behind")
    _, bf_lms, bf_lib_queued = _sdpa(FA, F, bf, causal)
    # QK^T and PV over the visible pairs; q, k, v read, o written
    ops, nbytes, _ = work.flash_attention(B, S, H, KV, hd, causal=causal)
    t_b = nbytes / HBM_BYTES_PER_S
    # the least time of float32-accurate work by either route: CUDA cores at
    # the float32 rate, or 3xTF32 (three TF32 products per float32 one) on
    # the tensor cores, the kernel's route
    fp32_core = max(t_b, ops / FP32_OPS_PER_S) * 1e3
    tf32x3 = max(t_b, 3 * ops / TF32_OPS_PER_S) * 1e3
    bf16_bound = max(nbytes / 2 / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    return {"shape": [B, S, H, KV, hd], "causal": causal,
            "max_abs_err": max(e for n, e in errs.items() if "float32" in n),
            "errors": errs, "kernel_ms": kms, "plain_ms": pms,
            "plain_queued": plain_queued, "library_ms": lms,
            "library_queued": lib_queued, "library_max_abs_diff": lib_err,
            "flops": ops, "bytes": nbytes, "bound_ms": min(fp32_core, tf32x3),
            "bound_by": "bytes" if t_b * 1e3 >= min(fp32_core, tf32x3)
            else "operations",
            "bound_route": ("3xTF32 tensor cores" if tf32x3 <= fp32_core
                            else "float32 CUDA cores"),
            "fp32_cuda_core_bound_ms": fp32_core,
            "achieved_tflop_s": ops / kms / 1e9,
            "bf16_ms": bf_ms, "bf16_library_ms": bf_lms,
            "bf16_library_queued": bf_lib_queued, "bf16_bound_ms": bf16_bound,
            "bf16_max_abs_err": max(e for n, e in errs.items()
                                    if "bfloat16" in n)}


def _sdpa(FA, F, args, causal: bool = True) -> "tuple[float, float, bool]":
    """``scaled_dot_product_attention`` on the flash kernel's inputs (KV
    heads repeated beforehand, outside the timing): its largest difference
    from the kernel and its queued device time."""
    q, k, v = args
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    diff = float((lib.transpose(1, 2).float()
                  - FA.flash_attention(*args, causal=causal).float()
                  ).abs().max())
    ms, queued = queued_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
        k=10)
    return diff, ms, queued


def _check_scan(args, SS) -> dict:
    """The scan kernel against its plain version on main-path inputs at
    falcon-mamba's full width, final state included, with device times and
    the bound: the larger of the compulsory bytes and the operations, with
    the exponentials shared between the special-function units and the
    FP32 pipe so that both finish together (no single PyTorch call computes
    the scan)."""
    from repro_torch.kernels import work

    dt, bt, ct, x, a = args
    B, S, D = x.shape
    N = bt.shape[2]
    y, h = SS.ssm_scan(*args)
    y0, h0 = SS.ssm_scan_plain(*args)
    err = max(float((y - y0).abs().max()), float((h - h0).abs().max()))
    if not (_allclose(y, y0, SCAN_TOL) and _allclose(h, h0, SCAN_TOL)):
        raise AssertionError(f"ssm_scan differs from its plain version at "
                             f"{(B, S, D, N)} by {err}")
    kms, queued = queued_ms(lambda: SS.ssm_scan(*args), k=20)
    if not queued:
        raise AssertionError("ssm_scan: the host fell behind the card")
    pms, plain_queued = queued_ms(lambda: SS.ssm_scan_plain(*args), k=2)
    # bytes moved, FP32-pipe instructions and exponentials (kernels/work.py)
    instr, nbytes, exps = work.ssm_scan(B, S, D, N)
    t_ops = _exp_shared_s(instr, exps)
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": t_ops}
    route = max(times, key=times.get)
    return {"shape": [B, S, D, N], "max_abs_err": err,
            "y_max_abs": float(y0.abs().max()), "kernel_ms": kms,
            "plain_ms": pms, "plain_queued": plain_queued,
            "library_ms": None, "bytes": nbytes, "fp32_instructions": instr,
            "exps": exps, "bound_ms": times[route] * 1e3, "bound_by": route,
            "bound_route": route if route == "bytes" else
            "operations: exponentials on the special-function units and the "
            "FP32 pipe",
            "bounds_ms": {k: v * 1e3 for k, v in times.items()},
            # the least time of a kernel that takes every exponential on the
            # special-function units, as this one does; one that shares
            # them with the FP32 pipe can go below it, so it is no bound
            "exps_on_sfu_alone_ms": exps / EXP_PER_S * 1e3}


def _exp_shared_s(instr: int, exps: int) -> float:
    """The least time for ``instr`` FP32-pipe instructions and ``exps``
    exponentials, each exponential on the special-function units or as an
    ``EXP_POLY_INSTR``-instruction polynomial on the FP32 pipe: the share
    on the FP32 pipe at which both pipes finish together."""
    if not exps:
        return instr / FP32_INSTR_PER_S
    r = FP32_INSTR_PER_S / EXP_PER_S
    share = min(1.0, max(0.0, (r * exps - instr) / ((r + EXP_POLY_INSTR)
                                                      * exps)))
    return max((instr + share * EXP_POLY_INSTR * exps) / FP32_INSTR_PER_S,
               (1 - share) * exps / EXP_PER_S)


# --------------------------------------------------------------------------
# lm_zoo: the rest of the architecture zoo at full published width
# --------------------------------------------------------------------------

# (run, arch, layers kept (None: all), engine slots, cache length, requests,
# prompt lengths drawn in [lo, hi], new tokens per request); float32, TF32
# off, weights drawn on the card from LM_SEED
ZOO_RUNS = (("a", "phi3.5-moe-42b-a6.6b", 8, 4, 1088, 4, (256, 1024), 16),
            ("b", "deepseek-v2-236b", 4, 4, 544, 3, (256, 512), 16),
            ("c", "chameleon-34b", 8, 2, 544, 2, (256, 512), 16),
            ("d", "whisper-tiny", None, 4, 128, 4, (8, 64), 16),
            ("e", "qwen2-0.5b", None, 4, 4096, 4, (512, 3072), 32))
ZOO_DEPTH_CUT = {
    "a": "32 layers of float32 weights need about 170 GB; 8 hold 42.7 GB "
         "(5.03 GB of experts a layer) beside 1.05 GB of embedding and head",
    "b": "60 layers of float32 weights need about 944 GB; 4 (the dense layer "
         "0 and 3 MoE layers, 15.1 GB of routed experts each) hold 53.2 GB",
    "c": "48 layers of float32 weights need about 137 GB; 8 hold 26.4 GB "
         "(2.77 GB a layer) beside 4.29 GB of embedding and head"}
ZOO_FORWARD = {"c": (1, 2048), "d": (2, 448)}   # forward batch, tokens
ZOO_PLAIN_REPLAY = ("a", "b", "c", "e")


def _moe_drops(cfg, params, prompt) -> list:
    """Each MoE layer's dropped assignments in a prefill of ``prompt``:
    ``moe_ffn`` wrapped to count them from its input while installed."""
    import torch

    from repro_torch.models import model as MDL
    from repro_torch.models import moe as MOE

    drops, orig = [], MOE.moe_ffn

    def counted(p, c, x):
        drops.append(MOE.dropped(p, c, x))
        return orig(p, c, x)

    MOE.moe_ffn = counted
    try:
        MDL.prefill_with_caches(cfg, params, torch.tensor([prompt],
                                                          device=DEVICE),
                                len(prompt))
    finally:
        MOE.moe_ffn = orig
    return drops


def _zoo_forward(cfg, params, run: str):
    """The run's forward batch, drawn on the card from ``LM_SEED``: tokens,
    and the VLM's ``patch_embeds`` over its prefix or enc-dec's
    ``frames``."""
    import torch

    B, S = ZOO_FORWARD[run]
    gen = torch.Generator(device=DEVICE).manual_seed(LM_SEED + 2)
    batch = {"tokens": torch.randint(1, cfg.vocab, (B, S), generator=gen,
                                     device=DEVICE)}
    if cfg.vlm_prefix:
        batch["patch_embeds"] = torch.randn((B, cfg.vlm_prefix, cfg.d_model),
                                            generator=gen, device=DEVICE)
    if cfg.encdec:
        batch["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model),
                                      generator=gen, device=DEVICE)
    return batch


def _forward_logits(cfg, params, batch):
    """(logits, aux, seconds) of one ``forward`` without gradients, timed on
    the host clock closed by a sync."""
    import torch

    from repro_torch.models import model as MDL

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, aux = MDL.forward(cfg, params, batch)
    torch.cuda.synchronize()
    return logits, aux, time.perf_counter() - t0


def _compare_runs(done, other) -> dict:
    """Every request of two serving runs under ``_compare_serving``'s
    near-tie rule."""
    ties, worst = 0, 0.0
    for a, b in zip(done, other):
        t, w = _compare_serving(a, b)
        ties, worst = ties + t, max(worst, w)
    return {"near_ties": ties, "max_logit_diff": worst,
            "tokens_equal": all(a.out == b.out for a, b in zip(done, other)),
            "logit_atol": LOGIT_ATOL, "logit_rtol": LOGIT_RTOL}


def _zoo_flash_inputs(cfg, params, run: str, prompts):
    """The flash kernel's layer-0 inputs on the run's main path: phi3.5-moe's
    longest prompt (causal, hd 128), or whisper's encoder layer 0 on the
    forward's frames (non-causal, hd 64, S 1,500)."""
    import torch

    from repro_torch.models import layers as L

    if run == "a":
        toks = torch.tensor([max(prompts, key=len)], device=DEVICE)
        return _layer0_flash_inputs(cfg, params, toks), True
    frames = _zoo_forward(cfg, params, run)["frames"]
    ed = params["encdec"]
    x = frames + ed["enc_pos"][None, : frames.shape[1]]
    lp = ed["enc_0"]
    h = L.rmsnorm(x, lp["mixer_norm"], cfg.norm_eps)
    pos = torch.arange(frames.shape[1], device=DEVICE)[None]
    return L._project_qkv(lp["mixer"], cfg, h, pos), False


def phase_lm_zoo(state: dict) -> None:
    """The rest of the zoo at its published width, float32, TF32 off, one
    run at a time (each freeing the last one's weights), depth cut only
    where the card's 80 GB force it: (a) phi3.5-moe and (b) deepseek-v2
    served with prefill admission (MoE; (b) MLA, its decode first without
    the absorbed projections); (c) chameleon's forward with patch
    embeddings over its 1,024-position prefix, then text-only serving;
    (d) whisper's enc-dec forward (the flash kernel non-causal in the
    encoder) and token-by-token serving; (e) qwen2-0.5b with the int8 KV
    cache.  Each main path runs with the launch counts set to 0 just before
    it and read just after (the counts summed into ``lm_zoo_launches``);
    then, outside those windows, its checks: the same requests again with
    the kernels routed to their plain versions (``_plain_path``) under the
    near-tie rule, for (b) also the absorbed decode; (c) and (d)'s forward
    on the plain path within the logit tolerance; the MoE layers' dropped
    assignments on the longest prompt; and the flash kernel against its
    plain version at (a)'s hd 128 and (d)'s non-causal encoder shapes."""
    import dataclasses
    import gc

    import torch
    import torch.nn.functional as F

    from repro_torch.config.base import PerfFlags
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = {k: 0 for k in build.LAUNCHES}
    state["lm_zoo"], state["lm_zoo_flash"] = {}, {}
    t_phase = time.perf_counter()
    for run, arch, layers, n_slots, ctx, n_req, (lo, hi), max_new in ZOO_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_arch(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        if run == "e":
            cfg = dataclasses.replace(cfg, perf=PerfFlags(kv_quant_int8=True))
        params, t_init = _init_on_card(cfg)
        prompts = (_lm_prompts(cfg, 8, lo, hi)[:n_req] if run == "e"
                   else _lm_prompts(cfg, n_req, lo, hi))
        use_prefill = not cfg.encdec
        row = {"run": run, "layers": cfg.n_layers,
               "depth_cut": ZOO_DEPTH_CUT.get(run, False),
               "d_model": cfg.d_model, "init_s": t_init,
               "param_bytes": 4 * sum(t.numel() for t in _tensors(params))}
        batch = _zoo_forward(cfg, params, run) if run in ZOO_FORWARD else None
        # the counted window: the forward, then the serving run
        build.reset_launches()
        if batch is not None:
            logits, aux, fwd_s = _forward_logits(cfg, params, batch)
            row["forward"] = {"batch": list(batch["tokens"].shape),
                              "seconds": fwd_s,
                              "tok_s": batch["tokens"].numel() / fwd_s}
        done, srow = _serve_row(cfg, params, prompts, n_slots, ctx, max_new,
                                use_prefill=use_prefill)
        launches = dict(build.LAUNCHES)
        srow["launches"] = launches
        row.update(srow)
        for k, v in launches.items():
            total[k] += v
        row["expected_launches"] = _check_launches(
            f"lm_zoo ({run})", launches, cfg,
            prefills=len(prompts) if use_prefill else 0,
            forwards=int(batch is not None))
        # the checks, outside the counted window
        if batch is not None:
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"lm_zoo ({run}): non-finite logits")
            with _plain_path():
                plain, paux, _ = _forward_logits(cfg, params, batch)
            diff = float((logits - plain).abs().max())
            if not _allclose(logits, plain, LOGIT_ATOL):
                raise AssertionError(f"lm_zoo ({run}): forward differs from "
                                     f"the plain path by {diff}")
            row["forward"].update(plain_max_logit_diff=diff,
                                  logit_atol=LOGIT_ATOL, logit_rtol=LOGIT_RTOL)
            del logits, plain
        if run in ZOO_PLAIN_REPLAY:
            t0 = time.perf_counter()
            with _plain_path():
                plain, _ = _serve_row(cfg, params, prompts, n_slots, ctx,
                                      max_new, use_prefill=use_prefill)
            row["plain_replay"] = dict(_compare_runs(done, plain),
                                       seconds=time.perf_counter() - t0)
        if run == "b":
            acfg = dataclasses.replace(cfg, perf=PerfFlags(mla_absorb=True))
            absorbed, arow = _serve_row(acfg, params, prompts, n_slots, ctx,
                                        max_new, use_prefill=True)
            row["absorbed_decode"] = dict(_compare_runs(done, absorbed),
                                          decode_s=arow["decode_s"],
                                          decode_tok_s=arow["decode_tok_s"])
        row["drops"] = (_moe_drops(cfg, params, max(prompts, key=len))
                        if cfg.moe is not None else None)
        if run == "e":
            hd, kv = cfg.hd, cfg.n_kv_heads
            row["kv_cache_bytes_float32"] = (2 * cfg.n_layers * n_slots * ctx
                                             * kv * hd * 4)
        if run in ("a", "d"):
            (q, k, v), causal = _zoo_flash_inputs(cfg, params, run, prompts)
            key = "hd128_causal" if causal else "encoder_noncausal"
            state["lm_zoo_flash"][key] = dict(
                _check_flash(q, k, v, FA, F, causal=causal), run=run,
                model=arch)
            del q, k, v
        state["lm_zoo"][run] = dict(row, model=arch)
        emit("lm_zoo", model=arch, nvidia_smi=state["smi"], **row)
        del params, done, batch
    state["lm_zoo_launches"] = total
    gc.collect()
    torch.cuda.empty_cache()
    emit("lm_zoo_flash", nvidia_smi=state["smi"],
         seconds=time.perf_counter() - t_phase, **state["lm_zoo_flash"])


# --------------------------------------------------------------------------
# train: LM training at full published width
# --------------------------------------------------------------------------

# (cell, arch, layers kept (None: all), launcher flags); float32 weights
# drawn on the card from --seed, TF32 off as in the lm phase
TRAIN_CELLS = (
    ("a", "qwen2-0.5b", None,
     ["--optimizer", "adamw", "--batch", "4", "--seq", "512", "--steps", "8",
      "--ckpt-every", "4", "--lr", "3e-4"]),
    ("b", "falcon-mamba-7b", 8,
     ["--optimizer", "adafactor", "--microbatches", "2", "--compress-grads",
      "--batch", "2", "--seq", "512", "--steps", "6", "--lr", "1e-4",
      "--ckpt-every", "100"]))
TRAIN_SEED = 0
TRAIN_REPLAY_FROM = 4       # cell (a)'s checkpoint the second run restores
TRAIN_RTOL = 1e-5           # tests/test_train_restart.py's replay tolerance
TRAIN_GRAD_REL = 1e-3       # kernel-path gradients: 1e-3 * max|plain leaf|
# cell (b) trained a second time on the plain path: how near that run's
# losses stay to the kernel path's, step by step
TRAIN_PLAIN_RTOL = 1e-3
# depth of the gradient check (None: the published depth)
TRAIN_GRAD_LAYERS = {"a": None, "b": 2}
BWD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # times max(1, max|want|)
TRAIN_KERNELS = (
    ("flash_attention_bwd", "src/repro/kernels/flash_attention.py:79"),
    ("ssm_scan_bwd", "src/repro/kernels/ssm_scan.py:64"))
# keys of a backward kernel's row carried into the summary line
TRAIN_EXTRA_KEYS = ("shape", "deterministic", "bound_route",
                    "fp32_cuda_core_bound_ms", "bf16_ms", "bf16_library_ms",
                    "bf16_bound_ms", "bf16_max_abs_err", "launch_split")
DEPTH_CUT_WHY = ("the float32 params, gradients, microbatch sum and error "
                 "feedback of all 64 layers (7.27 G params) take 116 GB; "
                 "AdamW's state alone another 58 GB")


def _train_cfg(arch: str, layers):
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _train_argv(arch: str, flags, ckpt_dir: str) -> list:
    return ["--arch", arch, "--seed", str(TRAIN_SEED), "--log-every", "1",
            "--device", DEVICE, "--ckpt-dir", ckpt_dir, *flags]


def phase_train(state: dict) -> None:
    """Train each cell through the port's launcher once (``launch.train.
    main``; cell (b), with its depth cut, through ``train``, the function
    ``main`` calls), the launch counts read around each run.  The replay,
    the gradient and kernel checks and the timings run later, in
    ``check_train``."""
    import gc
    import shutil

    import torch

    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch import train as T

    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    state["train"] = {}
    for cell, arch, layers, flags in TRAIN_CELLS:
        cfg = _train_cfg(arch, layers)
        argv = _train_argv(arch, flags, str(root / cell))
        args = T.parse_args(argv)
        l0 = dict(LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = T.main(argv) if layers is None else T.train(cfg, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: LAUNCHES[k] - l0[k] for k in LAUNCHES}
        tokens = args.batch * args.seq
        steady = statistics.median(out["step_s"][1:])
        state["train"][cell] = dict(
            model=arch, layers=cfg.n_layers,
            depth_cut=({"layers": cfg.n_layers,
                        "published": _train_cfg(arch, None).n_layers,
                        "why": DEPTH_CUT_WHY} if layers else False),
            d_model=cfg.d_model, params=cfg.param_count(),
            optimizer=args.optimizer, batch=args.batch, seq=args.seq,
            microbatches=args.microbatches, compress=args.compress_grads,
            steps=args.steps, losses=out["losses"], step_s=out["step_s"],
            first_step_s=out["step_s"][0], median_step_s=steady,
            tokens_per_step=tokens, steady_tokens_per_s=tokens / steady,
            window_tokens_per_s=tokens * len(out["step_s"]) / wall,
            wall_s=wall, peak_device_bytes=peak, launches=launches)
        gc.collect()
        torch.cuda.empty_cache()


def _predicted_launches(cfg, row: dict) -> dict:
    """Launches of the training kernels that ``remat`` predicts: per layer
    of the kernel's kind and microbatch step, two forwards (the step's and
    the recomputation's) and one backward."""
    micro_steps = row["steps"] * row["microbatches"]
    kind = "ssm_scan" if cfg.family == "ssm" else "flash_attention"
    return {kind: 2 * cfg.n_layers * micro_steps,
            kind + "_bwd": cfg.n_layers * micro_steps}


@contextlib.contextmanager
def _plain_path():
    """Route the model's two kernels to their plain versions on the card
    (autograd through them) inside the block; the port itself has no such
    switch."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as SS

    orig = (ops.flash_attention_gqa, ops.selective_scan)
    ops.flash_attention_gqa = \
        lambda q, k, v, causal=True, window=0: FA.flash_attention_plain(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window)
    ops.selective_scan = lambda *args: SS.ssm_scan_plain(
        *(t.contiguous() for t in args))
    try:
        yield
    finally:
        ops.flash_attention_gqa, ops.selective_scan = orig


def _plain_replay(cell: str, cfg, arch: str, flags, want) -> dict:
    """The cell's run again, on the card from the same seed, with both
    kernels routed to their plain versions: its losses, step by step,
    against the kernel path's ``want``.  A second witness, beside the
    one-step gradient check, that what the losses do over the run is the
    training's own and not the kernels'."""
    import numpy as np
    import torch

    from repro_torch.launch import train as T

    args = T.parse_args(_train_argv(arch, flags, ""))
    t0 = time.perf_counter()
    with _plain_path():
        out = T.train(cfg, args)
    torch.cuda.synchronize()
    got = np.asarray(out["losses"])
    rel = np.abs(got - np.asarray(want)) / np.abs(np.asarray(want))
    if not (rel <= TRAIN_PLAIN_RTOL).all():
        raise AssertionError(f"train {cell}: plain path's losses {list(got)} "
                             f"vs the kernel path's {list(want)}")
    return {"losses": out["losses"], "rtol": TRAIN_PLAIN_RTOL,
            "rel_diff": rel.tolist(), "max_rel_diff": float(rel.max()),
            "seconds": time.perf_counter() - t0}


def _grad_check(cell: str, arch: str, flags) -> "tuple[dict, dict]":
    """One step's gradients of the kernel path against the plain path on
    the card, per leaf, on fresh weights from the seed at the check's depth
    and the cell's first batch; every leaf must get a gradient.  Returns
    (the row, the layer-0 inputs of the kernels for the kernel checks)."""
    import torch

    from repro_torch.common.tree import named_leaves, path_name
    from repro_torch.data.loader import TokenLoader
    from repro_torch.launch import train as T
    from repro_torch.models import model as MDL
    from repro_torch.train.train_step import loss_and_grads

    cfg = _train_cfg(arch, TRAIN_GRAD_LAYERS[cell])
    args = T.parse_args(_train_argv(arch, flags, ""))
    params = MDL.init_params(cfg, T.param_generator(TRAIN_SEED, DEVICE),
                             torch.float32, DEVICE)
    batch = {k: torch.from_numpy(v).long().to(DEVICE) for k, v in
             TokenLoader(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed).batch_at(0).items()}
    t0 = time.perf_counter()
    loss_k, _, _, gk = loss_and_grads(cfg, params, batch)
    with _plain_path():
        loss_p, _, _, gp = loss_and_grads(cfg, params, batch, remat=False)
    torch.cuda.synchronize()
    worst, missing = 0.0, []
    for (path, a), (_, b) in zip(named_leaves(gk), named_leaves(gp)):
        if a is None or float(a.abs().max()) == 0.0:
            missing.append(path_name(path))
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, rel)
        if rel > TRAIN_GRAD_REL:
            raise AssertionError(f"train {cell}: gradient of "
                                 f"{path_name(path)} off the plain path's "
                                 f"by {rel} of its largest")
    if missing:
        raise AssertionError(f"train {cell}: no gradient for {missing}")
    row = {"layers": cfg.n_layers, "leaves": len(named_leaves(gk)),
           "worst_rel_err": worst, "tol_rel": TRAIN_GRAD_REL,
           "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
           "seconds": time.perf_counter() - t0}
    # the kernels' main-path inputs: layer 0 on the first batch (the scan
    # at one microbatch row)
    with torch.no_grad():
        if cfg.family == "ssm":
            inputs = _layer0_scan_inputs(
                cfg, params, batch["tokens"][0].tolist())
        else:
            inputs = _layer0_flash_inputs(cfg, params, batch["tokens"])
    del params, gk, gp
    return row, inputs


def _kernel_name(name: str) -> str:
    """A device kernel's demangled name without its return type, namespace,
    template arguments and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name


def _launch_split(fn) -> dict:
    """One call of ``fn`` (after a warm call) under ``torch.profiler``:
    every device kernel it launches, in launch order, with its device time
    in ms, and their sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted((e.time_range.start, _kernel_name(e.name),
                   e.time_range.elapsed_us() / 1e3)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)
    return {"launches": [[name, ms] for _, name, ms in rows],
            "device_ms": sum(ms for _, _, ms in rows)}


def _launch_splits(calls: dict) -> dict:
    """``_launch_split`` of each backward-wrapper call in ``calls`` (key ->
    (kernel, positional tensors, keyword options)), run in a fresh process
    on the same inputs.  In a process that has run other profiler sessions
    (the ``spmd`` phase's) or much other work, later sessions were seen to
    drop device kernels; a fresh process's sessions keep them.  The child
    opens a session on a PyTorch product first, then profiles each call
    twice and fails unless both passes record the same kernels."""
    import repro_torch
    import torch

    # the child imports the same package as this process
    src = Path(repro_torch.__file__).resolve().parents[1]
    path = ROOT / "build" / "launch_split.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: (kern, [a.cpu() if isinstance(a, torch.Tensor) else a
                           for a in args], opts)
                for k, (kern, args, opts) in calls.items()}, path)
    try:
        subprocess.run([sys.executable, "-c",
                        f"import chip_smoke; chip_smoke._split_child("
                        f"{str(path)!r}, {str(src)!r})"], cwd=ROOT,
                       check=True)
        return json.loads(path.with_suffix(".json").read_text())
    finally:
        path.unlink(missing_ok=True)
        path.with_suffix(".json").unlink(missing_ok=True)


def _split_child(path: str, src: str) -> None:
    """The fresh process of ``_launch_splits``: ``src`` holds the
    ``repro_torch`` to import."""
    import torch

    sys.path.insert(0, src)
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS

    wrappers = {"flash_attention_bwd": FA.flash_attention_bwd,
                "ssm_scan_bwd": SS.ssm_scan_bwd}
    x = torch.ones((256, 256), device=DEVICE)
    _launch_split(lambda: x @ x)
    out = {}
    for key, (kern, args, opts) in torch.load(path).items():
        args = [a.to(DEVICE) if isinstance(a, torch.Tensor) else a
                for a in args]
        passes = [_launch_split(lambda: wrappers[kern](*args, **opts))
                  for _ in range(2)]
        names = [[n for n, _ in r["launches"]] for r in passes]
        if not names[0] or names[0] != names[1]:
            raise AssertionError(f"launch split of {key}: the profiler "
                                 f"recorded {names}")
        out[key] = passes[1]
    Path(path).with_suffix(".json").write_text(json.dumps(out))


def _check_bwd_flash(q, k, v) -> dict:
    """``flash_attention_bwd`` against autograd through the plain version
    at the main path's shape (float32 and bf16), two launches bit-identical,
    with device times, the bound and SDPA's backward on the same inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import work

    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = torch.from_numpy(np.random.default_rng(TRAIN_SEED + 7).normal(
        size=q.shape).astype(np.float32)).to(q.device)
    errs, times, calls = {}, {}, {}
    for dtype, tol in BWD_TOL.items():
        dt = getattr(torch, dtype)
        a = [t.to(dt).contiguous() for t in (q, k, v)]
        dout = g.to(dt)
        out, lse = FA.flash_attention_fwd(*a)
        got = FA.flash_attention_bwd(*a, out, dout, lse)
        again = FA.flash_attention_bwd(*a, out, dout, lse)
        want = FA.flash_attention_bwd_plain(*a, dout)
        torch.cuda.synchronize()
        for name, x, y, w in zip("qkv", got, again, want):
            if not torch.equal(x, y):
                raise AssertionError(f"flash_attention_bwd {dtype} d{name}: "
                                     f"two launches differ")
            scale = max(1.0, float(w.float().abs().max()))
            err = float((x.float() - w.float()).abs().max())
            if not (bool(torch.isfinite(x).all()) and err <= tol * scale):
                raise AssertionError(f"flash_attention_bwd {dtype} d{name} "
                                     f"off the plain version by {err}")
            errs[f"{dtype}_d{name}"] = err
        ms, queued = queued_ms(lambda: FA.flash_attention_bwd(*a, out, dout,
                                                              lse), k=10)
        if not queued:
            raise AssertionError("flash_attention_bwd: the host fell behind")
        pms, _ = queued_ms(lambda: FA.flash_attention_bwd_plain(*a, dout),
                           k=3)
        times[dtype] = (ms, pms, _sdpa_bwd_ms(F, a, dout))
        calls[dtype] = ("flash_attention_bwd", [*a, out, dout, lse], {})
    # recompute S and dO V^T, then dV, dQ and dK: five products
    ops, nbytes, _ = work.flash_attention_bwd(B, S, H, KV, hd)
    t_b = nbytes / HBM_BYTES_PER_S
    fp32_core = max(t_b, ops / FP32_OPS_PER_S) * 1e3
    tf32x3 = max(t_b, 3 * ops / TF32_OPS_PER_S) * 1e3
    bound = min(fp32_core, tf32x3)
    (ms, pms, lms), (bms, _, blms) = times["float32"], times["bfloat16"]
    return {"shape": [B, S, H, KV, hd],
            "max_abs_err": max(e for n, e in errs.items() if "float32" in n),
            "errors": errs, "deterministic": True, "kernel_ms": ms,
            "plain_ms": pms, "library_ms": lms, "flops": ops, "bytes": nbytes,
            "bound_ms": bound,
            "bound_by": "bytes" if t_b * 1e3 >= bound else "operations",
            "bound_route": ("3xTF32 tensor cores" if tf32x3 <= fp32_core
                            else "float32 CUDA cores"),
            "fp32_cuda_core_bound_ms": fp32_core,
            "achieved_tflop_s": ops / ms / 1e9,
            "bf16_ms": bms, "bf16_library_ms": blms,
            "bf16_bound_ms": max(nbytes / 2 / HBM_BYTES_PER_S,
                                 ops / BF16_OPS_PER_S) * 1e3,
            "bf16_max_abs_err": max(e for n, e in errs.items()
                                    if "bfloat16" in n),
            "launch_split": _launch_splits(calls)}


def _sdpa_bwd_ms(F, a, dout) -> float:
    """Queued device time of ``scaled_dot_product_attention``'s backward
    alone on the same inputs (KV heads repeated beforehand; the forward
    run once, outside the timing)."""
    import torch

    q, k, v = a
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous() \
        .requires_grad_()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous() \
        .requires_grad_()
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dt = dout.transpose(1, 2).contiguous()
    ms, queued = queued_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dt, retain_graph=True), k=10)
    return ms if queued else None


def _check_bwd_scan(args) -> dict:
    """``ssm_scan_bwd`` against autograd through the plain version on the
    main path's layer-0 inputs at falcon-mamba's width (one microbatch
    row), two launches bit-identical, with device times and the bound (no
    single PyTorch call computes the scan's backward)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.kernels import work

    dt, bt, ct, x, a = args
    B, S, D = x.shape
    N = bt.shape[2]
    dy = torch.from_numpy(np.random.default_rng(TRAIN_SEED + 8).normal(
        size=(B, S, D)).astype(np.float32)).to(x.device)
    _, _, hc = SS.ssm_scan_fwd(*args)
    got = SS.ssm_scan_bwd(*args, hc, dy)
    again = SS.ssm_scan_bwd(*args, hc, dy)
    want = SS.ssm_scan_bwd_plain(*args, dy)
    torch.cuda.synchronize()
    errs = {}
    for name, g, y, w in zip(("dt", "bt", "ct", "x", "a"), got, again, want):
        if not torch.equal(g, y):
            raise AssertionError(f"ssm_scan_bwd d{name}: two launches differ")
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        if not (bool(torch.isfinite(g).all()) and
                err <= BWD_TOL["float32"] * scale):
            raise AssertionError(f"ssm_scan_bwd d{name} off the plain "
                                 f"version by {err}")
        errs[f"d{name}"] = err
    ms, queued = queued_ms(lambda: SS.ssm_scan_bwd(*args, hc, dy), k=20)
    if not queued:
        raise AssertionError("ssm_scan_bwd: the host fell behind the card")
    pms, _ = queued_ms(lambda: SS.ssm_scan_bwd_plain(*args, dy), k=1)
    # bytes moved, FP32-pipe instructions and exponentials (kernels/work.py)
    instr, nbytes, exps = work.ssm_scan_bwd(B, S, D, N, n_chunk=hc.shape[1])
    t_ops = _exp_shared_s(instr, exps)
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": t_ops}
    route = max(times, key=times.get)
    return {"shape": [B, S, D, N], "max_abs_err": max(errs.values()),
            "errors": errs, "deterministic": True, "kernel_ms": ms,
            "plain_ms": pms, "library_ms": None, "bytes": nbytes,
            "fp32_instructions": instr, "exps": exps,
            "bound_ms": times[route] * 1e3, "bound_by": route,
            "bounds_ms": {k: v * 1e3 for k, v in times.items()},
            "launch_split": _launch_splits(
                {"float32": ("ssm_scan_bwd", [*args, hc, dy], {})})["float32"]}


def check_train(state: dict) -> None:
    """Outside the counted window: the launch counts against what remat
    predicts, finite and improving losses, cell (a)'s replay from its step-4
    checkpoint, cell (b)'s run again on the plain path, the gradient check
    of each cell, and each backward kernel against its plain version with
    timings."""
    import gc
    import shutil

    import numpy as np
    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch import train as T

    root = ROOT / "build" / "train_ckpt"
    kernels = {}
    for cell, arch, layers, flags in TRAIN_CELLS:
        row = state["train"][cell]
        cfg = _train_cfg(arch, layers)
        want = _predicted_launches(cfg, row)
        got = {k: row["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"train {cell}: launches {got}, remat "
                                 f"predicts {want}")
        losses = np.asarray(row["losses"])
        if not np.isfinite(losses).all():
            raise AssertionError(f"train {cell}: non-finite losses {losses}")
        row["first3"] = float(losses[:3].mean())
        row["last3"] = float(losses[-3:].mean())
        row["improved"] = row["last3"] < row["first3"]
        if not row["improved"]:
            raise AssertionError(f"train {cell}: NLL did not improve: "
                                 f"{losses}")
        if cell == "a":
            ckpt = root / cell
            for s in CheckpointManager(str(ckpt)).all_steps():
                if s > TRAIN_REPLAY_FROM:
                    shutil.rmtree(ckpt / f"step_{s:08d}")
            t0 = time.perf_counter()
            replay = T.main(_train_argv(arch, flags, str(ckpt))
                            + ["--ckpt-every", "100"])
            straight = row["losses"][TRAIN_REPLAY_FROM:]
            if not np.allclose(replay["losses"], straight, rtol=TRAIN_RTOL,
                               atol=0.0):
                raise AssertionError(f"train a: replay {replay['losses']} "
                                     f"vs straight {straight}")
            row["replay"] = {"from_step": TRAIN_REPLAY_FROM,
                             "losses": replay["losses"], "rtol": TRAIN_RTOL,
                             "max_rel_diff": float(np.max(
                                 np.abs(np.asarray(replay["losses"])
                                        - straight) / np.abs(straight))),
                             "seconds": time.perf_counter() - t0}
        if cell == "b":
            gc.collect()
            torch.cuda.empty_cache()
            row["plain_replay"] = _plain_replay(cell, cfg, arch, flags,
                                                row["losses"])
        gc.collect()
        torch.cuda.empty_cache()
        row["grad_check"], inputs = _grad_check(cell, arch, flags)
        if cfg.family == "ssm":
            kernels["ssm_scan_bwd"] = _check_bwd_scan(inputs)
        else:
            kernels["flash_attention_bwd"] = _check_bwd_flash(*inputs)
        del inputs
        gc.collect()
        torch.cuda.empty_cache()
        emit("train", cell=cell, nvidia_smi=state["smi"], **row)
    shutil.rmtree(root, ignore_errors=True)
    state["train_kernels"] = kernels
    emit("train_kernels", nvidia_smi=state["smi"], **kernels)


# --------------------------------------------------------------------------
# dryrun: the production meshes on fake tensors, and the federated step
# --------------------------------------------------------------------------

# (arch, shape) cells of the dry-run traced here: one dense, one SSM and one
# MoE model, at decode_32k on the (16, 16) mesh; the whole sweep is
# ``python -m repro_torch.launch.dryrun --arch all --mesh both``
DRYRUN_CELLS = (("qwen2-0.5b", "decode_32k"), ("falcon-mamba-7b", "decode_32k"),
                ("phi3.5-moe-42b-a6.6b", "decode_32k"))
FED_CAP = 8192                 # rows per operator and shard
FED_TABLE_CAP = 1 << 20        # triples per (source, model) shard
FED_CHECK_TABLE_CAP = 1 << 16  # the size held to the CPU port
FED_SEED = 61
FED_PREDICATES = 256           # predicate ids; the stars ask for 0-2 and 3-4


def _dryrun_cell(cell: tuple) -> dict:
    """One dry-run cell in a process of its own (``phase_dryrun``)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun as D

    arch, shape, multi = cell
    r = (D.lower_fed_cell(multi) if arch == "odyssey-fed"
         else D.lower_cell(arch, shape, multi))
    # the model cells also say which DTensor internals the release let the
    # dry-run patch, and which ops ran on replicated inputs
    return {k: r[k] for k in (
        "arch", "shape", "mesh", "compute_s", "memory_s", "collective_s",
        "bottleneck", "flops_per_dev", "fp32_flops_per_dev",
        "hbm_bytes_per_dev", "collective_bytes_per_dev", "by_collective",
        "collective_counts", "useful_flops_fraction", "compile_s", "torch",
        "dtensor_patches", "replicated_ops") if k in r}


def fed_tables(table_cap: int, seed: int, device: str):
    """``(tables, trow)`` of the federated step on the ``(16, 16)`` mesh:
    every shard full, subjects of model shard ``mm`` congruent to ``mm``
    (hash-partitioned), ``table_cap // 256`` subjects a shard so that a
    subject holds each predicate about once, and objects 16 times as spread
    as the subjects, so that one in 16 first-star objects is a subject the
    second star may hold: both stars and the join yield rows."""
    import torch

    d = m = 16
    g = torch.Generator(device=device).manual_seed(seed)
    R = max(1, table_cap // FED_PREDICATES)
    i32 = dict(generator=g, dtype=torch.int32, device=device)
    mm = torch.arange(m, dtype=torch.int32, device=device).view(1, m, 1)
    s = torch.randint(0, R, (d, m, table_cap), **i32) * m + mm
    p = torch.randint(0, FED_PREDICATES, (d, m, table_cap), **i32)
    o = torch.randint(0, 16 * R * m, (d, m, table_cap), **i32)
    tables = torch.stack([s, p, o], -1)
    del s, p, o
    return tables, torch.ones((d, m, table_cap), dtype=torch.bool,
                              device=device)


def _fed_run(tables, trow, device: str, cap: int = FED_CAP):
    """The canonical step (``engine/distributed.fed_query_step``) on the
    ``(16, 16)`` production mesh resident on ``device``: two stars of
    predicates 0-2 and 3-4, joined on the first star's first object."""
    import torch

    from repro_torch.engine.distributed import DistributedEngine, fed_query_step
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(device=device)
    d, m = mesh.shape["data"], mesh.shape["model"]

    def pats(preds):
        t = torch.full((len(preds), 3), -1, dtype=torch.int32)
        t[:, 1] = torch.tensor(preds, dtype=torch.int32)
        return t.to(device).expand(d, m, len(preds), 3).contiguous()

    on = torch.ones((d, m), dtype=torch.bool, device=device)
    step = fed_query_step(DistributedEngine(None, mesh, cap, tables.shape[2]))
    args = (tables, trow, pats([0, 1, 2]), on, pats([3, 4]), on)
    return step, args


def phase_dryrun(state: dict) -> None:
    """(a) the port's dry-run on fake tensors, five cells in processes of
    their own; (b) the federated step for real at the dry-run's sizes, timed
    beside its one-card bound and checked at ``FED_CHECK_TABLE_CAP``
    against the CPU port; (c) the kernels' booked work against the
    ``lm_kernels`` line's flops and bytes."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.launch import roofline as RL

    t0 = time.perf_counter()
    cells = [("odyssey-fed", "fed_query", False), ("odyssey-fed", "fed_query", True)]
    cells += [(a, s, False) for a, s in DRYRUN_CELLS]
    with ProcessPoolExecutor(len(cells), mp.get_context("spawn")) as pool:
        rows = list(pool.map(_dryrun_cell, cells))
    dry_s = time.perf_counter() - t0

    # (b) the step on the card at the dry-run's sizes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    tables, trow = fed_tables(FED_TABLE_CAP, FED_SEED, DEVICE)
    step, args = _fed_run(tables, trow, DEVICE)
    build.reset_launches()
    rows_, valid, ovf, shipped = step(*args)
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    n_rows, n_ovf = int(valid.sum()), int(ovf.sum())
    fed_ms = cuda_ms(lambda: step(*args), reps=3)
    peak = torch.cuda.max_memory_allocated()
    del tables, trow, args, rows_, valid, ovf
    torch.cuda.empty_cache()
    fed = rows[0]
    # one card does all 256 shards' traffic
    bound_ms = fed["hbm_bytes_per_dev"] * 256 / HBM_BYTES_PER_S * 1e3
    # the same step at FED_CHECK_TABLE_CAP, card against CPU, exactly
    small = fed_tables(FED_CHECK_TABLE_CAP, FED_SEED, "cpu")
    got = _fed_run(*(t.to(DEVICE) for t in small), DEVICE)
    want = _fed_run(*small, "cpu")
    got = [t.cpu() for t in got[0](*got[1])]
    want = want[0](*want[1])
    for name, g, w in zip(("rows", "valid", "overflow", "shipped"), got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"fed step at table_cap {FED_CHECK_TABLE_CAP}: "
                                 f"{name} differs between the card and the CPU")
    check = {"table_cap": FED_CHECK_TABLE_CAP, "rows": int(want[1].sum()),
             "overflow": int(want[2].sum()), "shipped": int(want[3].sum())}
    if not (n_rows and check["rows"]):
        raise AssertionError("fed step: the join yielded no rows")
    fed_s = time.perf_counter() - t1

    # (c) the booked work of each kernel op against lm_kernels' counts
    booked = {}
    for name, row in state["lm_kernels"].items():
        with FakeTensorMode():
            if name == "flash_attention":
                B, S, H, KV, hd = row["shape"]
                q = torch.empty(B, S, H, hd)
                k = torch.empty(B, S, KV, hd)
                with RL.record_ops() as trace:
                    FA.flash_attention(q, k, k, causal=row["causal"])
                want_w = (row["flops"], 0, row["bytes"])
            else:
                B, S, D, N = row["shape"]
                x = torch.empty(B, S, D)
                bt = torch.empty(B, S, N)
                with RL.record_ops() as trace:
                    SS.ssm_scan(x, bt, bt, x, torch.empty(D, N))
                # the scan runs on the FP32 pipe: booked apart, no flops
                want_w = (0, row["fp32_instructions"], row["bytes"])
        costs = RL.analyze(trace)
        got_w = (costs.flops, costs.fp32_flops, costs.hbm_bytes)
        if got_w != want_w:
            raise AssertionError(f"{name}: booked (flops, fp32 flops, bytes) "
                                 f"{got_w}, lm_kernels {want_w}")
        booked[name] = dict(zip(("flops", "fp32_flops", "bytes"), got_w))
    seconds = time.perf_counter() - t0
    emit("dryrun", torch=torch.__version__, nvidia_smi=state["smi"],
         cells=rows, trace_s=dry_s,
         fed_step={"mesh": "16x16", "cap": FED_CAP,
                   "table_cap": FED_TABLE_CAP, "seed": FED_SEED,
                   "table_bytes": 16 * 16 * FED_TABLE_CAP * 13,
                   "rows": n_rows, "overflow": n_ovf,
                   "shipped": int(shipped.sum()), "ms": fed_ms,
                   "one_card_bound_ms": bound_ms,
                   "bound_hbm_bytes": fed["hbm_bytes_per_dev"] * 256,
                   "peak_bytes": peak, "launches": launches,
                   "cpu_check": check, "seconds": fed_s},
         booked=booked, seconds=seconds)


def _second_input(st: dict, name: str) -> dict:
    """The summary keys of ``seg_bitmap``'s path and unordered input, and of
    ``summary_probe``'s form and large block (with the launch floor)."""
    if name not in ("seg_bitmap", "summary_probe"):
        return {}
    key, how = (("unordered", "path") if name == "seg_bitmap"
                else ("large", "form"))
    row = st[name][key]
    out = {how: st[name][how]}
    out.update({f"{key}_{k}": row[k] for k in
                ("shape", how, "max_abs_err", "kernel_ms", "plain_ms",
                 "bound_ms", "library_ms")})
    if name == "summary_probe":
        out["launch_floor_ms"] = st["launch_floor_ms"]
    return out


def summary(state: dict) -> dict:
    ls = state["large_star"]
    sweep, sweep14 = ls["clique12"], ls["clique14"]
    st = state["stats_kernels"]
    err = state["err"]
    return {"kernels": [
        {"name": "dp_sweep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dp_sweep.cu",
         "replaces": "src/repro/kernels/dp_layer.py:267",
         "launches": state["main_launches"]["dp_sweep"],
         "max_abs_err": max(err["dp_sweep"], sweep["max_abs_err"],
                            state["query_serve_sweep"]["max_abs_err"]),
         "ms": sweep["kernel_ms"], "plain_ms": sweep["plain_ms"],
         "bound_ms": sweep["bound_ms"], "bound_by": sweep["bound_by"],
         "library_ms": None, "call_ms": sweep["call_ms"],
         "clique14_ms": sweep14["kernel_ms"],
         "clique14_plain_ms": sweep14["plain_ms"],
         "clique14_bound_ms": sweep14["bound_ms"],
         "clique14_call_ms": sweep14["call_ms"],
         **{f"query_serve_{k}": v for k, v in state["query_serve_sweep"].items()
            if k in ("B", "n", "kernel_ms", "plain_ms", "call_ms", "bound_ms",
                     "bound_by", "max_abs_err")}},
    ] + [
        # one entry per tiled cell, at its largest tile; launches are the
        # cell's own on the main path (the two sum to the kernel's count)
        {"name": "dp_layer", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dp_layer.cu",
         "replaces": "src/repro/kernels/dp_layer.py:183",
         "cell": cell, "tile": ls[cell]["largest_tile"],
         "launches": ls[cell]["launches"]["dp_layer"],
         "max_abs_err": max(err["dp_layer"], ls[cell]["max_abs_err"]),
         "ms": ls[cell]["kernel_ms"], "plain_ms": ls[cell]["plain_ms"],
         "bound_ms": ls[cell]["bound_ms"], "bound_by": ls[cell]["bound_by"],
         "library_ms": None}
        for cell in ("chain20", "tree16")] + [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": replaces,
         "launches": state["main_launches"][name],
         "max_abs_err": max(err[name], st[name]["max_abs_err"]),
         "ms": st[name]["kernel_ms"], "plain_ms": st[name]["plain_ms"],
         "bound_ms": st[name]["bound_ms"], "bound_by": st[name]["bound_by"],
         "library_ms": st[name]["library_ms"],
         **({"segments": st[name]["segments"],
             "kernel_alone_ms": st[name]["kernel_alone_ms"],
             "single_list_ms": st[name]["single_list"]["kernel_ms"],
             "all_pairs_ms": st[name]["all_pairs"]["kernel_ms"],
             "all_pairs_bound_ms": st[name]["all_pairs"]["bound_ms"]}
            if "all_pairs" in st[name] else {}),
         **_second_input(st, name)}
        for name, replaces in STATS_KERNELS] + [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": replaces,
         "launches": state["main_launches"][name],
         "max_abs_err": max([state["lm_kernels"][name]["max_abs_err"]] + [
             row["max_abs_err"] for row in state["lm_zoo_flash"].values()
             if name == "flash_attention"]),
         "ms": state["lm_kernels"][name]["kernel_ms"],
         "plain_ms": state["lm_kernels"][name]["plain_ms"],
         "bound_ms": state["lm_kernels"][name]["bound_ms"],
         "bound_by": state["lm_kernels"][name]["bound_by"],
         "library_ms": state["lm_kernels"][name]["library_ms"],
         **{k: state["lm_kernels"][name][k] for k in LM_EXTRA_KEYS
            if k in state["lm_kernels"][name]},
         # the lm_zoo runs: each one's launches, and flash's two new shapes
         "lm_zoo_launches": {
             f"({run}) {row['model']}, {row['layers']} layers":
             row["launches"].get(name, 0)
             for run, row in state["lm_zoo"].items()},
         **({"lm_zoo_cases": {key: {k: row[k] for k in (
             "model", "shape", "causal", "max_abs_err", "kernel_ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms", "bf16_ms",
             "bf16_library_ms")} for key, row in state["lm_zoo_flash"].items()}}
            if name == "flash_attention" else {})}
        for name, replaces in LM_KERNELS] + [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": replaces,
         "launches": state["main_launches"][name],
         **{k: state["train_kernels"][name][key] for k, key in (
             ("max_abs_err", "max_abs_err"), ("ms", "kernel_ms"),
             ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"),
             ("bound_by", "bound_by"), ("library_ms", "library_ms"))},
         **{k: state["train_kernels"][name][k] for k in TRAIN_EXTRA_KEYS
            if k in state["train_kernels"][name]}}
        for name, replaces in TRAIN_KERNELS]}


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
    from repro_torch.kernels import build

    state: dict = {}
    phase_analysis(state)
    phase_build(state)
    phase_kernels(state)
    # each main path runs with the launch counts set to 0 just before and
    # read just after; the checks against the numpy backend and the plain
    # versions, and the timings, run outside those windows
    build.reset_launches()
    for k in jo.DP_SWEEP_COUNTERS:
        jo.DP_SWEEP_COUNTERS[k] = 0
    phase_fedbench(state)
    phase_query_serve(state)
    phase_large_star(state)
    phase_stats(state)
    phase_baselines(state)
    phase_failover(state)
    phase_spmd(state)
    launches = dict(build.LAUNCHES)
    check_fedbench(state)
    check_query_serve(state)
    check_large_star(state)
    check_stats(state)
    check_baselines(state)
    check_failover(state)
    check_spmd(state)
    build.reset_launches()
    phase_lm(state)
    lm_launches = dict(build.LAUNCHES)
    check_lm(state)
    phase_lm_zoo(state)        # resets and reads the counts around each run
    build.reset_launches()
    phase_train(state)
    state["main_launches"] = {k: launches.get(k, 0) + lm_launches.get(k, 0)
                              + state["lm_zoo_launches"].get(k, 0) + v
                              for k, v in build.LAUNCHES.items()}
    for k, v in state["main_launches"].items():
        if v == 0:
            raise AssertionError(f"{k} was never launched on the main path")
    check_train(state)
    phase_dryrun(state)
    print(state["smi"], flush=True)
    print(json.dumps(summary(state)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
