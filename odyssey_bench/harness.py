"""One run of one cell: set-up, a measured window of served traffic, the
check of every answer against the reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is data or a reader of its own, found by the names in
``BENCHMARK.json``: ``configs/<config>.json``, ``traffic/<traffic>.json``
(with the generator module under ``gen/`` that it names) and
``metrics/<metric>.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from odyssey_bench.gen import federation, stream
from odyssey_bench.reference import bgp

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
GRACE_S = 60.0              # how long past the window a due answer is awaited
TRACE_S = 10.0              # the traced slice of a --trace 1 window
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
clock = time.perf_counter


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_inputs(bench: dict, workload: str) -> tuple:
    """(cell, configuration, traffic mix) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, mix


def make_inputs(cfg: dict, mix: dict, seed: int) -> tuple:
    """The federation, the query pool and the warm-up pool of one run.  The
    structure comes from the configuration and the mix; ``seed`` renames
    the terms."""
    gen = importlib.import_module(f"odyssey_bench.gen.{mix['generator']}")
    fd0 = federation.generate(cfg, cfg["data_seed"])
    cache: dict = {}
    pool = gen.make_pool(fd0, mix["pool"], cache)
    taken = {q.patterns for q in pool}
    warm = [q for q in gen.make_pool(fd0, {**mix["pool"], **mix["warm"]}, cache)
            if q.patterns not in taken]
    perm = federation.permutation(fd0.n_terms, seed)
    return (federation.relabel(fd0, perm), [q.renamed(perm) for q in pool],
            [q.renamed(perm) for q in warm])


@dataclasses.dataclass
class Observed:
    """What a run leaves for the metrics' readers (``metrics/<name>.py``)."""

    seconds: float            # the window's length
    t_end: float              # its close (clock)
    records: list             # [request, sent (clock), pool index]
    ok: list                  # per record: its rows equal the reference's
    setup_s: float            # process start to the window's first request
    stats: dict               # the server's counters over the window
    trace: "dict | None"      # device trace summary (traced runs)


def _stats(server) -> dict:
    st = getattr(server, "serve_stats", None)
    return dataclasses.asdict(st) if st is not None else {}


def _span(tracing: bool, name: str):
    if not tracing:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


class Tracer:
    """The device trace of one slice of the window: ``TRACE_S`` seconds in
    its middle (the whole window where that is shorter).  Started and
    stopped from the driving loop; read after the window has closed."""

    def __init__(self, t0: float, seconds: float, cuda: bool) -> None:
        span = min(TRACE_S, seconds)
        self.start_at = t0 + (seconds - span) / 2
        self.stop_at = self.start_at + span
        self.cuda = cuda
        self.prof = None
        self.t_on = self.t_off = None

    def tick(self, now: float) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.prof is None and now >= self.start_at:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.t_on = clock()
        elif self.prof is not None and self.t_off is None and now >= self.stop_at:
            if self.cuda:
                torch.cuda.synchronize()
            # the window ends here: stopping the profiler flushes its
            # buffers, seconds in which the host runs nothing of the program
            self.t_off = clock()
            self.prof.__exit__(None, None, None)

    def summary(self) -> "dict | None":
        if self.prof is None:
            return None
        self.tick(float("inf"))
        from odyssey_bench import trace
        return trace.summarize(self.prof, self.t_off - self.t_on)


def _drive_closed(server, queries, seq, clients, t0, t_end, tracer) -> list:
    recs: list = []
    owner: dict = {}
    sent = 0
    traced = tracer is not None

    def send(c: int) -> None:
        nonlocal sent
        qi = int(seq[sent % len(seq)])
        sent += 1
        t = clock()
        with _span(traced, "harness.submit"):
            req = server.submit(queries[qi])
        recs.append([req, t, qi])
        owner[id(req)] = c

    for c in range(clients):
        send(c)
    while (now := clock()) < t_end:
        if traced:
            tracer.tick(now)
        with _span(traced, "harness.poll"):
            got = server.poll()
        for req in got:
            if clock() < t_end:
                send(owner[id(req)])
        if not got:
            time.sleep(0.0005)
    return recs


def _await(server, recs, deadline) -> None:
    while clock() < deadline and not all(r[0].done for r in recs):
        if not server.poll():
            time.sleep(0.001)


def judge(recs, pool, graph) -> dict:
    """Every request's rows against the reference's answer to its query.
    An answer equal, column by column, to one already judged right is
    right."""
    ref: dict = {}
    good: dict = {}
    n = dict(wrong_answers=0, missing=0, overflowed=0)
    ok = []
    for req, _, qi in recs:
        if not req.done:
            n["missing"] += 1
            ok.append(False)
            continue
        if getattr(req.metrics, "overflowed", False):
            n["overflowed"] += 1
            ok.append(False)
            continue
        q = pool[qi]
        rows = req.rows or {}
        right = list(rows) == list(q.projection)
        if right:
            cols = [np.asarray(rows[v]) for v in q.projection]
            seen = good.get(qi)
            if seen is None or not all(np.array_equal(a, b) for a, b in zip(cols, seen)):
                if qi not in ref:
                    ref[qi] = bgp.answer(graph, q)
                right = bgp.digest(cols) == ref[qi]
                if right:
                    good[qi] = cols
        if not right:
            n["wrong_answers"] += 1
        ok.append(right)
    n["ok"] = ok
    n["distinct_queries"] = len({qi for _, _, qi in recs})
    return n


def _readers(bench: dict, cell: dict, trace: bool) -> list:
    """The metrics this cell reports, with their readers: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if trace:
        reports = {m["name"] for m in e2e}
        chosen = [m for m in bench["per_layer"]
                  if (name in m["workloads"] if "workloads" in m else m["moves"] in reports)]
    else:
        chosen = e2e
    out = []
    for m in chosen:
        spec = importlib.util.spec_from_file_location(
            f"odyssey_bench.metrics.{m['name']}", BENCH / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out.append((m, mod.read))
    return out


@dataclasses.dataclass
class Session:
    """A cell set up and warm, ready for measured windows."""

    cell: dict
    cfg: dict
    mix: dict
    fd: object
    pool: list
    system: object
    queries: list
    seed: int
    cuda: bool
    t_start: float
    log: object


def open_session(workload: str, seed: int, *, device: str = "cuda",
                 process_start: "float | None" = None, bench: "dict | None" = None,
                 overrides: "dict | None" = None, system_factory=None, log=None,
                 trace: bool = False) -> Session:
    """Inputs from ``seed``, the system built on them, one warm pass.
    ``overrides`` replaces configuration and mix keys (tests run the cells
    small on the CPU); ``system_factory(cfg, fd, device)`` replaces the
    program (the control, and broken programs in the tests)."""
    import torch

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = clock() if process_start is None else process_start
    cell, cfg, mix = cell_inputs(bench or load_benchmark(), workload)
    for key, val in (overrides or {}).items():
        target = mix if key in mix else cfg
        target[key] = {**target[key], **val} if isinstance(val, dict) else val
    fd, pool, warm = make_inputs(cfg, mix, seed)
    log(f"inputs: {fd.n_triples()} triples, {fd.n_terms} terms, pool {len(pool)}, "
        f"warm {len(warm)}, {clock() - t_start:.3f} s")
    if system_factory is None:
        from odyssey_bench.system import PortSystem
        system_factory = PortSystem
    system = system_factory(cfg, fd, device)
    queries = [system.query(q) for q in pool]
    # the reference reads only the triples: the term strings are the
    # program's now, and the harness keeps no copy of them in the process
    fd.terms = fd.authorities = None
    log(f"system: {clock() - t_start:.3f} s")
    for q in warm:
        system.server.submit(system.query(q))
    system.server.drain()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        if trace:
            # the profiler's first start on a card pays the tracer's own
            # set-up; pay it here rather than inside the window
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.zeros(1, device=device).add_(1)
                torch.cuda.synchronize()
    gc.collect()
    log(f"warm: {clock() - t_start:.3f} s")
    return Session(cell, cfg, mix, fd, pool, system, queries, seed, cuda, t_start, log)


def window(sess: Session, seconds: float, trace: bool, grace_s: float = GRACE_S) -> dict:
    """One measured window of the cell's traffic, then the wait for every
    answer sent in it."""
    import torch

    server = sess.system.server
    loop = sess.mix["loop"]
    pop = sess.mix["popularity"]
    # the request order is the mix's own, the same for every run seed: at a
    # few hundred requests a window, another order is another tail (the
    # seed renames the data instead)
    rng = np.random.default_rng(sess.mix["stream_seed"])
    length = max(len(sess.pool), int(seconds * 200) + 64)
    seq = stream.popularity_sequence(len(sess.pool), pop["zipf_exponent"], length,
                                     pop["block"], rng)
    before = _stats(server)
    t0 = clock()
    t_end = t0 + seconds
    tracer = Tracer(t0, seconds, sess.cuda) if trace else None
    if loop["kind"] != "closed":
        raise ValueError(f"no driver for a {loop['kind']!r} loop")
    recs = _drive_closed(server, sess.queries, seq, loop["clients"], t0, t_end, tracer)
    t_close = clock()
    if tracer is not None:
        tracer.tick(max(t_close, tracer.stop_at))
    _await(server, recs, t_end + grace_s)
    if sess.cuda:
        torch.cuda.synchronize()
    stats = {k: v - before.get(k, 0) for k, v in _stats(server).items()}
    return dict(recs=recs, stats=stats, t0=t0, t_end=t_end, t_close=t_close, tracer=tracer)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", process_start: "float | None" = None,
             bench: "dict | None" = None, overrides: "dict | None" = None,
             system_factory=None, grace_s: float = GRACE_S, log=None) -> dict:
    """One run; returns the result line as a dict (``checks`` last)."""
    import torch

    bench = bench or load_benchmark()
    sess = open_session(workload, seed, device=device, process_start=process_start,
                        bench=bench, overrides=overrides, system_factory=system_factory,
                        log=log, trace=trace)
    log, cuda = sess.log, sess.cuda
    w = window(sess, seconds, trace, grace_s=grace_s)
    recs, t0, t_end = w["recs"], w["t0"], w["t_end"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    info = dict(table_cap=getattr(sess.system, "table_cap", None),
                table_bytes=getattr(sess.system, "table_bytes", None))
    sess.system.close()
    sess.system = sess.queries = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    trace_sum = None
    if w["tracer"] is not None:
        t_read = clock()
        trace_sum = w["tracer"].summary()
        log(f"trace read: {clock() - t_read:.3f} s, {trace_sum['device_events']} device "
            f"and {trace_sum['host_events']} host events")

    t_ref = clock()
    fd = sess.fd
    graph = bgp.Graph(*(np.concatenate([getattr(sd, c) for sd in fd.sources])
                        for c in "spo"))
    verdict = judge(recs, sess.pool, graph)
    log(f"reference: {verdict['distinct_queries']} queries, {clock() - t_ref:.3f} s")

    obs = Observed(seconds=seconds, t_end=t_end, records=recs,
                   ok=verdict["ok"], setup_s=t0 - sess.t_start, stats=w["stats"],
                   trace=trace_sum)
    metrics = {}
    for m, read in _readers(bench, sess.cell, trace):
        val = read(obs)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}

    failed = verdict["wrong_answers"] + verdict["missing"] + verdict["overflowed"]
    checks = {k: {"value": verdict[k], "limit": 0}
              for k in ("wrong_answers", "missing", "overflowed")}
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=int(sess.cell["chips"]) if cuda else 0, memory_peak_bytes=int(peak))
    if trace_sum is not None:
        dev.update(busy_s=trace_sum["busy_s"], window_s=trace_sum["window_s"])
    out = dict(correct=bool(failed == 0 and len(recs) > 0), attempted=len(recs),
               failed=failed, metrics=metrics, device=dev)
    if trace_sum is not None:
        out["breakdown"] = dict(device_ops=trace_sum["device_ops"],
                                idle_gaps=trace_sum["idle_gaps"])
    out["checks"] = checks
    log(f"window: {len(recs)} requests, {verdict['distinct_queries']} distinct, "
        f"counters {json.dumps(w['stats'])}, {info}, closed {w['t_close'] - t0:.3f} s")
    return out


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (the loaded modules'
    by default), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
