"""Distributed federation executor: the paper's endpoint/engine architecture
mapped onto a ``(data, model)`` mesh (``repro_torch.launch.mesh``).

Layout
------
* ``data`` axis  = federation endpoints (one source per data shard; the mesh
  is the federation).
* ``model`` axis = intra-endpoint parallelism: each source's triples are
  **hash-partitioned by subject** across the model axis, so star-shaped
  subqueries (subject joins) execute entirely shard-locally -- the paper's
  "subqueries evaluated at the endpoint" invariant, in SPMD form.

Every sharded tensor carries the two axes as its leading dimensions,
``(d, m, ...)``, and each step runs the bounded-buffer operators
(``operators.py``) once over all shards.  Cross-star joins exchange rows by
join-key hash over the model axis (``Mesh.all_to_all``) and gather the build
side over the data axis (``Mesh.all_gather``) -- the *transferred tuples* of
the paper are the rows these collectives move, which is what Odyssey's
optimizer minimizes.  Only the mesh knows where the shards live.

A star scans only its patterns' predicate rows, in the shards of the
sources its plan selected: beside the tables the engine keeps each shard's
rows ordered by predicate (``operators.PredicateIndex``), their ranges on
the host.  All relations are bounded buffers; overflow flags are summed up
to the host, which reads them after every star and join.

The collected result is never read back whole: the answer rows (valid,
secondary join keys equal) are selected on the device and only they, and
their count, cross to the host.

Each request's ``DistMetrics`` times its stars, joins, read-back and host
rows on the host clock (each ends in a read to the host, so its time is
also the device's) and counts its reads, the bytes read back, the slots the
stars' scans compared and the slots the select scanned; the same four steps
are ``odyssey.exec.*`` spans under a profiler (``repro_torch.common.spans``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.common.spans import span
from repro_torch.core.decomposition import decompose
from repro_torch.core.planner import JoinPlanNode, PhysicalPlan, PlanNode, SubqueryNode
from repro_torch.engine import operators as ops
from repro_torch.engine.local import ExecutionResult, LocalEngine
from repro_torch.launch.mesh import Mesh
from repro_torch.query.algebra import BGPQuery, TriplePattern, Var
from repro_torch.rdf.dataset import Federation

# bytes ``torch.nonzero`` reads back on the card to size its output: one
# int32 count (one chunk below 2**31 elements)
NONZERO_COUNT_BYTES = 4


class AlgebraFallbackWarning(UserWarning):
    """The SPMD engine received an OPTIONAL/UNION/FILTER plan and degraded it
    to ``LocalEngine`` instead of failing (``ExecutionResult.fallback`` names
    the substitution).  Filterable: the fallback changes *where* the plan
    runs, never its rows."""


class UnsupportedShapeError(ValueError):
    """The federation or the plan does not fit the SPMD engine: more sources
    than data shards, a merged leaf on the single-star path, or a cartesian
    join.  Callers that run a workload skip the plan."""


def _has_algebra_nodes(node: PlanNode) -> bool:
    """True iff the plan tree contains any non-conjunctive operator (the
    forms ``_eval_node`` deliberately rejects)."""
    if isinstance(node, SubqueryNode):
        return False
    if isinstance(node, JoinPlanNode):
        return _has_algebra_nodes(node.left) or _has_algebra_nodes(node.right)
    return True


@dataclass
class DistRelation:
    """Host handle to a sharded bounded relation."""

    data: torch.Tensor       # (d, m, cap, C) int32
    valid: torch.Tensor      # (d, m, cap) bool
    overflow: torch.Tensor   # (d, m) bool, or (1, 1) after an exchange
    columns: list[str]       # var name per column
    partitioned_by: str | None = None  # var whose hash partitions the model axis
    # secondary join keys (column pairs), filtered on the device at collect
    extra_eq: list = field(default_factory=list)


@dataclass
class DistMetrics:
    transferred_tuples: int = 0
    collective_bytes: int = 0
    overflowed: bool = False
    host_syncs: int = 0          # reads back to the host
    readback_bytes: int = 0      # bytes the read-back copied to the host
    readback_slots: int = 0      # slots the select scanned: d * m * cap
    scan_slots: int = 0          # slots the star scans compared: d * m * L a pattern
    answer_rows: int = 0         # rows returned
    # host-clock milliseconds of the odyssey.exec.* spans, summed over the
    # plan; measurements, so left out of equality
    star_ms: float = field(default=0.0, compare=False)
    join_ms: float = field(default=0.0, compare=False)
    readback_ms: float = field(default=0.0, compare=False)
    rows_ms: float = field(default=0.0, compare=False)


@contextlib.contextmanager
def _timed(metrics: DistMetrics, step: str):
    """The ``odyssey.exec.<step>`` span over the body; its host-clock
    milliseconds are added to ``metrics.<step>_ms``."""
    t0 = time.perf_counter()
    with span(f"odyssey.exec.{step}"):
        yield
    attr = f"{step}_ms"
    setattr(metrics, attr, getattr(metrics, attr) + (time.perf_counter() - t0) * 1e3)


def _enc_pattern(tp: TriplePattern) -> list[int]:
    s, p, o = tp.constants()
    return [s if s is not None else -1, p if p is not None else -1,
            o if o is not None else -1]


class DistributedEngine:
    """Executes PhysicalPlans on a (data, model) mesh.

    ``cap`` bounds each operator's output rows *per shard*.  The tables and
    every relation live on ``mesh.device``; a request's
    ``DistMetrics.host_syncs`` counts its reads back to the host (the
    overflow flags and shipped counts after each star and join, and the
    answer rows' count and the rows).  With ``fed=None`` the engine holds
    no tables: its step functions run on tables of ``table_cap`` triples a
    shard that the caller supplies (``fed_query_step``).
    """

    def __init__(self, fed: Federation | None, mesh: Mesh, cap: int = 2048,
                 table_cap: int | None = None, partition_aware: bool = False):
        # partition_aware: skip the model-axis gather of the build side when
        # it is already hash-partitioned by the join key (baseline engines
        # gather unconditionally)
        self.partition_aware = partition_aware
        self.fed = fed
        self.mesh = mesh
        self.cap = cap
        self.d = mesh.shape["data"]
        self.m = mesh.shape["model"]
        self._star_fns: dict = {}
        if fed is None:
            if table_cap is None:
                raise ValueError("an engine without a federation needs table_cap")
            self.table_cap = table_cap
            self.tables = self.trow = None
            return
        if len(fed.sources) > self.d:
            raise UnsupportedShapeError(
                f"one endpoint per data shard: {len(fed.sources)} sources on "
                f"{self.d} data shards")
        if table_cap is None:
            table_cap = 1
            for src in fed.sources:
                counts = np.bincount(src.table.s % self.m, minlength=self.m) if len(src.table) else np.zeros(1, np.int64)
                table_cap = max(table_cap, int(counts.max()))
            table_cap = int(2 ** np.ceil(np.log2(table_cap)))
        self.table_cap = table_cap

        tables = np.zeros((self.d, self.m, table_cap, 3), np.int32)
        trow = np.zeros((self.d, self.m, table_cap), bool)
        for sid, src in enumerate(fed.sources):
            t = src.table
            part = t.s % self.m
            for mm in range(self.m):
                rows = np.nonzero(part == mm)[0]
                k = min(len(rows), table_cap)
                tables[sid, mm, :k, 0] = t.s[rows[:k]]
                tables[sid, mm, :k, 1] = t.p[rows[:k]]
                tables[sid, mm, :k, 2] = t.o[rows[:k]]
                trow[sid, mm, :k] = True
        self.tables = torch.from_numpy(tables).to(mesh.device)
        self.trow = torch.from_numpy(trow).to(mesh.device)
        # the star scans compare only their predicate's rows (``_eval_star``)
        self.pred_index = ops.PredicateIndex(tables[..., 1], trow, mesh.device)

    @staticmethod
    def _host(x: torch.Tensor, metrics: DistMetrics) -> np.ndarray:
        metrics.host_syncs += 1
        return x.cpu().numpy()

    @staticmethod
    def _nonzero(mask: torch.Tensor, metrics: DistMetrics) -> torch.Tensor:
        """The ascending indices of ``mask``'s set entries (cub's stable
        select on the card); a read to the host, since ``torch.nonzero``
        reads its count back to size its output."""
        metrics.host_syncs += 1
        metrics.readback_bytes += NONZERO_COUNT_BYTES
        return torch.nonzero(mask).squeeze(1)

    # ------------------------------------------------------------------
    # SPMD steps, each over all (d, m) shards at once
    # ------------------------------------------------------------------
    def _subject_joins(self, scans):
        """Subject-join a star's pattern scans, each ``(data, valid, overflow)``
        with columns [subject, object], shard-local.

        Output columns: [subject, obj_0, ..., obj_{n_pat-1}].
        """
        cap = self.cap
        scans = iter(scans)
        rel, valid, ovf = next(scans)
        for k, (nxt, nvalid, o2) in enumerate(scans, 1):
            rel, valid, o3 = ops.merge_join(rel, valid, 0, nxt, nvalid, 0, cap)
            # drop duplicated subject col from right side (at ncols_left)
            keep = list(range(rel.shape[-1]))
            keep.remove(k + 1)
            rel = rel[..., keep]
            ovf = ovf | o2 | o3
        return rel, valid, ovf

    def _star_fn(self, n_pat: int):
        """Scan + subject-join ``n_pat`` patterns of one star over the whole
        tables (``ops.scan_pattern``), the reference's step; the dry-run's
        canonical step (``fed_query_step``) runs it.  ``_eval_star`` scans
        each pattern's predicate rows only, with the same output.

        Output columns: [subject, obj_0, ..., obj_{n_pat-1}].
        """
        if n_pat in self._star_fns:
            return self._star_fns[n_pat]
        cap = self.cap

        def star(tables, trow, patterns, source_on):
            trow = trow & source_on.unsqueeze(-1)
            rel, valid, ovf = self._subject_joins(
                ops.scan_pattern(tables, trow, patterns[:, :, k], cap, (0, 2))
                for k in range(n_pat))
            return rel, valid, ovf, ops.count_valid(valid)

        self._star_fns[n_pat] = star
        return star

    def _exchange_fn(self, right_partitioned: bool = False):
        """Repartition rows over the model axis by hash of a key column, then
        merge-join against a local build side: the distributed hash join.

        ``right_partitioned``: the build side is already hash-partitioned by
        its join key over the model axis (true when joining a star on its
        subject), so the model-axis gather is skipped -- m x fewer build
        rows moved."""
        key = ("exch", right_partitioned)
        if key in self._star_fns:
            return self._star_fns[key]
        cap, d, m, mesh = self.cap, self.d, self.m, self.mesh

        def exchange(lrel, lvalid, rrel, rvalid, lkey, rkey):
            ncols = lrel.shape[-1]
            dev = lrel.device
            # --- exchange left rows by key % m over the model axis ---------
            keyv = lrel[..., lkey]
            dest = torch.where(lvalid, keyv % m, m)  # m = drop bucket
            bucket_cap = cap // m
            order = torch.argsort(dest, dim=-1, stable=True)
            sorted_dest = ops.take(dest, order)
            idx_in_dest = (torch.arange(cap, device=dev)
                           - ops.searchsorted(sorted_dest, sorted_dest, "left"))
            ovf = torch.where(sorted_dest < m, idx_in_dest, 0).amax(-1) >= bucket_cap
            slot = idx_in_dest.clamp(0, bucket_cap - 1)
            row_ok = (sorted_dest < m) & (idx_in_dest < bucket_cap)
            # rows that are not sent go to one spare row past the buffers;
            # the (destination, slot) pairs of the rest are unique
            shard = torch.arange(d * m, device=dev).reshape(d, m, 1)
            flat = torch.where(row_ok, (shard * m + sorted_dest) * bucket_cap + slot,
                               d * m * m * bucket_cap)
            send = torch.zeros(d * m * m * bucket_cap + 1, ncols,
                               dtype=torch.int32, device=dev)
            send.index_put_((flat.reshape(-1),), ops.take_rows(lrel, order).reshape(-1, ncols))
            svalid = torch.zeros(d * m * m * bucket_cap + 1, dtype=torch.bool, device=dev)
            svalid.index_put_((flat.reshape(-1),), row_ok.reshape(-1))
            send = send[:-1].reshape(d, m, m, bucket_cap, ncols)
            svalid = svalid[:-1].reshape(d, m, m, bucket_cap)
            shipped = svalid.sum((-2, -1), dtype=torch.int32)
            recv = mesh.all_to_all(send, "model")
            vrecv = mesh.all_to_all(svalid, "model")
            lrel2 = recv.reshape(d, m, -1, ncols)[:, :, :cap]
            lvalid2 = vrecv.reshape(d, m, -1)[:, :, :cap]
            # --- gather the build side across the federation ---------------
            if right_partitioned:
                # build rows already live on the model shard of their key:
                # gather over sources (data) only -- m x fewer rows
                rrel_g = mesh.all_gather(rrel, ("data",))
                rvalid_g = mesh.all_gather(rvalid, ("data",))
            else:
                rrel_g = mesh.all_gather(rrel, ("model", "data"))
                rvalid_g = mesh.all_gather(rvalid, ("model", "data"))
                # keep only build rows whose key hashes to this model shard
                my = mesh.axis_index("model").unsqueeze(-1)
                rvalid_g = rvalid_g & ((rrel_g[..., rkey] % m) == my)
            shipped = shipped + rvalid.sum(-1, dtype=torch.int32)
            out, ovalid, o2 = ops.merge_join(lrel2, lvalid2, lkey, rrel_g,
                                             rvalid_g, rkey, cap)
            shipped_total = mesh.psum(shipped, ("model", "data"))
            ovf_any = mesh.psum((ovf | o2).to(torch.int32), ("model", "data")) > 0
            return out, ovalid, ovf_any, shipped_total

        self._star_fns[key] = exchange
        return exchange

    def _collect_fn(self, ncols: int):
        """Gather a sharded relation to every shard (replicated result)."""
        key = ("collect", ncols)
        if key in self._star_fns:
            return self._star_fns[key]
        mesh = self.mesh

        def collect(rel, valid):
            return (mesh.all_gather(rel, ("model", "data")),
                    mesh.all_gather(valid, ("model", "data")))

        self._star_fns[key] = collect
        return collect

    # ------------------------------------------------------------------
    # plan execution
    # ------------------------------------------------------------------
    def _eval_star(self, node: SubqueryNode, metrics: DistMetrics) -> DistRelation:
        if len(node.stars) != 1:
            raise UnsupportedShapeError("merged leaves run on the exclusive path")
        with _timed(metrics, "star"):
            pats = [tp for tp in node.patterns if not isinstance(tp.p, Var)]
            src_on = np.zeros((self.d, self.m), bool)
            for s in node.sources:
                src_on[s] = True

            def scans():
                # each pattern's predicate rows in the selected sources'
                # shards; the ranges come from the host, so no read
                for tp in pats:
                    rel, slots = self.pred_index.scan(self.tables, _enc_pattern(tp),
                                                      src_on, self.cap, (0, 2))
                    metrics.scan_slots += slots
                    yield rel

            rel, valid, ovf = self._subject_joins(scans())
            metrics.overflowed |= bool(self._host(ovf.any(), metrics))
        subj = pats[0].s.name if isinstance(pats[0].s, Var) else f"_c{id(node)}"
        cols = [subj] + [tp.o.name if isinstance(tp.o, Var) else f"_o{k}"
                         for k, tp in enumerate(pats)]
        return DistRelation(rel, valid, ovf, cols, partitioned_by=subj)

    def _eval_node(self, node: PlanNode, metrics: DistMetrics) -> DistRelation:
        if isinstance(node, SubqueryNode):
            if len(node.stars) == 1:
                return self._eval_star(node, metrics)
            # exclusive group ("single SPARQL query to one endpoint", §3.4):
            # evaluate each star then join; rows stay within the source.
            return self._join_merged_leaf(node, metrics)
        if not isinstance(node, JoinPlanNode):
            raise NotImplementedError(
                f"the SPMD engine executes conjunctive (Subquery/Join) plans "
                f"only; got {type(node).__name__} -- run OPTIONAL/UNION/FILTER "
                "plans on repro_torch.engine.local.LocalEngine")
        left = self._eval_node(node.left, metrics)
        right = self._eval_node(node.right, metrics)
        return self._join(left, right, node.join_vars, metrics)

    def _join_merged_leaf(self, node: SubqueryNode, metrics: DistMetrics) -> DistRelation:
        graph = decompose(BGPQuery(list(node.patterns)))
        rels: list[DistRelation] = []
        for star in graph.stars:
            sub = SubqueryNode(stars=[0], patterns=star.patterns, sources=node.sources)
            rels.append(self._eval_star(sub, metrics))
        out = rels[0]
        for r in rels[1:]:
            jv = sorted(set(out.columns) & set(r.columns))
            out = self._join(out, r, jv, metrics)
        return out

    def _join(self, left: DistRelation, right: DistRelation, join_vars: list[str],
              metrics: DistMetrics) -> DistRelation:
        if not join_vars:
            raise UnsupportedShapeError("cartesian joins not supported in the SPMD engine")
        jv = join_vars[0]
        lkey = left.columns.index(jv)
        rkey = right.columns.index(jv)
        right_part = self.partition_aware and right.partitioned_by == jv
        with _timed(metrics, "join"):
            rel, valid, ovf, shipped = self._exchange_fn(right_partitioned=right_part)(
                left.data, left.valid, right.data, right.valid, lkey, rkey)
            # one read for both: the overflow flag and the shipped count
            ovf_any, n_ship = self._host(
                torch.stack([ovf.reshape(()).to(torch.int32), shipped.reshape(())]),
                metrics).tolist()
        metrics.overflowed |= bool(ovf_any)
        metrics.transferred_tuples += n_ship
        metrics.collective_bytes += n_ship * 4 * (len(left.columns) + len(right.columns))
        cols = left.columns + right.columns
        # dedupe duplicated join columns by renaming right dup
        seen: dict[str, int] = {}
        final_cols = []
        for c in cols:
            if c in seen:
                final_cols.append(f"{c}__dup{seen[c]}")
                seen[c] += 1
            else:
                seen[c] = 1
                final_cols.append(c)
        # secondary join keys: filter equality host-side at collect (rare)
        extra_eq = [(cols.index(v), len(left.columns) + right.columns.index(v))
                    for v in join_vars[1:]]
        return DistRelation(rel, valid, ovf, final_cols, partitioned_by=jv,
                            extra_eq=extra_eq)

    def execute(self, plan: PhysicalPlan) -> ExecutionResult:
        if _has_algebra_nodes(plan.root):
            # degrade, don't die: the SPMD steps are conjunctive-only
            # (``_eval_node`` still raises -- that contract is pinned), so
            # OPTIONAL/UNION/FILTER plans run on the host engine with the
            # substitution named on the result instead of surfacing a bare
            # NotImplementedError to serving code
            warnings.warn(
                "SPMD engine received an OPTIONAL/UNION/FILTER plan; "
                "degrading to LocalEngine (result.fallback = "
                "'local:algebra'; rows are identical, DistMetrics are not "
                "collected)", AlgebraFallbackWarning, stacklevel=2)
            res = LocalEngine(self.fed).execute(plan)
            return dataclasses.replace(res, fallback="local:algebra")
        metrics = DistMetrics()
        rel = self._eval_node(plan.root, metrics)
        with _timed(metrics, "readback"):
            ncols = len(rel.columns)
            data, valid = self._collect_fn(ncols)(rel.data, rel.valid)
            data, keep = data.reshape(-1, ncols), valid.reshape(-1)
            # select the answer rows on the device: valid slots whose
            # secondary join keys agree, in slot order (data-major,
            # model-minor, slot within a shard); only they are read back
            for (i, j) in rel.extra_eq:
                keep = keep & (data[:, i] == data[:, j])
            metrics.readback_slots = keep.numel()
            rows = self._host(data.index_select(0, self._nonzero(keep, metrics)), metrics)
            metrics.readback_bytes += rows.nbytes
        with _timed(metrics, "rows"):
            proj = plan.query.effective_projection()
            out: dict[str, np.ndarray] = {}
            for v in proj:
                out[v] = rows[:, rel.columns.index(v)]
            n_rows = len(rows)
            if plan.query.distinct and n_rows:
                stacked = np.stack([out[v] for v in proj], axis=1)
                _, idx = np.unique(stacked, axis=0, return_index=True)
                out = {v: out[v][np.sort(idx)] for v in proj}
                n_rows = len(idx)
        metrics.answer_rows = n_rows
        return ExecutionResult(rows=out, metrics=metrics, plan=plan,
                               stats_epoch=plan.stats_epoch)


def _star_subject(tp: TriplePattern):
    return tp.s


# ---------------------------------------------------------------------------
# the canonical federated query step, and its dry-run on fake tensors
# ---------------------------------------------------------------------------

def fed_query_step(eng: DistributedEngine, n_pat1: int = 3, n_pat2: int = 2,
                   optimized: bool = False):
    """The canonical federated query step: two star scans (``n_pat1`` and
    ``n_pat2`` patterns), the distributed hash join of the first star's
    first object with the second star's subject, and the collect.  Returns
    ``step(tables, trow, pat1, on1, pat2, on2) -> (rows, valid, overflow,
    shipped)``; ``optimized``: the right star joins on its own subject,
    which is its model-axis partition key, so the build side's model gather
    is skipped."""
    star1 = eng._star_fn(n_pat1)
    star2 = eng._star_fn(n_pat2)
    exchange = eng._exchange_fn(right_partitioned=optimized)
    collect = eng._collect_fn(n_pat1 + 1 + n_pat2 + 1)

    def step(tables, trow, pat1, on1, pat2, on2):
        r1, v1, o1, _ = star1(tables, trow, pat1, on1)
        r2, v2, o2, _ = star2(tables, trow, pat2, on2)
        out, ov, o3, shipped = exchange(r1, v1, r2, v2, 1, 0)
        rows, valid = collect(out, ov)
        return rows, valid, (o1 | o2 | o3), shipped

    return step


def fed_dryrun_lower(mesh: Mesh, cap: int = 8192, table_cap: int = 1 << 20,
                     n_pat1: int = 3, n_pat2: int = 2, optimized: bool = False):
    """Trace the canonical federated query step (``fed_query_step``) on an
    abstract federation sized like FedBench at scale: one endpoint per data
    shard, ``table_cap`` triples per (source, model) shard, on fake tensors
    (no memory) of the reference's shapes and dtypes.  Returns the op trace
    (``launch/roofline.OpTrace``, whole-mesh ops over ``d * m`` shards and
    the collectives a ``roofline.BookingMesh`` of ``mesh``'s shape books per
    shard) where the reference returns a jax ``Lowered``.  ``mesh`` is a
    ``launch/mesh.py`` mesh on the CPU; on the multi-pod mesh the step
    replicates across ``pod``, so its tensors and trace are the single
    pod's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.roofline import BookingMesh, record_ops

    mesh = BookingMesh(mesh.shape, mesh.axis_names, mesh.device)
    eng = DistributedEngine(None, mesh, cap, table_cap)
    d, m, dev = eng.d, eng.m, mesh.device
    step = fed_query_step(eng, n_pat1, n_pat2, optimized)
    i32 = dict(dtype=torch.int32, device=dev)
    with FakeTensorMode():
        args = (torch.empty((d, m, table_cap, 3), **i32),
                torch.empty((d, m, table_cap), dtype=torch.bool, device=dev),
                torch.empty((d, m, n_pat1, 3), **i32),
                torch.empty((d, m), dtype=torch.bool, device=dev),
                torch.empty((d, m, n_pat2, 3), **i32),
                torch.empty((d, m), dtype=torch.bool, device=dev))
        base = sum(t.numel() * t.element_size() for t in args) // (d * m)
        with record_ops(shards=d * m, base_bytes=base) as trace:
            step(*args)
    return trace
