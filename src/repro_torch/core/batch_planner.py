"""Truly batched query planning — the serving path behind
``OdysseyOptimizer.optimize_batch`` (a copy of the reference package's
``core/batch_planner.py``; each shape group's stacked DP sweep runs on the
optimizer's ``device``).

A batch is planned as one pipeline over all of its queries instead of a loop
of independent ``optimize()`` calls:

1. **Epoch snapshot.**  The statistics epoch is read exactly once; every
   plan emitted by the batch is stamped with it and every cache entry is
   keyed under it.  A ``remove_source``/``refresh_source`` landing mid-batch
   can therefore never split the batch across epochs — the whole batch is
   planned "as of" the snapshot, and the epoch bump makes its cache entries
   lazily stale, exactly like a plan cached just before the mutation.
2. **Plan-cache hits.**  Each query's ``query_signature`` is looked up under
   the snapshot epoch; hits are rebound per query as in ``optimize``.
3. **Exact-signature dedupe.**  Later queries with a signature already being
   planned in this batch are rebound from the first member's plan and marked
   ``cached=True`` — a duplicate is a hit whether the entry lives in the
   ``PlanCache`` or only in the batch (the cache-off path behaves the same).
4. **Shape grouping.**  The remaining queries are decomposed up front and
   grouped by *structural shape*: star-graph topology
   (``star_graph_topology`` — star count + ordered edge list), per-star
   predicate signatures, and the DISTINCT flag.  Object constants are
   deliberately not part of the shape, so every instantiation of a query
   template lands in one group.
5. **Shared source selection.**  ``select_sources_batch`` runs over the
   union of the fresh queries' graphs with one ``SelectionMemo``: per-star
   relevant-CS scans, federated-CS candidates and CP edge probes are priced
   once for the batch, and graphs with equal selection keys share one
   pruning fixpoint.
6. **One DP sweep per shape.**  ``dp_join_order_batch`` runs the
   bitmask-DP layer sweep once per group on the optimizer's ``dp_backend``
   and ``device`` (under ``'torch'`` on a card, one resident ``dp_sweep``
   launch with the member axis stacked), with the per-layer candidate
   tensors stacked along the member axis; each member's tree is
   bit-identical to planning it alone.
7. **Emit + cache.**  Plans are emitted per member, stamped with the epoch
   snapshot, and inserted into the plan cache under their own signatures.

**Equivalence guarantee.**  Every stage either reuses the single-query code
(``query_signature``, ``_rebind``, ``_emit``) or is differentially held to
bit-identity with it (``select_sources_batch`` vs ``select_sources``,
``dp_join_order_batch`` vs ``dp_join_order``), so
``optimize_batch(queries)`` returns, per query, exactly the plan
``[optimize(q) for q in queries]`` would — batching changes the planning
cost, never the plans.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator

from repro_torch.core.decomposition import StarGraph, decompose
from repro_torch.core.join_order import (DP_SWEEP_COUNTERS, dp_join_order_batch,
                                   star_graph_topology)
from repro_torch.core.source_selection import (
    SelectionMemo,
    select_sources_batch,
    selection_key,
)
from repro_torch.query.algebra import BGPQuery, Const


@dataclass
class BatchPlanReport:
    """What a batch actually shared — attached to the optimizer as
    ``last_batch_report`` after every ``optimize_batch`` call."""

    n_queries: int = 0
    cache_hits: int = 0          # served from the PlanCache under the snapshot
    duplicates: int = 0          # exact-signature repeats rebound in-batch
    n_planned: int = 0           # queries that ran the full pipeline
    n_shapes: int = 0            # distinct shape groups among planned queries
    n_priced: int = 0            # distinct pricing keys (DP members actually swept)
    n_selections: int = 0        # distinct selection fixpoints actually run
    dp_resident: int = 0         # sweeps run as one resident device program
    dp_tiled: int = 0            # torch sweeps that fell back to per-layer tiles
    stats_epoch: int = 0         # the single epoch snapshot
    total_ms: float = 0.0


def shape_key(graph: StarGraph, distinct: bool) -> tuple:
    """Structural shape of a query: star-graph topology (star count + ordered
    edge list), per-star predicate signatures (subject-constant flag + the
    ordered predicate list, ``None`` for variable predicates), and DISTINCT.
    Everything the DP sweep's *structure* depends on is in here; everything
    that only shifts the numbers (constants, selected sources, cardinalities)
    is deliberately out, so template instantiations share one sweep."""
    stars = tuple(
        (isinstance(s.subject, Const),
         tuple(tp.p.tid if isinstance(tp.p, Const) else None
               for tp in s.patterns))
        for s in graph.stars)
    return (star_graph_topology(graph), stars, bool(distinct))


def pricing_key(graph: StarGraph, distinct: bool) -> tuple:
    """Everything the planner's *numbers* depend on: the shape plus subject
    constants (they steer ``cs_of_entity`` relevance and the bounded-subject
    cardinality clamp) and which object positions hold constants.  Object
    constant *values* are deliberately absent: no CS/CP estimate conditions
    on them (``_bound_object_factor`` uses only the predicate's occurrence
    counts), so two queries with equal pricing keys get bit-identical
    selections, statistics, DP state and join trees — the batch prices such
    a family once and only re-emits per member.  If an estimate ever starts
    reading object values, they must join this key."""
    stars = tuple(
        (s.subject.tid if isinstance(s.subject, Const) else None,
         tuple((tp.p.tid if isinstance(tp.p, Const) else None,
                isinstance(tp.o, Const)) for tp in s.patterns))
        for s in graph.stars)
    return (star_graph_topology(graph), stars, bool(distinct))


# -- plan-sharing affinity, without planning ---------------------------------

AFFINITY_TIERS = ("signature", "selection", "pricing", "shape")


@dataclass(frozen=True)
class AffinityKey:
    """The four plan-sharing tiers of one query, deepest first — exactly the
    tiering ``plan_batch`` exploits, computed host-side from the query text
    alone (no statistics, no source selection, no DP).  Two queries that are
    equal at a tier share correspondingly more of the batched pipeline:

    - ``signature``: exact ``query_signature`` — duplicates/cache hits; the
      whole plan is shared (rebound per query).
    - ``selection``: one source-selection fixpoint for the group.
    - ``pricing``: bit-identical statistics, DP state and join tree; priced
      once, re-emitted per member.
    - ``shape``: one stacked DP sweep, per-member costing.

    ``selection``/``pricing``/``shape`` are ``None`` for non-conjunctive
    (group-tree) queries, which only share at the signature tier.
    """

    signature: tuple
    selection: "tuple | None"
    pricing: "tuple | None"
    shape: "tuple | None"

    def tier_keys(self) -> "Iterator[tuple[str, tuple]]":
        """(tier name, key) pairs, deepest tier first, skipping tiers this
        query does not participate in."""
        for name, key in zip(AFFINITY_TIERS, (self.signature, self.selection,
                                              self.pricing, self.shape)):
            if key is not None:
                yield name, key


def plan_affinity(query: BGPQuery) -> AffinityKey:
    """Affinity key of one query for admission-time batch formation (the
    serving scheduler groups queued requests whose keys match at the deepest
    possible tier).  Pure host-side structure: safe to call on every
    ``submit`` without touching statistics or the planner."""
    from repro_torch.core.planner import query_signature

    sig, _ = query_signature(query)
    if not query.is_conjunctive():
        return AffinityKey(signature=sig, selection=None, pricing=None,
                           shape=None)
    graph = decompose(query)
    return AffinityKey(signature=sig,
                       selection=selection_key(graph),
                       pricing=pricing_key(graph, query.distinct),
                       shape=shape_key(graph, query.distinct))


def plan_batch(optimizer, queries: "list[BGPQuery]"):
    """The batched planning pipeline (see the module docstring).  Returns one
    ``PhysicalPlan`` per query, in order."""
    from repro_torch.core.planner import CacheEntry, PhysicalPlan, _detach_plan, \
        query_signature

    t_start = time.perf_counter()
    epoch = optimizer.stats_epoch          # the one and only epoch read
    cache = optimizer.plan_cache
    report = BatchPlanReport(n_queries=len(queries), stats_epoch=epoch)
    dp_ctr0 = (DP_SWEEP_COUNTERS["resident"], DP_SWEEP_COUNTERS["tiled"])
    plans: "list[PhysicalPlan | None]" = [None] * len(queries)

    # -- cache hits + exact-signature dedupe --------------------------------
    sigs = [query_signature(q) for q in queries]
    owner: dict[tuple, int] = {}           # sig -> first fresh member
    dup_of: dict[int, int] = {}
    fresh: list[int] = []
    for i, q in enumerate(queries):
        sig, var_order = sigs[i]
        if sig in owner:                   # duplicate of a plan built below
            dup_of[i] = owner[sig]
            continue
        if cache is not None:
            t0 = time.perf_counter()
            entry = cache.get(sig, epoch=epoch)
            if entry is not None:
                plan = optimizer._rebind(entry, var_order, q)
                plan.optimization_ms = (time.perf_counter() - t0) * 1e3
                plans[i] = plan
                report.cache_hits += 1
                continue
        owner[sig] = i
        fresh.append(i)

    # -- decompose, group by shape, select sources over the union -----------
    local: dict[tuple, CacheEntry] = {}    # owner plans when the cache is off

    # Non-conjunctive (group-tree) queries bypass the stacked conjunctive
    # pipeline: each runs the compositional planner under the same epoch
    # snapshot and lands in the cache like any other owner, so duplicates of
    # an OPTIONAL/UNION/FILTER template still rebind below.
    alg = [i for i in fresh if not queries[i].is_conjunctive()]
    if alg:
        fresh = [i for i in fresh if queries[i].is_conjunctive()]
        for i in alg:
            t0 = time.perf_counter()
            plan = optimizer._optimize_uncached(queries[i], t0)
            plan.stats_epoch = epoch
            plans[i] = plan
            report.n_planned += 1
            sig, var_order = sigs[i]
            if cache is not None:
                cache.put(sig, plan, var_order, epoch=epoch)
            else:
                local[sig] = CacheEntry(_detach_plan(plan), var_order, epoch)

    if fresh:
        t_shared = time.perf_counter()
        graphs = {i: decompose(queries[i]) for i in fresh}
        memo = SelectionMemo()
        sels = dict(zip(fresh, select_sources_batch(
            [graphs[i] for i in fresh], optimizer.stats, memo=memo)))
        report.n_selections = len({selection_key(graphs[i]) for i in fresh})
        groups: dict[tuple, list[int]] = {}
        for i in fresh:
            groups.setdefault(shape_key(graphs[i], queries[i].distinct),
                              []).append(i)
        report.n_shapes = len(groups)
        shared_ms = (time.perf_counter() - t_shared) * 1e3

        # -- one stacked DP sweep per shape, then per-member emission -------
        for key, members in groups.items():
            # price once per distinct pricing key: members differing only in
            # object-constant values share every estimate, so they share one
            # DP member (and its warm statistics memo) and only re-emit
            t_g = time.perf_counter()
            sub: dict[tuple, list[int]] = {}
            for i in members:
                sub.setdefault(pricing_key(graphs[i], queries[i].distinct),
                               []).append(i)
            fams = list(sub.values())
            reps = [fam[0] for fam in fams]
            report.n_priced += len(reps)
            trees = dp_join_order_batch(
                [graphs[r] for r in reps], optimizer.stats,
                [sels[r] for r in reps], optimizer.cost_model,
                distinct=key[-1], block_bytes=optimizer.dp_block_bytes,
                dp_backend=optimizer.dp_backend, device=optimizer.device)
            sweep_ms = (time.perf_counter() - t_g) * 1e3
            for fam, tree in zip(fams, trees):
                rep = fam[0]
                for i in fam:
                    t_e = time.perf_counter()
                    q = queries[i]
                    if i != rep:
                        # identical values by construction: reuse the rep's
                        # warm per-query memo so emission's §3.1 ordering
                        # re-reads instead of re-deriving the cardinalities
                        sels[i]._memo = sels[rep]._memo
                    root = optimizer._emit(tree, graphs[i], sels[i], q)
                    plan = PhysicalPlan(root=root, query=q, graph=graphs[i],
                                        selection=sels[i], stats_epoch=epoch)
                    plan.fallback = any(s.has_var_pred for s in graphs[i].stars)
                    # amortized attribution: the shared decompose+selection
                    # pass over all fresh queries, the group's sweep over its
                    # members, this member's own emission
                    plan.optimization_ms = (
                        shared_ms / len(fresh) + sweep_ms / len(members)
                        + (time.perf_counter() - t_e) * 1e3)
                    plans[i] = plan
                    report.n_planned += 1
                    sig, var_order = sigs[i]
                    if cache is not None:
                        cache.put(sig, plan, var_order, epoch=epoch)
                    else:
                        local[sig] = CacheEntry(_detach_plan(plan), var_order,
                                                epoch)

    # -- rebind exact duplicates: a duplicate is a hit (cached=True) either
    # way; with the cache on it goes through PlanCache.get so hit counters
    # and LRU order match the sequential loop --------------------------------
    for i, j in dup_of.items():
        q = queries[i]
        sig, var_order = sigs[i]
        t0 = time.perf_counter()
        entry = cache.get(sig, epoch=epoch) if cache is not None else local[sig]
        if entry is None:
            # the owner's entry was LRU-evicted within this batch (cache
            # smaller than the batch's distinct signatures): replan, exactly
            # as the sequential loop would on its miss
            plan = optimizer._optimize_uncached(q, t0)
            plan.stats_epoch = epoch
            cache.put(sig, plan, var_order, epoch=epoch)
            plans[i] = plan
            report.n_planned += 1
            continue
        plan = optimizer._rebind(entry, var_order, q)
        plan.optimization_ms = (time.perf_counter() - t0) * 1e3
        plans[i] = plan
        report.duplicates += 1

    report.dp_resident = DP_SWEEP_COUNTERS["resident"] - dp_ctr0[0]
    report.dp_tiled = DP_SWEEP_COUNTERS["tiled"] - dp_ctr0[1]
    report.total_ms = (time.perf_counter() - t_start) * 1e3
    optimizer.last_batch_report = report
    return plans
