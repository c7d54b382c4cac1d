"""Join ordering (paper §3.1 + §3.4 step ii).

* Inside a star: the greedy recursive scheme of §3.1 — estimate the
  cardinality of every (k-1)-subset with formula (1)/(2); the pattern missing
  from the cheapest subset is executed last; recurse on the cheapest subset.
* Across stars: stars collapse into meta-nodes; exact dynamic programming over
  connected subsets, with cardinalities from CS/CP statistics and the §3.4
  cost function (intermediate results + transfers).

Two DP implementations share the same plan space and cost model:

``dp_join_order``      vectorized bitmask DP — subsets are integer bitmasks,
                       per-subset cardinalities / connectivity / exclusive
                       groups are precomputed numpy arrays, and each popcount
                       layer costs its (subset, partition) candidates with
                       array ops.  Only *connected* subsets are enumerated,
                       and only partitions into two connected halves are
                       costed (DPccp-style csg/cmp pairs — on chains and
                       trees the layer work collapses from all ``2^n`` masks
                       to the sparse connected family), in fixed-size tiles
                       whose peak memory is bounded by ``block_bytes``
                       (default ``DP_BLOCK_BYTES``) regardless of the star
                       count.  Star cardinalities and edge selectivities are
                       memoized per query (and the underlying CS/CP formulas
                       on the statistics objects, see
                       ``repro_torch.core.cardinality``), so batches of related
                       queries amortize the statistics work.  This is the
                       optimizer hot path.  ``dp_join_order_batch`` runs the
                       same sweep once over a whole *shape group* — queries
                       with identical ``star_graph_topology`` — stacking the
                       per-layer candidate tensors along a member axis, and
                       returns per-member trees bit-identical to planning
                       each member alone.  Both forms take
                       ``dp_backend='numpy'|'torch'`` and a ``device``: the
                       numpy backend runs the tiled layer sweep in-process;
                       the torch backend (the default, on ``device='cuda'``)
                       runs the whole sweep with the DP state resident on
                       the device through the CUDA kernel
                       ``repro_torch.kernels.dp_layer.dp_sweep`` — the host
                       enumerates the topology's layer schedule once —
                       whenever the schedule fits the tile budget, falling
                       back to the dense layer-tile kernel
                       ``repro_torch.kernels.dp_layer.dp_layer`` otherwise,
                       with identical enumeration order and
                       first-strict-minimum tie-breaking, so the two
                       backends return bit-identical plans.  On a CPU
                       ``device`` the torch backend runs the kernels' plain
                       PyTorch versions.
``dp_join_order_ref``  the original frozenset/`itertools.combinations`
                       formulation with unmemoized statistics, kept as the
                       reference oracle — tests assert the bitmask DP returns
                       plans with identical cost and leaf order.

Both enumerate candidates in the same order (exclusive-group leaf, then for
each proper submask in (popcount asc, combination-lex) order: hash join, then
bind join) and break cost ties by first occurrence, so they pick the same
plan even when several plans share the optimal cost.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from itertools import combinations

import numpy as np

from repro_torch.core.cardinality import (
    linked_star_cardinality_distinct,
    linked_star_cardinality_distinct_cached,
    linked_star_cardinality_estimate,
    linked_star_cardinality_estimate_cached,
    star_cardinality_distinct,
    star_cardinality_distinct_cached,
    star_cardinality_estimate,
    star_cardinality_estimate_cached,
)
from repro_torch.core.cost import CostModel
from repro_torch.core.decomposition import Edge, Star, StarGraph
from repro_torch.core.federation import FederatedStats
from repro_torch.core.source_selection import SourceSelection
from repro_torch.query.algebra import Const, TriplePattern, Var

GENERIC_EDGE_SELECTIVITY = 1e-3  # fallback for non object->subject joins


def _bound_object_factor(star: Star, preds: list[int], stats: FederatedStats,
                         sources: list[int]) -> float:
    """Extra selectivity for patterns with a constant object: 1/#distinct
    objects of the predicate (uniformity only where CSs cannot help — the CS
    statistics do not condition on object values)."""
    f = 1.0
    for tp in star.patterns:
        if isinstance(tp.p, Const) and isinstance(tp.o, Const):
            n_obj = 0
            for s in sources:
                cs = stats.cs[s]
                rel = cs.relevant_cs(preds)
                occ = sum(cs.occurrences(int(c), tp.p.tid) for c in rel)
                n_obj = max(n_obj, occ)
            f *= 1.0 / max(1.0, float(n_obj)) * max(1.0, float(len(sources)))
            f = min(f, 1.0)
    return f


def star_cardinality(star: Star, stats: FederatedStats, sel: SourceSelection,
                     distinct: bool, preds: list[int] | None = None,
                     use_cache: bool = True) -> float:
    """Cardinality of one star over its selected sources (formulas 1/2,
    summed over sources — each entity lives in one source, footnote 4).

    Memoized on the (per-query) source selection keyed by (star, preds,
    distinct); ``use_cache=False`` recomputes from scratch (the reference
    path used by ``dp_join_order_ref``)."""
    if use_cache:
        key = ("sc", star.idx, None if preds is None else tuple(preds), distinct)
        memo = sel._memo
        v = memo.get(key)
        if v is not None:
            return v
    if preds is None:
        preds = star.bound_preds()
    srcs = sel.star_sources[star.idx]
    total = 0.0
    for s in srcs:
        rel = sel.star_cs[star.idx].get(s)
        cs = stats.cs[s]
        if rel is None:
            rel = cs.relevant_cs(preds)
        else:
            rel = np.intersect1d(rel, cs.relevant_cs(preds), assume_unique=False)
        if distinct:
            total += (star_cardinality_distinct_cached(cs, preds, rel) if use_cache
                      else star_cardinality_distinct(cs, preds, rel))
        else:
            total += (star_cardinality_estimate_cached(cs, preds, rel) if use_cache
                      else star_cardinality_estimate(cs, preds, rel))
    if isinstance(star.subject, Const):
        total = min(total, 1.0) if distinct else total / max(1.0, total)
    else:
        total *= _bound_object_factor(star, preds, stats, srcs)
    if use_cache:
        memo[key] = total
    return total


def star_source_cardinalities(star: Star, stats: FederatedStats,
                              sel: SourceSelection, distinct: bool,
                              sources: "list[int]") -> "list[float]":
    """Per-source split of ``star_cardinality`` over ``sources`` — the
    estimate each endpoint's scan of this star is expected to ship, the
    baseline the pipeline's observed-cardinality feedback scores endpoints
    against.  The raw per-source formula-1/2 totals are scaled so they sum to
    the star's memoized (factor-adjusted) cardinality; every per-CS term is a
    cache hit after the DP already priced the star."""
    preds = star.bound_preds()
    per: "list[float]" = []
    for s in sources:
        rel = sel.star_cs[star.idx].get(s)
        cs = stats.cs[s]
        if rel is None:
            rel = cs.relevant_cs(preds)
        else:
            rel = np.intersect1d(rel, cs.relevant_cs(preds), assume_unique=False)
        per.append(star_cardinality_distinct_cached(cs, preds, rel) if distinct
                   else star_cardinality_estimate_cached(cs, preds, rel))
    total = star_cardinality(star, stats, sel, distinct)
    raw = sum(per)
    scale = (total / raw) if raw > 0 else 0.0
    return [p * scale for p in per]


def order_star_patterns(star: Star, stats: FederatedStats, sel: SourceSelection,
                        distinct: bool) -> list[TriplePattern]:
    """§3.1 greedy: drop the pattern absent from the cheapest (k-1)-subset."""
    patterns = list(star.patterns)
    bound = [tp for tp in patterns if isinstance(tp.p, Const)]
    unbound = [tp for tp in patterns if not isinstance(tp.p, Const)]
    if len(bound) <= 1:
        return bound + unbound

    order_tail: list[TriplePattern] = []
    current = bound
    while len(current) > 2:
        best_sub = None
        best_card = None
        for sub in combinations(current, len(current) - 1):
            preds = [tp.p.tid for tp in sub]
            card = star_cardinality(star, stats, sel, distinct, preds)
            if best_card is None or card < best_card:
                best_card = card
                best_sub = sub
        dropped = [tp for tp in current if tp not in best_sub][0]
        order_tail.append(dropped)
        current = list(best_sub)
    # order the final pair: cheaper single pattern first
    c0 = star_cardinality(star, stats, sel, distinct, [current[0].p.tid])
    c1 = star_cardinality(star, stats, sel, distinct, [current[1].p.tid])
    first_two = current if c0 <= c1 else [current[1], current[0]]
    return first_two + order_tail[::-1] + unbound


def edge_selectivity(edge: Edge, graph: StarGraph, stats: FederatedStats,
                     sel: SourceSelection, distinct: bool,
                     use_cache: bool = True) -> float:
    """Join selectivity of a star-link from CP statistics, aggregated over the
    viable source pairs of the edge.  Memoized like ``star_cardinality``."""
    if edge.generic or edge.pred is None:
        return GENERIC_EDGE_SELECTIVITY
    if use_cache:
        key = ("es", edge.src, edge.dst, edge.pred, distinct)
        memo = sel._memo
        v = memo.get(key)
        if v is not None:
            return v
    s1 = graph.stars[edge.src]
    s2 = graph.stars[edge.dst]
    p1 = s1.bound_preds()
    p2 = s2.bound_preds()
    links = 0.0
    for a in sel.star_sources[edge.src]:
        for b in sel.star_sources[edge.dst]:
            cp = stats.cp_between(a, b)
            if cp is None:
                continue
            if distinct:
                links += (linked_star_cardinality_distinct_cached(
                    cp, stats.cs[a], stats.cs[b], p1, p2, edge.pred) if use_cache
                    else linked_star_cardinality_distinct(
                        cp, stats.cs[a], stats.cs[b], p1, p2, edge.pred))
            else:
                links += (linked_star_cardinality_estimate_cached(
                    cp, stats.cs[a], stats.cs[b], p1, p2, edge.pred) if use_cache
                    else linked_star_cardinality_estimate(
                        cp, stats.cs[a], stats.cs[b], p1, p2, edge.pred))
    c1 = max(1.0, star_cardinality(s1, stats, sel, True, use_cache=use_cache))
    c2 = max(1.0, star_cardinality(s2, stats, sel, True, use_cache=use_cache))
    out = min(1.0, links / (c1 * c2))
    if use_cache:
        memo[key] = out
    return out


# --------------------------------------------------------------------------
# DP over meta-nodes
# --------------------------------------------------------------------------

@dataclass
class JoinTree:
    kind: str                      # "leaf" | "join"
    stars: frozenset[int]
    cardinality: float
    cost: float
    left: "JoinTree | None" = None
    right: "JoinTree | None" = None
    strategy: str = ""
    sources: list[int] | None = None      # for leaves (merged => exclusive)

    def leaf_order(self) -> list[int]:
        if self.kind == "leaf":
            return sorted(self.stars)
        return self.left.leaf_order() + self.right.leaf_order()  # type: ignore[union-attr]


def _star_edge_statistics(graph: StarGraph, stats: FederatedStats,
                          sel: SourceSelection, distinct: bool,
                          use_cache: bool = True,
                          ) -> tuple[list[float], list[float]]:
    """Per-star cardinalities and per-edge selectivities (same values on both
    paths; the cached path memoizes on the selection / statistics objects)."""
    star_card = [max(star_cardinality(s, stats, sel, distinct, use_cache=use_cache), 0.0)
                 for s in graph.stars]
    edge_sel = [edge_selectivity(e, graph, stats, sel, distinct, use_cache=use_cache)
                for e in graph.edges]
    return star_card, edge_sel


# -- vectorized bitmask DP ---------------------------------------------------

# Default budget (bytes) for a layer's candidate tiles.  When every pair of
# a dense tile survives the connectivity filter, the live state per pair is
# the int64 submask/complement matrices plus the compacted index, cost-model
# input and candidate-cost arrays — ~150 bytes at the worst stage (measured
# on clique layers) — so tiles are sized at ``block_bytes / _PAIR_BYTES``
# pairs and the sweep materializes at most about ``block_bytes`` of
# candidate state at any time regardless of star count — the knob that
# removed the old 14-star ``MAX_BITMASK_STARS`` cliff.
DP_BLOCK_BYTES = 256 * 1024 * 1024
_PAIR_BYTES = 160

# Floor on the per-tile pair count.  Without it a large member count (or a
# tiny ``block_bytes``) degenerates ``block_bytes / (_PAIR_BYTES * B)`` to
# 1-pair tiles, turning the vectorized sweep into a Python-level per-pair
# loop.  When a member-stacked sweep cannot afford this floor within its
# budget, ``_dp_sweep`` splits the *member axis* into sub-batches that can
# (plans are per-member bit-identical either way); a single-member sweep
# keeps the floor even when it nominally exceeds a pathological budget —
# bounded planning time wins over a sub-kilobyte memory cap.
MIN_TILE_ELEMS = 1024

DP_BACKENDS = ("numpy", "torch")

# Where the torch backend runs unless the caller asks for another device.
DEFAULT_DEVICE = "cuda"

_STRAT_SINGLE, _STRAT_EXCL, _STRAT_HASH, _STRAT_BIND = 1, 2, 3, 4

# Observability for the torch backend's two execution modes: 'resident' ==
# the whole sweep ran with the DP state on the device (kernels.dp_layer.
# dp_sweep, one launch per layer), 'tiled' == it fell back to per-layer-tile
# kernel calls (schedule too large for the memory budget, or n too big for
# int32 masks).
DP_SWEEP_COUNTERS = {"resident": 0, "tiled": 0,
                     "schedule_builds": 0, "schedule_hits": 0}

# Resident sweeps ship int32 mask indices; past this star count the dense
# 2^n state wouldn't fit a sane budget anyway (the roadmap's hash-indexed
# connected-subsets table is the real fix for 22+ stars).
_RESIDENT_MAX_STARS = 20

# Rough bytes of live device state per scheduled candidate pair during one
# layer step of the resident sweep, used for the budget eligibility check.
# Kept at the reference package's value so the same topologies go resident
# or tiled in both packages.
_RESIDENT_PAIR_BYTES = 88

# Proper nonempty submasks of an s-element set, *relative* to the set's bit
# positions (bit j == j-th smallest member), in the reference enumeration
# order: popcount ascending, combination-lex within a popcount.  Lex order on
# ascending position tuples equals descending numeric order of the
# bit-reversed mask, so the table is one stable lexsort.  Depends only on s,
# cached across calls for the common sizes.
_REL_SUBMASKS: dict[int, np.ndarray] = {}
_REL_SUBMASK_CACHE_MAX_S = 16   # cache tables up to 2^16 entries (~0.5 MB)


def _rel_submasks(s: int) -> np.ndarray:
    rel = _REL_SUBMASKS.get(s)
    if rel is None:
        t = np.arange(1, (1 << s) - 1, dtype=np.int64)
        pop = np.zeros(len(t), np.int64)
        rev = np.zeros(len(t), np.int64)
        for j in range(s):
            bit = (t >> j) & 1
            pop += bit
            rev |= bit << (s - 1 - j)
        rel = t[np.lexsort((-rev, pop))]
        if s <= _REL_SUBMASK_CACHE_MAX_S:
            _REL_SUBMASKS[s] = rel
    return rel


# Small-star fast path: for n <= 10 the *dense* per-layer structures (masks,
# bit positions, and the full (submask A, complement B) matrices — at most
# 3^10 ≈ 59k pairs) are graph-independent and tiny, so they are built once
# per star count and reused across queries.  The sweep then skips the
# per-call submask deposit entirely; enumeration order and reduction are
# shared with the tiled path.  Entry per layer s = 2..n:
#   (S_all (n_S,), idx (n_S, s), pow2 (n_S, s), A (n_t, n_S), B (n_t, n_S))
_SKEL_CACHE: dict[int, list] = {}
_SKEL_CACHE_MAX_N = 10


def _layer_skeletons(n: int) -> list:
    skel = _SKEL_CACHE.get(n)
    if skel is None:
        masks = np.arange(1 << n, dtype=np.int64)
        pop = np.zeros(1 << n, np.int64)
        for i in range(n):
            pop += (masks >> i) & 1
        skel = []
        for s in range(2, n + 1):
            S_all = masks[pop == s]
            bitm = ((S_all[:, None] >> np.arange(n, dtype=np.int64)) & 1) == 1
            idx = np.nonzero(bitm)[1].reshape(len(S_all), s).astype(np.int64)
            pw = np.int64(1) << idx
            rel = _rel_submasks(s)
            A = np.zeros((len(rel), len(S_all)), np.int64)
            for j in range(s):
                A += ((rel >> j) & 1)[:, None] * pw[:, j][None, :]
            skel.append((S_all, idx, pw, A, S_all[None, :] ^ A))
        _SKEL_CACHE[n] = skel
    return skel


def _subset_cardinalities(graph: StarGraph, star_card: list[float],
                          edge_sel: list[float], masks: np.ndarray) -> np.ndarray:
    """`card[m]` = Π star_card over members · Π edge selectivities of edges
    inside `m` (each (min, max, pred) key counted once, first edge wins).
    Folds run member-ascending then edge-ascending — the same multiplication
    order as the reference's per-subset products."""
    n = len(graph.stars)
    card = np.ones(len(masks))
    for i in range(n):
        member = ((masks >> i) & 1) == 1
        card[member] *= star_card[i]
    seen: set[tuple[int, int, int | None]] = set()
    for k, e in enumerate(graph.edges):
        key = (min(e.src, e.dst), max(e.src, e.dst), e.pred)
        if key in seen:
            continue
        seen.add(key)
        em = (1 << e.src) | (1 << e.dst)
        inside = (masks & em) == em
        card[inside] *= edge_sel[k]
    return card


def star_graph_topology(graph: StarGraph) -> tuple:
    """Structural identity of a star graph as the DP sees it: star count plus
    the ordered edge list (endpoints, link predicate, generic flag).  Graphs
    with equal topology share the DP's mask/connectivity/enumeration
    structure and the edge-dedupe fold of ``_subset_cardinalities`` — only
    the numeric inputs (star cardinalities, edge selectivities, per-star
    source lists) differ, which is what ``dp_join_order_batch`` exploits."""
    return (len(graph.stars),
            tuple((e.src, e.dst, e.pred, e.generic) for e in graph.edges))


# -- resident-sweep layer schedule -------------------------------------------

@dataclass
class _DPSchedule:
    """The member-independent layer schedule of one graph topology, flattened
    for the resident device sweep: per popcount layer, the connected subsets
    (``layer_cols``) and the flat (submask A, complement B) candidate pairs
    in the reference enumeration order — column-major over the layer's
    connected subsets, relative submasks ascending within a column
    (``pair_seg`` is the pair's column position; sentinel values mark
    padding) — and ``col_ptr``, each column's run ``[col_ptr[l, c],
    col_ptr[l, c + 1])`` of pairs, which is what the sweep reads in place
    of ``pair_seg`` (so ``pair_seg`` stays on the host).  Extents are padded to the reference's power-of-two buckets, and
    ``nbytes`` counts the four arrays the reference counts (not ``col_ptr``),
    so both packages make the same budget decisions."""

    n: int
    pair_a: np.ndarray          # (L, P) int32, sentinel-padded with 0
    pair_b: np.ndarray          # (L, P) int32
    pair_seg: np.ndarray        # (L, P) int32, sentinel == C (padded extent)
    layer_cols: np.ndarray      # (L, C) int32, sentinel == 2**n
    col_ptr: np.ndarray         # (L, C + 1) int32, CSR over pair_seg
    n_pairs: int
    nbytes: int
    dev: "dict | None" = None   # device copies of the index arrays the
                                # sweep reads, per device (uploaded once
                                # per topology, not once per sweep)

    def device_arrays(self, device) -> tuple:
        """``(pair_a, pair_b, layer_cols, col_ptr)`` on ``device``: the
        schedule arguments of ``kernels.dp_layer.dp_sweep``."""
        import torch

        key = str(torch.device(device))
        if self.dev is None:
            self.dev = {}
        arrs = self.dev.get(key)
        if arrs is None:
            arrs = tuple(torch.from_numpy(x).to(device) for x in (
                self.pair_a, self.pair_b, self.layer_cols, self.col_ptr))
            self.dev[key] = arrs
        return arrs


def _column_major(pair_a: np.ndarray, pair_b: np.ndarray,
                  pair_seg: np.ndarray, C: int
                  ) -> "tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]":
    """Sort each layer's pairs by column, stably, and build the per-layer
    column CSR ``col_ptr (L, C + 1)``.  A layer enumerated in row chunks
    comes out chunk-major; the stable sort keeps each column's pairs in
    ascending enumeration order, and the sentinel ``C`` of the padding sorts
    last, so the first strict minimum per column is unchanged."""
    pa, pb, ps = pair_a.copy(), pair_b.copy(), pair_seg.copy()
    L = ps.shape[0]
    col_ptr = np.zeros((L, C + 1), np.int32)
    cut = np.arange(C + 1)
    for li in range(L):
        if np.any(ps[li, 1:] < ps[li, :-1]):
            order = np.argsort(ps[li], kind="stable")
            pa[li], pb[li], ps[li] = pa[li, order], pb[li, order], ps[li, order]
        col_ptr[li] = np.searchsorted(ps[li], cut, side="left")
    return pa, pb, ps, col_ptr


def from_reference_schedule(ref) -> _DPSchedule:
    """The port's schedule from a reference ``_DPSchedule``'s numpy arrays
    (same extents and ``nbytes``; pairs sorted column-major, plus
    ``col_ptr``)."""
    C = ref.layer_cols.shape[1]
    pa, pb, ps, col_ptr = _column_major(
        np.asarray(ref.pair_a, np.int32), np.asarray(ref.pair_b, np.int32),
        np.asarray(ref.pair_seg, np.int32), C)
    return _DPSchedule(int(ref.n), pa, pb, ps,
                       np.array(ref.layer_cols, np.int32), col_ptr,
                       int(ref.n_pairs), int(ref.nbytes))


_SCHEDULE_CACHE: "OrderedDict[tuple, _DPSchedule | None]" = OrderedDict()
_SCHEDULE_CACHE_MAX_ENTRIES = 32
_SCHEDULE_CACHE_MAX_BYTES = 256 * 1024 * 1024


def _pow2_bucket(v: int, lo: int = 8) -> int:
    p = lo
    while p < v:
        p *= 2
    return p


def _dp_schedule(graph: StarGraph, budget: int, B: int) -> "_DPSchedule | None":
    """Build (or fetch) the flat layer schedule for ``graph``'s topology.

    Returns ``None`` when the resident program would not fit the tile-memory
    budget for this member count — the caller falls back to the tiled
    per-layer path.  The eligibility bound is computed from connectivity
    alone (``n_cols * (2^s - 2)`` pairs per layer) *before* the O(pairs)
    enumeration, so an oversized clique never pays the build either."""
    n = len(graph.stars)
    if n > _RESIDENT_MAX_STARS:
        return None
    key = star_graph_topology(graph)
    sched = _SCHEDULE_CACHE.get(key)
    if sched is not None:
        DP_SWEEP_COUNTERS["schedule_hits"] += 1
        _SCHEDULE_CACHE.move_to_end(key)
        return sched

    size = 1 << n
    masks = np.arange(size, dtype=np.int64)
    pop = np.zeros(size, np.int64)
    for i in range(n):
        pop += (masks >> i) & 1
    adj = np.zeros(n, np.int64)
    for e in graph.edges:
        adj[e.src] |= np.int64(1) << e.dst
        adj[e.dst] |= np.int64(1) << e.src
    conn = np.zeros(size, bool)
    for i in range(n):
        conn[1 << i] = True

    layer_cols_raw: list[np.ndarray] = []
    for s in range(2, n + 1):
        S_all = masks[pop == s]
        conn_s = np.zeros(len(S_all), bool)
        for i in range(n):
            bit = np.int64(1) << i
            has = (S_all & bit) != 0
            Si = S_all[has]
            conn_s[has] |= conn[Si ^ bit] & ((adj[i] & Si) != 0)
        conn[S_all] = conn_s
        layer_cols_raw.append(S_all[conn_s])

    # budget gate from connectivity alone (upper bound: every submask pair
    # of every connected subset survives).  An oversized topology is NOT
    # cached — eligibility depends on the caller's member count and budget,
    # and a smaller batch may still fit later.
    p_bound = max((len(c) * ((1 << (s + 2)) - 2)
                   for s, c in enumerate(layer_cols_raw)), default=0)
    if _pow2_bucket(p_bound) * B * _RESIDENT_PAIR_BYTES > budget:
        return None
    else:
        DP_SWEEP_COUNTERS["schedule_builds"] += 1
        flat_per_layer: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        p_max = c_max = n_pairs = 0
        row_chunk = max(1, (budget // 32) // max(1, max(
            (len(c) for c in layer_cols_raw), default=1)))
        for s_i, cols in enumerate(layer_cols_raw):
            s = s_i + 2
            if len(cols) == 0:
                flat_per_layer.append((np.empty(0, np.int64),) * 3)
                continue
            idx = np.nonzero(((cols[:, None] >> np.arange(n, dtype=np.int64))
                              & 1) == 1)[1].reshape(len(cols), s)
            pw = np.int64(1) << idx
            rel = _rel_submasks(s)
            fa, fb, fs = [], [], []
            for r0 in range(0, len(rel), row_chunk):
                relb = rel[r0:r0 + row_chunk]
                A = np.zeros((len(relb), len(cols)), np.int64)
                for j in range(s):
                    A += ((relb >> j) & 1)[:, None] * pw[:, j][None, :]
                Bm = cols[None, :] ^ A
                valid = conn[A] & conn[Bm]
                ci, ri = np.nonzero(valid.T)   # col-major: rows asc per col
                fa.append(A[ri, ci])
                fb.append(Bm[ri, ci])
                fs.append(ci)
            a = np.concatenate(fa)
            flat_per_layer.append((a, np.concatenate(fb), np.concatenate(fs)))
            n_pairs += len(a)
            p_max = max(p_max, len(a))
            c_max = max(c_max, len(cols))

        L = n - 1
        P = _pow2_bucket(p_max)
        C = _pow2_bucket(c_max)
        pair_a = np.zeros((L, P), np.int32)
        pair_b = np.zeros((L, P), np.int32)
        pair_seg = np.full((L, P), C, np.int32)        # sentinel == C
        layer_cols = np.full((L, C), size, np.int32)   # sentinel == size
        for li, ((a, b, seg), cols) in enumerate(
                zip(flat_per_layer, layer_cols_raw)):
            pair_a[li, :len(a)] = a
            pair_b[li, :len(a)] = b
            pair_seg[li, :len(a)] = seg
            layer_cols[li, :len(cols)] = cols
        nbytes = (pair_a.nbytes + pair_b.nbytes + pair_seg.nbytes
                  + layer_cols.nbytes)
        pair_a, pair_b, pair_seg, col_ptr = _column_major(
            pair_a, pair_b, pair_seg, C)
        sched = _DPSchedule(n, pair_a, pair_b, pair_seg, layer_cols,
                            col_ptr, n_pairs, nbytes)

    _SCHEDULE_CACHE[key] = sched
    total = sum(s.nbytes for s in _SCHEDULE_CACHE.values())
    while _SCHEDULE_CACHE and (
            len(_SCHEDULE_CACHE) > _SCHEDULE_CACHE_MAX_ENTRIES
            or total > _SCHEDULE_CACHE_MAX_BYTES):
        _, old = _SCHEDULE_CACHE.popitem(last=False)
        total -= old.nbytes
    return sched


def _resident_fits(sched: "_DPSchedule | None", B: int, budget: int) -> bool:
    """Device-memory eligibility of the resident program: the scan step's
    live (B, P) pricing state, the (B, 2^n) resident DP state (6 float64
    planes plus the int32 winner planes) and the schedule itself must fit
    the layer-tile budget."""
    if sched is None:
        return False
    size = 1 << sched.n
    state = B * size * 8 * 6 + B * size * 4 * 2
    step = B * sched.pair_a.shape[1] * _RESIDENT_PAIR_BYTES
    return state + step + sched.nbytes <= budget


def _subset_cardinalities_b(graph: StarGraph, star_card: np.ndarray,
                            edge_sel: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Member-batched ``_subset_cardinalities``: ``star_card``/``edge_sel``
    are ``(B, n)`` / ``(B, n_edges)``; returns ``card`` of shape
    ``(B, len(masks))``.  The fold order (member-ascending, then
    edge-ascending with first-edge-wins dedupe) matches the single-member
    form element for element, so row ``b`` is bit-identical to
    ``_subset_cardinalities(graph, star_card[b], edge_sel[b], masks)``."""
    n = len(graph.stars)
    card = np.ones((star_card.shape[0], len(masks)))
    for i in range(n):
        member = ((masks >> i) & 1) == 1
        card[:, member] *= star_card[:, i:i + 1]
    seen: set[tuple[int, int, int | None]] = set()
    for k, e in enumerate(graph.edges):
        key = (min(e.src, e.dst), max(e.src, e.dst), e.pred)
        if key in seen:
            continue
        seen.add(key)
        em = (1 << e.src) | (1 << e.dst)
        inside = (masks & em) == em
        card[:, inside] *= edge_sel[:, k:k + 1]
    return card


def dp_join_order(
    graph: StarGraph,
    stats: FederatedStats,
    sel: SourceSelection,
    cost_model: CostModel | None = None,
    distinct: bool = True,
    block_bytes: int | None = None,
    dp_backend: str = "torch",
    device: str = DEFAULT_DEVICE,
) -> JoinTree:
    """Exact DP over connected star subsets, vectorized over bitmasks.

    Candidate plans per subset (same space as ``dp_join_order_ref``):
      * exclusive-group leaf — every star served by the same single source:
        the merged subquery runs remotely, only results ship (§3.4 subquery
        optimization, folded into the DP);
      * hash join of two subplans (both results at the engine);
      * bind join of a subplan with a leaf-able right side (bindings shipped
        out, matches shipped back — replaces the right leaf's transfer).

    Subsets are integer bitmasks.  Per-subset cardinalities are precomputed
    once; subset connectivity is filled in layer by layer (a set is connected
    iff dropping some member with a neighbor inside keeps it connected).  A
    popcount layer enumerates only its *connected* subsets, and for each the
    (submask A, complement B) partitions in the reference order — popcount
    ascending, combination-lex within a popcount.  Partitions are generated
    in tiles of at most ``block_bytes / _PAIR_BYTES`` candidates (peak tile
    memory is bounded no matter the star count), filtered to connected A and
    connected B (a cut of a connected subset always has a crossing edge, so the
    explicit cross-edge test is implied), and only the surviving csg/cmp
    pairs are costed.  Per-tile segmented first-minimum plus strictly-less
    running updates across tiles reproduce the reference's first-strict-
    minimum tie-breaking exactly, so both DPs return the same plan.

    Implemented as the single-member case of ``_dp_sweep`` — the same sweep
    ``dp_join_order_batch`` runs over a whole shape group at once.
    ``dp_backend='torch'`` (the default) runs the whole sweep with the state
    resident on ``device`` (``repro_torch.kernels.dp_layer.dp_sweep``) when
    the topology's layer schedule fits the tile budget, and prices per-layer
    tiles through ``repro_torch.kernels.dp_layer.dp_layer`` otherwise;
    ``dp_backend='numpy'`` runs the host sweep.  Plans are bit-identical
    across backends and devices."""
    cm = cost_model or CostModel()
    star_card, edge_sel = _star_edge_statistics(graph, stats, sel, distinct)
    return _dp_sweep(graph, [sel], [star_card], [edge_sel], cm, block_bytes,
                     dp_backend, device)[0]


def dp_join_order_batch(
    graphs: "list[StarGraph]",
    stats: FederatedStats,
    sels: "list[SourceSelection]",
    cost_model: CostModel | None = None,
    distinct: bool = True,
    block_bytes: int | None = None,
    dp_backend: str = "torch",
    device: str = DEFAULT_DEVICE,
) -> "list[JoinTree]":
    """One DP sweep over a *shape group*: queries whose star graphs share
    ``star_graph_topology`` (star count + ordered edge list).  The layer
    structure — connected-subset enumeration, (A, B) partition tiles, the
    connectivity filter, the segmented reduction layout — is computed once
    for the whole group; only the numeric state (cardinalities, costs,
    source counts/weights) carries a member axis, costed blockwise through
    the broadcasting ``CostModel.*_v`` forms.  Per member the candidate
    order, the float operations and the first-strict-minimum tie-breaking
    are element-for-element those of ``dp_join_order``, so each returned
    tree is bit-identical to planning that member alone.

    Tile sizing divides the ``block_bytes`` budget by the member count
    (down to the ``MIN_TILE_ELEMS`` floor — past it, the member axis is
    split across sweeps instead), so a group sweep obeys the same
    peak-memory bound as a single query.  ``dp_backend='torch'`` (the
    default) runs the candidate pricing + reduction on ``device`` through
    ``repro_torch.kernels.dp_layer`` with bit-identical plans."""
    if not graphs:
        return []
    if len(graphs) != len(sels):
        raise ValueError("one SourceSelection per graph")
    topo = star_graph_topology(graphs[0])
    for g in graphs[1:]:
        if star_graph_topology(g) != topo:
            raise ValueError("dp_join_order_batch needs topology-identical "
                             "graphs (group by star_graph_topology first)")
    cm = cost_model or CostModel()
    star_cards: list[list[float]] = []
    edge_sels: list[list[float]] = []
    for g, sel in zip(graphs, sels):
        sc, es = _star_edge_statistics(g, stats, sel, distinct)
        star_cards.append(sc)
        edge_sels.append(es)
    return _dp_sweep(graphs[0], sels, star_cards, edge_sels, cm, block_bytes,
                     dp_backend, device)


def _dp_sweep(
    graph: StarGraph,
    sels: "list[SourceSelection]",
    star_cards: "list[list[float]]",
    edge_sels: "list[list[float]]",
    cm: CostModel,
    block_bytes: int | None = None,
    dp_backend: str = "torch",
    device: str = DEFAULT_DEVICE,
) -> "list[JoinTree]":
    """The csg/cmp sweep over ``B = len(sels)`` members sharing one graph
    topology.  Mask enumeration, connectivity and tile layout are
    member-independent; every numeric array carries a leading member axis.
    ``dp_backend`` selects the sweep engine: ``'numpy'`` runs the in-process
    tiled layer loop; ``'torch'`` runs the whole sweep with the DP state on
    ``device`` when the topology's layer schedule fits the budget
    (``_resident_sweep``) and falls back to pricing the layer tiles through
    ``repro_torch.kernels.dp_layer.dp_layer`` on ``device`` when it doesn't.
    All paths produce bit-identical plans."""
    if dp_backend not in DP_BACKENDS:
        raise ValueError(f"unknown dp_backend {dp_backend!r} "
                         f"(expected one of {DP_BACKENDS})")
    n = len(graph.stars)
    B = len(sels)
    if n == 1:
        out = []
        for sel, sc in zip(sels, star_cards):
            ss = frozenset([0])
            out.append(JoinTree("leaf", ss, sc[0],
                                cm.leaf_cost(sc[0], sel.star_sources[0]),
                                sources=list(sel.star_sources[0])))
        return out

    # the tile budget covers the whole member-stacked candidate state, so a
    # B-member sweep divides the per-tile pair count by B — but never below
    # the MIN_TILE_ELEMS floor: a group too wide for its budget is split
    # along the member axis (per-member plans are identical either way)
    budget = int(block_bytes or DP_BLOCK_BYTES)
    tile_elems = budget // (_PAIR_BYTES * B)
    if tile_elems < MIN_TILE_ELEMS and B > 1:
        b_max = max(1, budget // (_PAIR_BYTES * MIN_TILE_ELEMS))
        out = []
        for i in range(0, B, b_max):
            out.extend(_dp_sweep(graph, sels[i:i + b_max],
                                 star_cards[i:i + b_max],
                                 edge_sels[i:i + b_max], cm, block_bytes,
                                 dp_backend, device))
        return out
    tile_elems = max(tile_elems, MIN_TILE_ELEMS)

    size = 1 << n
    masks = np.arange(size, dtype=np.int64)
    sc_b = np.asarray(star_cards, dtype=np.float64)        # (B, n)
    es_b = (np.asarray(edge_sels, dtype=np.float64)
            if graph.edges else np.zeros((B, 0)))
    card = _subset_cardinalities_b(graph, sc_b, es_b, masks)

    # star neighborhoods (all edges, including generic/duplicate ones)
    adj = np.zeros(n, np.int64)
    for e in graph.edges:
        adj[e.src] |= np.int64(1) << e.dst
        adj[e.dst] |= np.int64(1) << e.src

    # exclusive groups: stars pinned to exactly one source (per member)
    single_src = np.full((B, n), -1, np.int64)
    single_mask = np.zeros(B, np.int64)
    for b, sel in enumerate(sels):
        for i, srcs in enumerate(sel.star_sources):
            if len(srcs) == 1:
                single_src[b, i] = srcs[0]
                single_mask[b] |= np.int64(1) << i

    # per-(member, mask) best-plan state (cost == inf encodes "no plan")
    INF = np.inf
    cost = np.full((B, size), INF)
    conn = np.zeros(size, bool)                  # member-independent
    bindable = np.zeros((B, size), bool)         # leaf with >=1 source
    n_src = np.zeros((B, size), np.int64)
    src_w = np.ones((B, size))
    STRAT_SINGLE, STRAT_EXCL, STRAT_HASH, STRAT_BIND = (
        _STRAT_SINGLE, _STRAT_EXCL, _STRAT_HASH, _STRAT_BIND)
    strat = np.zeros((B, size), np.int8)
    split = np.zeros((B, size), np.int64)
    excl_of = np.full((B, size), -1, np.int64)

    for i in range(n):
        m = 1 << i
        conn[m] = True
        for b, sel in enumerate(sels):
            srcs = sel.star_sources[i]
            cost[b, m] = cm.leaf_cost(star_cards[b][i], srcs)
            bindable[b, m] = len(srcs) > 0
            n_src[b, m] = len(srcs)
            src_w[b, m] = cm.src_w(srcs)
            strat[b, m] = STRAT_SINGLE

    any_single = bool(single_mask.any())
    # per-source weight lookup for the exclusive-group seed: one interpreted
    # cm.src_w call per source id instead of one per (member, column) tile
    # cell (index -1, "no single source", resolves to the appended 1.0 —
    # cm.src_w([-1]) for an id absent from source_weight)
    w_lut = None
    if cm.source_weight:
        hi = int(single_src.max()) + 1 if single_src.size else 0
        w_lut = np.array([cm.src_w([s]) for s in range(hi)] + [1.0])

    # torch backend: run the whole sweep with the DP state resident on the
    # device when the topology's layer schedule fits the budget — only the
    # seed state goes up (the index schedule is uploaded once per topology)
    # and the final plan state comes down, one host<->device round trip for
    # the whole sweep.  Oversized schedules fall back to the tiled per-layer
    # kernel path.
    resident = False
    if dp_backend == "torch":
        sched = _dp_schedule(graph, budget, B)
        if _resident_fits(sched, B, budget):
            _resident_sweep(sched, cm, card, cost, bindable, n_src, src_w,
                            strat, split, excl_of, single_mask, single_src,
                            w_lut, device)
            resident = True
            DP_SWEEP_COUNTERS["resident"] += 1
        else:
            DP_SWEEP_COUNTERS["tiled"] += 1
    if not resident:
        _tiled_layer_sweep(cm, dp_backend, n, B, tile_elems, masks, adj,
                           conn, card, cost, bindable, n_src, src_w,
                           strat, split, excl_of, single_mask,
                           single_src, any_single, w_lut, device)

    def build(b: int, m: int) -> JoinTree:
        ss = frozenset(i for i in range(n) if (m >> i) & 1)
        st = int(strat[b, m])
        if st == STRAT_SINGLE:
            i = next(iter(ss))
            return JoinTree("leaf", ss, star_cards[b][i], float(cost[b, m]),
                            sources=list(sels[b].star_sources[i]))
        if st == STRAT_EXCL:
            return JoinTree("leaf", ss, float(card[b, m]), float(cost[b, m]),
                            sources=[int(excl_of[b, m])])
        am = int(split[b, m])
        return JoinTree("join", ss, float(card[b, m]), float(cost[b, m]),
                        build(b, am), build(b, m ^ am),
                        "hash" if st == STRAT_HASH else "bind")

    full = size - 1
    comps = None
    out: list[JoinTree] = []
    for b in range(B):
        if np.isfinite(cost[b, full]):
            out.append(build(b, full))
            continue
        # disconnected query: cartesian-combine components by ascending
        # cardinality (component masks are member-independent)
        if comps is None:
            comps = _components(graph)
        trees = sorted((build(b, sum(1 << i for i in c)) for c in comps),
                       key=lambda t: t.cardinality)
        tree = trees[0]
        for t in trees[1:]:
            cardx = tree.cardinality * t.cardinality
            tree = JoinTree("join", tree.stars | t.stars, cardx,
                            tree.cost + t.cost + cm.intermediate_weight * cardx,
                            tree, t, "hash", None)
        out.append(tree)
    return out


def _tiled_layer_sweep(cm: CostModel, dp_backend: str, n: int, B: int,
                       tile_elems: int, masks: np.ndarray, adj: np.ndarray,
                       conn: np.ndarray, card: np.ndarray, cost: np.ndarray,
                       bindable: np.ndarray, n_src: np.ndarray,
                       src_w: np.ndarray, strat: np.ndarray,
                       split: np.ndarray, excl_of: np.ndarray,
                       single_mask: np.ndarray, single_src: np.ndarray,
                       any_single: bool, w_lut: "np.ndarray | None",
                       device: str = DEFAULT_DEVICE) -> None:
    """The tiled csg/cmp layer loop over the mutable per-(member, mask) DP
    state — the in-process fallback shared by the numpy backend and by torch
    sweeps whose layer schedule exceeds the resident sweep's budget (those
    price each dense tile on ``device``).  Mutates ``conn``/``cost``/
    ``bindable``/``n_src``/``src_w``/``strat``/``split``/``excl_of`` in
    place."""
    INF = np.inf
    STRAT_EXCL, STRAT_HASH, STRAT_BIND = (_STRAT_EXCL, _STRAT_HASH,
                                          _STRAT_BIND)
    size = 1 << n
    # small-star fast path: dense per-layer structures cached across calls,
    # taken whenever the whole dense layer set (< 3^n pairs) fits the budget
    skel = (_layer_skeletons(n)
            if n <= _SKEL_CACHE_MAX_N and tile_elems >= 3 ** n else None)
    if skel is None:
        pop = np.zeros(size, np.int64)
        for i in range(n):
            pop += (masks >> i) & 1

    for s in range(2, n + 1):
        # layer connectivity: S is connected iff some member i has a neighbor
        # in S and S \ {i} is connected (spanning-tree leaf argument)
        if skel is not None:
            S_all, idx_all, pow2_all, A_all, B_all = skel[s - 2]
            S_col = S_all[:, None]
            conn_s = (conn[S_col ^ pow2_all]
                      & ((adj[idx_all] & S_col) != 0)).any(axis=1)
        else:
            S_all = masks[pop == s]
            conn_s = np.zeros(len(S_all), bool)
            for i in range(n):
                bit = np.int64(1) << i
                has = (S_all & bit) != 0
                Si = S_all[has]
                conn_s[has] |= conn[Si ^ bit] & ((adj[i] & Si) != 0)
        conn[S_all] = conn_s
        cols = S_all[conn_s]
        n_cols = len(cols)
        if n_cols == 0:
            continue

        card_S = card[:, cols]
        hj = cm.hash_join_cost_v(card_S)

        # running per-(member, subset) best across tiles; strat 0 == no
        # candidate yet.  Seeded below with the exclusive-group leaf
        # (candidate index 0 in the reference order), which pair candidates
        # must beat strictly.
        run_cost = np.full((B, n_cols), INF)
        run_split = np.zeros((B, n_cols), np.int64)
        run_strat = np.zeros((B, n_cols), np.int8)
        excl_w = np.ones((B, n_cols))
        excl_src = np.full((B, n_cols), -1, np.int64)

        rel = _rel_submasks(s)
        n_rows = len(rel)
        if skel is not None:
            row_block, col_block = n_rows, n_cols          # one dense tile
            colidx = np.flatnonzero(conn_s)
        else:
            row_block = max(1, min(n_rows, tile_elems))
            col_block = max(1, tile_elems // max(row_block, n))

        for c0 in range(0, n_cols, col_block):
            c1 = min(c0 + col_block, n_cols)
            Sb = cols[c0:c1]
            if skel is not None:
                all_conn = n_cols == len(S_all)
                sub = None if all_conn else colidx[c0:c1]
                idx_b = idx_all if all_conn else idx_all[sub]
            else:
                bitm = ((Sb[:, None] >> np.arange(n, dtype=np.int64)) & 1) == 1
                idx_b = np.nonzero(bitm)[1].reshape(len(Sb), s).astype(np.int64)
                pow2_b = np.int64(1) << idx_b

            if any_single:
                in_single = (Sb[None, :] & ~single_mask[:, None]) == 0
                if in_single.any():
                    srcs_mat = single_src[:, idx_b]        # (B, nb, s)
                    excl_ok = in_single & (srcs_mat == srcs_mat[:, :, :1]).all(axis=2)
                    excl_src[:, c0:c1] = srcs_mat[:, :, 0]
                    if excl_ok.any():
                        w = excl_w[:, c0:c1]
                        if w_lut is not None:
                            w = w_lut[srcs_mat[:, :, 0]]
                            excl_w[:, c0:c1] = w
                        run_cost[:, c0:c1] = np.where(
                            excl_ok, cm.leaf_cost_v(card_S[:, c0:c1], 1, w), INF)
                        run_strat[:, c0:c1] = np.where(excl_ok, STRAT_EXCL,
                                                       0).astype(np.int8)

            for r0 in range(0, n_rows, row_block):
                if skel is not None:
                    A = A_all if all_conn else A_all[:, sub]
                    Bm = B_all if all_conn else B_all[:, sub]
                else:
                    relb = rel[r0:r0 + row_block]
                    # deposit the relative submasks into each column's bit
                    # positions: A[r, c] has relb[r]'s bits at Sb[c]'s members
                    A = np.zeros((len(relb), len(Sb)), np.int64)
                    for j in range(s):
                        A += ((relb >> j) & 1)[:, None] * pow2_b[:, j][None, :]
                    Bm = Sb[None, :] ^ A
                valid = conn[A] & conn[Bm]
                if not valid.any():
                    continue
                if dp_backend == "torch":
                    _layer_tile_torch(cm, cost, card, n_src, src_w, bindable,
                                      A, Bm, valid, card_S, c0, c1,
                                      run_cost, run_split, run_strat, device)
                    continue
                ci, ri = np.nonzero(valid.T)   # col-major: rows asc per col
                Af = A[ri, ci]
                Bf = Bm[ri, ci]
                del A, Bm, valid, ri           # dense tile state: off-peak
                                               # before the per-pair gathers
                gci = c0 + ci
                pair_c, is_bind = cm.join_candidates_v(
                    cost[:, Af], cost[:, Bf], card_S[:, gci], hj[:, gci],
                    card[:, Af], n_src[:, Bf], src_w[:, Bf], bindable[:, Bf])
                # ci is sorted; segment = run of equal column indices
                change = np.empty(len(ci), bool)
                change[0] = True
                np.not_equal(ci[1:], ci[:-1], out=change[1:])
                seg_starts = np.flatnonzero(change)
                seg_cols = ci[seg_starts]
                seg_min = np.minimum.reduceat(pair_c, seg_starts, axis=1)
                seg_of = np.cumsum(change) - 1
                # first candidate attaining the segment minimum == the
                # reference's first-strict-minimum tie-breaking
                flat = np.where(pair_c == seg_min[:, seg_of],
                                np.arange(len(ci))[None, :], len(ci))
                first = np.minimum.reduceat(flat, seg_starts, axis=1)
                g = c0 + seg_cols
                upd = seg_min < run_cost[:, g]
                if upd.any():
                    bu, su = np.nonzero(upd)
                    gu = g[su]
                    fu = first[bu, su]
                    run_cost[bu, gu] = seg_min[bu, su]
                    run_split[bu, gu] = Af[fu]
                    run_strat[bu, gu] = np.where(is_bind[bu, fu],
                                                 STRAT_BIND, STRAT_HASH)

        ok = run_strat != 0
        if not ok.any():
            continue
        bo, ko = np.nonzero(ok)
        S_ok = cols[ko]
        st_ok = run_strat[bo, ko]
        is_excl = st_ok == STRAT_EXCL
        cost[bo, S_ok] = run_cost[bo, ko]
        strat[bo, S_ok] = st_ok
        split[bo, S_ok] = np.where(is_excl, 0, run_split[bo, ko])
        bindable[bo, S_ok] = is_excl
        n_src[bo, S_ok] = np.where(is_excl, 1, 0)
        src_w[bo, S_ok] = np.where(is_excl, excl_w[bo, ko], 1.0)
        excl_of[bo, S_ok] = np.where(is_excl, excl_src[bo, ko], -1)


def _resident_sweep(sched: _DPSchedule, cm: CostModel, card: np.ndarray,
                    cost: np.ndarray, bindable: np.ndarray,
                    n_src: np.ndarray, src_w: np.ndarray, strat: np.ndarray,
                    split: np.ndarray, excl_of: np.ndarray,
                    single_mask: np.ndarray, single_src: np.ndarray,
                    w_lut: "np.ndarray | None",
                    device: str = DEFAULT_DEVICE) -> None:
    """Host glue for the device-resident sweep: precompute the exclusive-
    group leaf seeds over *every* mask (the device kernel cannot interpret
    source sets), ship the seeds through ``dp_sweep`` with the topology's
    index schedule (uploaded to ``device`` once per topology) in one round
    trip, and merge the returned winner planes back into the mutable DP
    state.  The seed math is the tiled path's element for element — same
    ``leaf_cost_v`` inputs, same ``w_lut`` lookups — so plans stay
    bit-identical across paths."""
    import torch

    from repro_torch.kernels.dp_layer import as_numpy, dp_sweep

    B, size = cost.shape
    n = sched.n

    excl_cost = np.full((B, size), np.inf)
    excl_w = np.ones((B, size))
    excl_src_all = np.full((B, size), -1, np.int64)
    union = int(np.bitwise_or.reduce(single_mask)) if B else 0
    if union:
        # only subsets of some member's single mask can host a group leaf
        # (every member pinned to exactly one source), so the seed math runs
        # over that — usually tiny — candidate set, not all 2^n masks.
        # ref_src is the lowest member's source, the tiled path's
        # ``srcs_mat[:, :, 0]``; the group leaf exists iff every member
        # star shares it
        masks = np.arange(size, dtype=np.int64)
        cand = masks[(masks & ~np.int64(union)) == 0]
        ref_src = np.full((B, len(cand)), -1, np.int64)
        same = np.ones((B, len(cand)), bool)
        npop = np.zeros(len(cand), np.int64)
        for i in range(n):
            if not (union >> i) & 1:
                continue
            has = ((cand >> i) & 1) == 1
            npop += has
            s_i = single_src[:, i:i + 1]
            mism = has[None, :] & (ref_src >= 0) & (ref_src != s_i)
            ref_src = np.where(has[None, :] & (ref_src < 0), s_i, ref_src)
            same &= ~mism
        in_single = (cand[None, :] & ~single_mask[:, None]) == 0
        ok = in_single & same & (npop[None, :] >= 2) & (ref_src >= 0)
        w = w_lut[ref_src] if w_lut is not None else 1.0
        if w_lut is not None:
            excl_w[:, cand] = np.where(ok, w, 1.0)
        excl_cost[:, cand] = np.where(ok, cm.leaf_cost_v(card[:, cand], 1, w),
                                      np.inf)
        excl_src_all[:, cand] = np.where(ok, ref_src, -1)

    params = (cm.intermediate_weight, cm.transfer_weight, cm.request_cost,
              cm.bind_batch)
    up = [torch.from_numpy(np.ascontiguousarray(x, np.float64)).to(device)
          for x in (card, excl_cost, excl_w, cost, n_src, src_w)]
    cost_d, strat_d, split_d = as_numpy(*dp_sweep(
        params, *sched.device_arrays(device), *up))

    # strat 0 == the device never wrote the mask (singletons, disconnected
    # or unreachable subsets): those keep their host-seeded state.  Only
    # the planes ``build()`` reads are merged — bindable/n_src/src_w are
    # dead once the sweep is over
    written = strat_d != 0
    np.copyto(cost, cost_d, where=written)
    np.copyto(strat, strat_d.astype(np.int8), where=written)
    np.copyto(split, split_d.astype(np.int64), where=written)
    is_excl = written & (strat_d == _STRAT_EXCL)
    np.copyto(excl_of, excl_src_all, where=is_excl)


def _layer_tile_torch(cm: CostModel, cost: np.ndarray, card: np.ndarray,
                      n_src: np.ndarray, src_w: np.ndarray,
                      bindable: np.ndarray, A: np.ndarray, Bm: np.ndarray,
                      valid: np.ndarray, card_S: np.ndarray, c0: int, c1: int,
                      run_cost: np.ndarray, run_split: np.ndarray,
                      run_strat: np.ndarray,
                      device: str = DEFAULT_DEVICE) -> None:
    """Price one dense ``(rows, cols)`` layer tile through the
    ``dp_layer`` kernel on ``device`` and fold the per-column winners into
    the running state.

    The kernel sees the same candidates as the numpy path — the dense
    ``(submask A, complement B)`` matrices with the connectivity mask, rows
    in the reference enumeration order — gathered on the host into
    ``(B, rows, cols)`` per-pair state (the per-subset hash-join cost is
    derived on the device from ``card_S``, the same single multiply as the
    host ``hash_join_cost_v`` form), and returns each column's first strict
    minimum.  The strictly-less fold against ``run_cost`` matches the numpy
    path's cross-tile merge, so backends tie-break identically."""
    import torch

    from repro_torch.kernels.dp_layer import as_numpy, dp_layer

    def up(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    f64 = np.float64
    best_c, best_r, best_b = as_numpy(*dp_layer(
        up(cost[:, A], f64), up(cost[:, Bm], f64), up(card[:, A], f64),
        up(n_src[:, Bm], f64), up(src_w[:, Bm], f64),
        up(bindable[:, Bm], np.int8), up(valid, np.int8),
        up(card_S[:, c0:c1], f64),
        (cm.intermediate_weight, cm.transfer_weight, cm.request_cost,
         cm.bind_batch)))
    upd = best_c < run_cost[:, c0:c1]
    if upd.any():
        bu, cu = np.nonzero(upd)
        gu = c0 + cu
        ru = best_r[bu, cu]
        run_cost[bu, gu] = best_c[bu, cu]
        run_split[bu, gu] = A[ru, cu]
        run_strat[bu, gu] = np.where(best_b[bu, cu], _STRAT_BIND,
                                     _STRAT_HASH).astype(np.int8)


# -- reference DP (oracle) ---------------------------------------------------

def dp_join_order_ref(
    graph: StarGraph,
    stats: FederatedStats,
    sel: SourceSelection,
    cost_model: CostModel | None = None,
    distinct: bool = True,
    use_cache: bool = False,
) -> JoinTree:
    """The original frozenset-subset DP (paper: "dynamic programming becomes
    affordable" because #stars << #triple patterns), with unmemoized
    statistics by default — the seed implementation, kept as the reference
    oracle and benchmark baseline for ``dp_join_order``.  Same plan space,
    same tie-breaking, identical statistics values."""
    cm = cost_model or CostModel()
    n = len(graph.stars)
    star_card, edge_sel = _star_edge_statistics(graph, stats, sel, distinct,
                                                use_cache=use_cache)

    def subset_card(ss: frozenset[int]) -> float:
        card = 1.0
        for i in sorted(ss):    # ascending, matching the bitmask path's fold
            card *= max(star_card[i], 0.0)
        counted: set[tuple[int, int, int | None]] = set()
        for k, e in enumerate(graph.edges):
            if e.src in ss and e.dst in ss:
                key = (min(e.src, e.dst), max(e.src, e.dst), e.pred)
                if key in counted:
                    continue
                counted.add(key)
                card *= edge_sel[k]
        return card

    def exclusive(ss: frozenset[int]) -> int | None:
        if not all(len(sel.star_sources[i]) == 1 for i in ss):
            return None
        srcs = {sel.star_sources[i][0] for i in ss}
        return next(iter(srcs)) if len(srcs) == 1 else None

    def is_connected(ss: frozenset[int]) -> bool:
        if len(ss) == 1:
            return True
        seen = {next(iter(ss))}
        frontier = list(seen)
        while frontier:
            cur = frontier.pop()
            for e in graph.edges:
                for a, b in ((e.src, e.dst), (e.dst, e.src)):
                    if a == cur and b in ss and b not in seen:
                        seen.add(b)
                        frontier.append(b)
        return seen == set(ss)

    best: dict[frozenset[int], JoinTree] = {}
    for i in range(n):
        ss = frozenset([i])
        card = star_card[i]
        best[ss] = JoinTree("leaf", ss, card, cm.leaf_cost(card, sel.star_sources[i]),
                            sources=list(sel.star_sources[i]))

    for size in range(2, n + 1):
        for combo in combinations(range(n), size):
            ss = frozenset(combo)
            cand: JoinTree | None = None
            card = subset_card(ss)
            # exclusive-group leaf candidate
            excl = exclusive(ss)
            if excl is not None and is_connected(ss):
                cand = JoinTree("leaf", ss, card, cm.leaf_cost(card, [excl]),
                                sources=[excl])
            for k in range(1, size):
                for sub in combinations(combo, k):
                    a = frozenset(sub)
                    b = ss - a
                    if a not in best or b not in best:
                        continue
                    if not graph.connected(a, b) and n > 1:
                        continue
                    ta, tb = best[a], best[b]
                    # hash join
                    cost = ta.cost + tb.cost + cm.hash_join_cost(card)
                    if cand is None or cost < cand.cost:
                        cand = JoinTree("join", ss, card, cost, ta, tb, "hash")
                    # bind join: right side must be dispatchable as one
                    # subquery (a leaf — single star or exclusive group)
                    if tb.kind == "leaf" and tb.sources:
                        bcost = ta.cost + cm.bind_join_cost(ta.cardinality, card, tb.sources)
                        if bcost < cand.cost:
                            cand = JoinTree("join", ss, card, bcost, ta, tb, "bind")
            if cand is not None:
                prev = best.get(ss)
                if prev is None or cand.cost < prev.cost:
                    best[ss] = cand

    full = frozenset(range(n))
    if full in best:
        return best[full]
    # disconnected query: cartesian-combine components by ascending cardinality
    comps = _components(graph)
    trees = sorted((best[frozenset(c)] for c in comps), key=lambda t: t.cardinality)
    tree = trees[0]
    for t in trees[1:]:
        card = tree.cardinality * t.cardinality
        tree = JoinTree("join", tree.stars | t.stars, card,
                        tree.cost + t.cost + cm.intermediate_weight * card,
                        tree, t, "hash", None)
    return tree


def _components(graph: StarGraph) -> list[set[int]]:
    n = len(graph.stars)
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in graph.edges:
        a, b = find(e.src), find(e.dst)
        if a != b:
            parent[a] = b
    comps: dict[int, set[int]] = {}
    for i in range(n):
        comps.setdefault(find(i), set()).add(i)
    return list(comps.values())
