"""Cardinality estimation — formulas (1)–(4) of the paper.

(1) exact DISTINCT star cardinality
(2) non-DISTINCT star estimate via per-predicate duplication factors
(3) exact DISTINCT linked-star cardinality over CPs
(4) non-DISTINCT linked-star estimate with per-CS duplication factors

Formulas (2)/(4) follow the paper's aggregation: occurrences are summed over
all *relevant* CSs before forming the ratios (that is how the running example
83,438 · (109,830/83,438) · (83,448/83,438) · (110,460/83,438) = 145,417 is
computed).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.characteristic_pairs import CPStats
from repro_torch.core.characteristic_sets import CSStats


def star_cardinality_distinct(cs: CSStats, preds: list[int], rel: np.ndarray | None = None) -> int:
    """Formula (1): cardinality(P) = Σ_{P ⊆ R} count(R)."""
    if rel is None:
        rel = cs.relevant_cs(preds)
    return int(cs.cs_count[rel].sum())


def star_cardinality_estimate(cs: CSStats, preds: list[int], rel: np.ndarray | None = None) -> float:
    """Formula (2): cardinality(P) · Π_p occ(p, P) / cardinality(P), with
    occ aggregated over the relevant CSs."""
    if rel is None:
        rel = cs.relevant_cs(preds)
    card = float(cs.cs_count[rel].sum())
    if card == 0:
        return 0.0
    est = card
    for p in preds:
        occ = float(sum(cs.occurrences(int(c), int(p)) for c in rel))
        est *= occ / card
    return est


def _dup_factor(cs: CSStats, c: int, preds: "list[int]") -> float:
    """Π_{p ∈ preds} occ(p, C)/count(C) — per-CS duplication factor."""
    cnt = float(cs.cs_count[c])
    if cnt == 0:
        return 0.0
    f = 1.0
    for p in preds:
        f *= cs.occurrences(int(c), int(p)) / cnt
    return f


def linked_star_cardinality_distinct(
    cp: CPStats,
    cs1: CSStats,
    cs2: CSStats,
    preds1: list[int],
    preds2: list[int],
    link_pred: int,
) -> int:
    """Formula (3): Σ_{S1 ⊆ T1 ∧ S2 ⊆ T2} count(T1, T2, p)."""
    rel1 = cs1.relevant_cs(preds1)
    rel2 = cs2.relevant_cs(preds2)
    rows = cp.select(link_pred, rel1, rel2)
    return int(cp.count[rows].sum())


def linked_star_cardinality_estimate(
    cp: CPStats,
    cs1: CSStats,
    cs2: CSStats,
    preds1: list[int],
    preds2: list[int],
    link_pred: int,
) -> float:
    """Formula (4): per relevant CP, scale count(T1,T2,p) by the duplication
    factors of T1 over S1−{p} and of T2 over S2 (p's selectivity is already in
    the CP count)."""
    rel1 = cs1.relevant_cs(preds1)
    rel2 = cs2.relevant_cs(preds2)
    rows = cp.select(link_pred, rel1, rel2)
    if len(rows) == 0:
        return 0.0
    p1 = [p for p in preds1 if p != link_pred]
    f1: dict[int, float] = {}
    f2: dict[int, float] = {}
    est = 0.0
    for r in rows:
        t1 = int(cp.cs1[r])
        t2 = int(cp.cs2[r])
        if t1 not in f1:
            f1[t1] = _dup_factor(cs1, t1, p1)
        if t2 not in f2:
            f2[t2] = _dup_factor(cs2, t2, preds2)
        est += float(cp.count[r]) * f1[t1] * f2[t2]
    return est


# --------------------------------------------------------------------------
# Memoized forms — the planner hot path re-evaluates the same (preds, CS
# restriction) combinations across subsets, queries and batches; results are
# cached on the statistics objects themselves (``CSStats._card_cache`` /
# ``CPStats._card_cache``) so the cache lives exactly as long as the stats.
# Long-lived serving processes see unbounded key diversity, so each cache is
# wiped once it reaches ``CARD_CACHE_MAX`` entries (cheap: entries are pure
# recomputation, and a wipe preserves the steady-state hit rate for
# templated workloads).
# --------------------------------------------------------------------------

CARD_CACHE_MAX = 1 << 16


def _rel_key(rel: np.ndarray | None) -> bytes | None:
    return None if rel is None else np.ascontiguousarray(rel).tobytes()


def _cache_put(cache: dict, key, value):
    if len(cache) >= CARD_CACHE_MAX:
        cache.clear()
    cache[key] = value
    return value


def star_cardinality_distinct_cached(cs: CSStats, preds: list[int],
                                     rel: np.ndarray | None = None) -> int:
    key = ("sd", tuple(int(p) for p in preds), _rel_key(rel))
    cache = cs._card_cache
    v = cache.get(key)
    if v is None:
        v = _cache_put(cache, key, star_cardinality_distinct(cs, preds, rel))
    return v


def star_cardinality_estimate_cached(cs: CSStats, preds: list[int],
                                     rel: np.ndarray | None = None) -> float:
    key = ("se", tuple(int(p) for p in preds), _rel_key(rel))
    cache = cs._card_cache
    v = cache.get(key)
    if v is None:
        v = _cache_put(cache, key, star_cardinality_estimate(cs, preds, rel))
    return v


def linked_star_cardinality_distinct_cached(
    cp: CPStats, cs1: CSStats, cs2: CSStats,
    preds1: list[int], preds2: list[int], link_pred: int,
) -> int:
    key = ("ld", tuple(int(p) for p in preds1), tuple(int(p) for p in preds2),
           int(link_pred))
    cache = cp._card_cache
    v = cache.get(key)
    if v is None:
        v = _cache_put(cache, key, linked_star_cardinality_distinct(cp, cs1, cs2, preds1, preds2, link_pred))
    return v


def linked_star_cardinality_estimate_cached(
    cp: CPStats, cs1: CSStats, cs2: CSStats,
    preds1: list[int], preds2: list[int], link_pred: int,
) -> float:
    key = ("le", tuple(int(p) for p in preds1), tuple(int(p) for p in preds2),
           int(link_pred))
    cache = cp._card_cache
    v = cache.get(key)
    if v is None:
        v = _cache_put(cache, key, linked_star_cardinality_estimate(cp, cs1, cs2, preds1, preds2, link_pred))
    return v


def clear_card_caches(stats) -> None:
    """Drop every memoized formula result (and predicate index) attached to
    a ``FederatedStats``' CS/CP objects.

    The statistics lifecycle rarely needs this: ``refresh_source`` replaces
    the affected CS/CP objects (per-source cache scoping for free) and
    ``remove_source`` invalidates nothing — surviving sources' caches are
    keyed only on their own unchanged arrays.  Prefer
    ``FederatedStats.invalidate_caches`` (which calls this *and* bumps the
    epoch so the plan cache follows); this is only the object-level part."""
    for cs in stats.cs:
        cs.invalidate_caches()
    for cp in stats.intra_cp:
        cp.invalidate_caches()
    for cp in stats.fed_cp.values():
        cp.invalidate_caches()


def join_selectivity(
    cp: CPStats,
    cs1: CSStats,
    cs2: CSStats,
    preds1: list[int],
    preds2: list[int],
    link_pred: int,
) -> float:
    """Selectivity of the link join: |S1 ⋈_p S2| / (|S1| · |S2|), from CPs.

    Used by the meta-node DP when composing more than two stars.
    """
    c1 = star_cardinality_distinct(cs1, preds1)
    c2 = star_cardinality_distinct(cs2, preds2)
    if c1 == 0 or c2 == 0:
        return 0.0
    links = linked_star_cardinality_distinct(cp, cs1, cs2, preds1, preds2, link_pred)
    return links / (c1 * c2)
