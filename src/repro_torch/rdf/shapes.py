"""Synthetic star-graph planning workloads (chains / trees / cliques).

Large-star planner tests and benchmarks need queries with a *controlled*
star-graph shape at sizes (14-20 meta-nodes) the FedBench-like workload
generator never produces.  Cases are built over a small random triple table:
every star ``i`` owns one ``(x_i, p, x_i_v)`` pattern, so decomposition
yields exactly one star per node in node order, and each shape edge
``(a, b)`` adds an object->subject link pattern ``(x_a, p, x_b)``.  Chains
and trees keep every prefix ``{x_0..x_k}`` connected (tree parents are
always earlier nodes), which the left-deep-bound property tests rely on.
"""
from __future__ import annotations

import numpy as np

from repro_torch.query.algebra import BGPQuery, Const, TriplePattern, Var
from repro_torch.rdf.dataset import TripleTable

SHAPES = ("chain", "tree", "clique")


def shape_edges(shape: str, n_stars: int, rng) -> list[tuple[int, int]]:
    if shape == "chain":
        return [(i, i + 1) for i in range(n_stars - 1)]
    if shape == "tree":
        return [(int(rng.integers(0, i)), i) for i in range(1, n_stars)]
    if shape == "clique":
        return [(a, b) for a in range(n_stars) for b in range(a + 1, n_stars)]
    raise ValueError(f"unknown star-graph shape {shape!r}")


def shaped_case(shape: str, n_stars: int, seed: int, n_preds: int = 6,
                n_rows: int = 400, distinct: bool = True):
    """``(TripleTable, BGPQuery)`` decomposing into exactly ``n_stars`` stars
    (star index == node index) linked in the requested shape."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 40, n_rows).astype(np.int32)
    p = rng.integers(0, n_preds, n_rows).astype(np.int32)
    # half the objects are entities (joinable), half literals
    o = np.where(rng.random(n_rows) < 0.5, rng.integers(0, 40, n_rows),
                 rng.integers(100, 140, n_rows)).astype(np.int32)
    table = TripleTable.from_triples(s, p, o)
    preds = table.predicates()

    def pred() -> Const:
        return Const(int(preds[rng.integers(len(preds))]))

    pats = [TriplePattern(Var(f"x{i}"), pred(), Var(f"x{i}_v"))
            for i in range(n_stars)]
    for a, b in shape_edges(shape, n_stars, rng):
        pats.append(TriplePattern(Var(f"x{a}"), pred(), Var(f"x{b}")))
    return table, BGPQuery(pats, distinct=distinct, name=f"{shape}{n_stars}")


def shaped_planning_inputs(shape: str, n_stars: int, seed: int, **kw):
    """``(graph, stats, sel, query)`` ready for ``dp_join_order``."""
    from repro_torch.core.characteristic_pairs import compute_characteristic_pairs
    from repro_torch.core.characteristic_sets import compute_characteristic_sets
    from repro_torch.core.decomposition import decompose
    from repro_torch.core.federation import FederatedStats
    from repro_torch.core.source_selection import select_sources

    table, q = shaped_case(shape, n_stars, seed, **kw)
    cs = compute_characteristic_sets(table)
    cp = compute_characteristic_pairs(table, cs, 0)
    stats = FederatedStats(cs=[cs], intra_cp=[cp])
    graph = decompose(q)
    sel = select_sources(graph, stats)
    return graph, stats, sel, q
