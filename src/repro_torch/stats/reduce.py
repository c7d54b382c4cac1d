"""CS reduction (paper §3.3): bound the number of CSs to ``max_cs``.

Keep the CSs shared by the most entities; merge each dropped CS into its
*smallest kept superset* (combining counts and occurrences). Merging into a
superset is conservative for relevance detection: a query with P ⊆ dropped
also satisfies P ⊆ superset, so source selection keeps its no-false-negative
guarantee (property-tested). CSs with no kept superset are retained — dropping
them could lose completeness, which the paper never allows.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.characteristic_sets import CSStats


def reduce_cs(cs: CSStats, max_cs: int) -> CSStats:
    if cs.n_cs <= max_cs:
        return cs
    order = np.argsort(-cs.cs_count, kind="stable")
    keep_set = set(order[:max_cs].tolist())
    drop = [c for c in order[max_cs:].tolist()]

    pred_sets = [frozenset(cs.preds_of(c).tolist()) for c in range(cs.n_cs)]
    # map dropped -> smallest kept superset (or keep if none)
    merged_into: dict[int, int] = {}
    for c in drop:
        best = -1
        best_size = None
        for k in keep_set:
            if pred_sets[c] <= pred_sets[k]:
                sz = len(pred_sets[k])
                if best_size is None or sz < best_size:
                    best, best_size = k, sz
        if best >= 0:
            merged_into[c] = best
        else:
            keep_set.add(c)  # cannot merge without losing completeness

    keep = sorted(keep_set)
    remap = {c: i for i, c in enumerate(keep)}

    n_new = len(keep)
    cs_count = np.zeros(n_new, np.int64)
    occ_maps: list[dict[int, int]] = [dict() for _ in range(n_new)]
    for c in range(cs.n_cs):
        tgt = remap[merged_into.get(c, c)]
        cs_count[tgt] += cs.cs_count[c]
        preds = cs.preds_of(c)
        occs = cs.occ_of(c)
        m = occ_maps[tgt]
        for p, oc in zip(preds.tolist(), occs.tolist()):
            m[p] = m.get(p, 0) + oc

    indptr = np.zeros(n_new + 1, np.int64)
    pred_chunks: list[np.ndarray] = []
    occ_chunks: list[np.ndarray] = []
    for i, m in enumerate(occ_maps):
        ps = np.array(sorted(m), np.int32)
        pred_chunks.append(ps)
        occ_chunks.append(np.array([m[int(p)] for p in ps], np.int64))
        indptr[i + 1] = indptr[i] + len(ps)

    old2new = np.empty(cs.n_cs, np.int32)
    for c in range(cs.n_cs):
        old2new[c] = remap[merged_into.get(c, c)]
    return CSStats(
        cs_count=cs_count,
        indptr=indptr,
        pred_ids=np.concatenate(pred_chunks) if pred_chunks else np.zeros(0, np.int32),
        pred_occ=np.concatenate(occ_chunks) if occ_chunks else np.zeros(0, np.int64),
        ent_ids=cs.ent_ids,
        ent_cs=old2new[cs.ent_cs],
    )
