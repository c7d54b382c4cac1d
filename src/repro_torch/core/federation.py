"""Federated statistics (paper §3.2): link exports + Algorithm 1.

Each source computes, alongside its CS statistics:
  * ``subjects``: per CS, the sorted set of its subject entity ids;
  * ``objects``: per (CS, predicate), the sorted set of linked object entity
    ids with per-object link multiplicities (#subjects of the CS pointing at
    the object via the predicate).

``compute_federated_cps`` is Algorithm 1: intersect source A's ``objects``
with source B's ``subjects``; every common entity contributes its multiplicity
to ``count(cs1, cs2, p)``. Entity summaries (§3.3) prune the candidate
(cs1, p) × cs2 space first — never dropping a true link — after which only the
surviving pairs are intersected exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from dataclasses import replace as dc_replace

import numpy as np

from repro_torch.core.characteristic_pairs import CPStats
from repro_torch.core.characteristic_sets import CSStats, compute_characteristic_sets
from repro_torch.core.summaries import DEFAULT_BITS as DEFAULT_SUMMARY_BITS
from repro_torch.core.summaries import EntitySummary, build_summary, candidate_cs_pairs
from repro_torch.rdf.dataset import Federation, TripleTable


@dataclass
class LinkExport:
    """The per-source structures of Fig. 1 (a)/(b)."""

    src: int
    # subjects: CSR over CS index
    n_cs: int
    subj_indptr: np.ndarray      # (n_cs + 1,)
    subj_ents: np.ndarray        # sorted within each CS
    # objects: one row per (cs, pred)
    obj_cs: np.ndarray           # (n_rows,) int32
    obj_pred: np.ndarray         # (n_rows,) int32
    obj_indptr: np.ndarray       # (n_rows + 1,)
    obj_ents: np.ndarray         # sorted within each row
    obj_mult: np.ndarray         # int32 aligned with obj_ents

    def subjects_of(self, c: int) -> np.ndarray:
        return self.subj_ents[self.subj_indptr[c]: self.subj_indptr[c + 1]]

    def objects_row(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        sl = slice(self.obj_indptr[r], self.obj_indptr[r + 1])
        return self.obj_ents[sl], self.obj_mult[sl]

    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in (
            self.subj_indptr, self.subj_ents, self.obj_cs, self.obj_pred,
            self.obj_indptr, self.obj_ents, self.obj_mult)))


def export_link_stats(table: TripleTable, cs: CSStats, src: int = 0,
                      entity_mask: np.ndarray | None = None) -> LinkExport:
    """Compute the source's ``subjects``/``objects`` export (cheap, columnar)."""
    # subjects CSR
    order = np.argsort(cs.ent_cs, kind="stable")
    subj_ents_grouped = cs.ent_ids[order]
    counts = np.bincount(cs.ent_cs, minlength=cs.n_cs)
    subj_indptr = np.zeros(cs.n_cs + 1, np.int64)
    subj_indptr[1:] = np.cumsum(counts)
    # sort entities within each CS
    for c in range(cs.n_cs):
        sl = slice(subj_indptr[c], subj_indptr[c + 1])
        subj_ents_grouped[sl] = np.sort(subj_ents_grouped[sl])

    # objects rows
    c1 = cs.cs_of_entities(table.s)
    ok = c1 >= 0
    if entity_mask is not None:
        ok &= entity_mask[table.o]
    obj_cs_l: list[int] = []
    obj_pred_l: list[int] = []
    ent_chunks: list[np.ndarray] = []
    mult_chunks: list[np.ndarray] = []
    indptr = [0]
    if ok.any():
        cs_sel = c1[ok].astype(np.int64)
        p_sel = table.p[ok].astype(np.int64)
        o_sel = table.o[ok].astype(np.int64)
        n_pred = int(p_sel.max()) + 1
        key = cs_sel * n_pred + p_sel
        order = np.lexsort((o_sel, key))
        key_s, o_s = key[order], o_sel[order]
        starts = np.nonzero(np.concatenate([[True], key_s[1:] != key_s[:-1]]))[0]
        ends = np.append(starts[1:], len(key_s))
        for st, en in zip(starts, ends):
            k = int(key_s[st])
            obj_cs_l.append(k // n_pred)
            obj_pred_l.append(k % n_pred)
            ents, mult = np.unique(o_s[st:en], return_counts=True)
            ent_chunks.append(ents.astype(np.int32))
            mult_chunks.append(mult.astype(np.int32))
            indptr.append(indptr[-1] + len(ents))
    return LinkExport(
        src=src,
        n_cs=cs.n_cs,
        subj_indptr=subj_indptr,
        subj_ents=subj_ents_grouped.astype(np.int32),
        obj_cs=np.asarray(obj_cs_l, np.int32),
        obj_pred=np.asarray(obj_pred_l, np.int32),
        obj_indptr=np.asarray(indptr, np.int64),
        obj_ents=np.concatenate(ent_chunks).astype(np.int32) if ent_chunks else np.zeros(0, np.int32),
        obj_mult=np.concatenate(mult_chunks).astype(np.int32) if mult_chunks else np.zeros(0, np.int32),
    )


@dataclass
class FedCPResult:
    cps: CPStats
    n_checked_pairs: int     # exact intersections performed
    n_possible_pairs: int    # |objects rows| × |subject CSs| without pruning


def compute_federated_cps(
    obj_export: LinkExport,
    subj_export: LinkExport,
    obj_summary: EntitySummary | None = None,
    subj_summary: EntitySummary | None = None,
) -> FedCPResult:
    """Algorithm 1 (ComputeFedCPs): federated CPs from pre-computed exports.

    With summaries, only candidate (objects-row, cs2) pairs whose bitset
    signatures intersect are checked exactly — the paper's pruning — which is
    guaranteed to retain every true link (tests assert equality with the
    unpruned run).
    """
    n_rows = len(obj_export.obj_cs)
    n_possible = n_rows * subj_export.n_cs
    pred_l: list[int] = []
    cs1_l: list[int] = []
    cs2_l: list[int] = []
    cnt_l: list[int] = []
    checked = 0

    if obj_summary is not None and subj_summary is not None:
        cand = candidate_cs_pairs(obj_summary, subj_summary)
        # map summary rows -> export rows: summary object rows are keyed by
        # (auth, cs, pred); export rows by (cs, pred). A (cs, pred) export row
        # may span several authorities; dedupe the (export_row, cs2) pairs.
        okey = {}
        for r in range(n_rows):
            okey.setdefault((int(obj_export.obj_cs[r]), int(obj_export.obj_pred[r])), r)
        seen: set[tuple[int, int]] = set()
        pairs: list[tuple[int, int]] = []
        for oi, si in cand:
            key = (int(obj_summary.obj_cs[oi]), int(obj_summary.obj_pred[oi]))
            r = okey.get(key)
            if r is None:
                continue
            c2 = int(subj_summary.subj_cs[si])
            if (r, c2) not in seen:
                seen.add((r, c2))
                pairs.append((r, c2))
    else:
        pairs = [(r, c2) for r in range(n_rows) for c2 in range(subj_export.n_cs)]

    for r, c2 in pairs:
        ents, mult = obj_export.objects_row(r)
        subj = subj_export.subjects_of(c2)
        if len(ents) == 0 or len(subj) == 0:
            continue
        checked += 1
        common, i1, _ = np.intersect1d(ents, subj, assume_unique=True, return_indices=True)
        if len(common) == 0:
            continue
        pred_l.append(int(obj_export.obj_pred[r]))
        cs1_l.append(int(obj_export.obj_cs[r]))
        cs2_l.append(c2)
        cnt_l.append(int(mult[i1].sum()))

    cps = CPStats.from_rows(
        np.asarray(pred_l, np.int32), np.asarray(cs1_l, np.int32),
        np.asarray(cs2_l, np.int32), np.asarray(cnt_l, np.int64),
        src1=obj_export.src, src2=subj_export.src,
    )
    return FedCPResult(cps=cps, n_checked_pairs=checked, n_possible_pairs=n_possible)


def compute_federated_css(subj_a: LinkExport, subj_b: LinkExport) -> list[tuple[int, int, int]]:
    """Federated CSs: entities described in both datasets (§3.2, "similar
    principle ... considering the subjects shared by different datasets").
    Returns (csA, csB, #common entities) triples."""
    out: list[tuple[int, int, int]] = []
    for ca in range(subj_a.n_cs):
        ea = subj_a.subjects_of(ca)
        if len(ea) == 0:
            continue
        for cb in range(subj_b.n_cs):
            eb = subj_b.subjects_of(cb)
            if len(eb) == 0:
                continue
            common = np.intersect1d(ea, eb, assume_unique=True)
            if len(common):
                out.append((ca, cb, len(common)))
    return out


# --------------------------------------------------------------------------
# Federation-wide statistics store + versioned lifecycle
# --------------------------------------------------------------------------

@dataclass
class FederatedStats:
    """Everything the Odyssey optimizer needs, for all sources.

    The store is *versioned*: ``epoch`` increases monotonically on every
    mutation (``remove_source`` / ``add_source`` / ``refresh_source``), and
    epoch-aware consumers (the plan cache) treat entries planned under an
    older epoch as misses.  Mutators recompute only the affected source's
    CS/CP/link-export/summary state plus the federated CPs incident to it —
    the other sources' ``LinkExport``s are reused via Algorithm 1 — and are
    differentially tested to be bit-identical to a from-scratch
    ``build_federated_stats`` of the same federation.

    Per-source cache scoping falls out of object replacement: a mutated
    source's ``CSStats``/``CPStats`` objects (and their ``_card_cache``
    memos) are replaced wholesale, while untouched sources keep their warm
    caches, which stay valid because their underlying arrays are unchanged.
    """

    cs: list[CSStats]                                  # per source
    intra_cp: list[CPStats]                            # per source
    fed_cp: dict[tuple[int, int], CPStats] = field(default_factory=dict)
    fed_cs: dict[tuple[int, int], list[tuple[int, int, int]]] = field(default_factory=dict)
    exports: list[LinkExport] = field(default_factory=list)
    summaries: list[EntitySummary] = field(default_factory=list)
    pruning_checked: int = 0
    pruning_possible: int = 0
    epoch: int = 0
    # build-time configuration, carried so the incremental mutators reproduce
    # exactly what build_federated_stats computes from scratch
    use_summaries: bool = True
    n_bits: int = DEFAULT_SUMMARY_BITS
    max_cs: int | None = None
    dictionary: object | None = None                   # TermDict of the federation
    # per ordered source pair: (exact checks, possible pairs) from Algorithm 1
    _pair_pruning: dict[tuple[int, int], tuple[int, int]] = field(
        default_factory=dict, repr=False)

    @property
    def n_sources(self) -> int:
        return len(self.cs)

    def cp_between(self, src1: int, src2: int) -> CPStats | None:
        if src1 == src2:
            return self.intra_cp[src1]
        return self.fed_cp.get((src1, src2))

    def nbytes(self) -> int:
        n = sum(c.nbytes() for c in self.cs) + sum(c.nbytes() for c in self.intra_cp)
        n += sum(c.nbytes() for c in self.fed_cp.values())
        n += sum(s.nbytes() for s in self.summaries)
        return int(n)

    # -- lifecycle ----------------------------------------------------------

    def clone(self) -> "FederatedStats":
        """Cheap detached copy: shares the statistics *arrays* (which are
        never mutated in place) but owns every container and every src-tagged
        wrapper, so incremental mutators on the clone never write through to
        ``self`` — the safe starting point for a failover session or an A/B
        statistics experiment over shared base stats."""
        return FederatedStats(
            cs=list(self.cs),
            intra_cp=[dc_replace(c) for c in self.intra_cp],
            fed_cp={k: dc_replace(c) for k, c in self.fed_cp.items()},
            fed_cs={k: list(v) for k, v in self.fed_cs.items()},
            exports=[dc_replace(e) for e in self.exports],
            summaries=[dc_replace(s) for s in self.summaries],
            pruning_checked=self.pruning_checked,
            pruning_possible=self.pruning_possible,
            epoch=self.epoch,
            use_summaries=self.use_summaries,
            n_bits=self.n_bits,
            max_cs=self.max_cs,
            dictionary=self.dictionary,
            _pair_pruning=dict(self._pair_pruning),
        )

    def invalidate_caches(self) -> None:
        """Blunt-hammer invalidation: drop every memoized formula and
        predicate index on every CS/CP object and bump the epoch (so the
        plan cache treats existing entries as stale).  The incremental
        mutators do *not* need this (they scope invalidation by object
        replacement); it exists for callers that mutate statistics arrays
        out-of-band."""
        from repro_torch.core.cardinality import clear_card_caches

        clear_card_caches(self)
        self.epoch += 1

    def _require_lifecycle(self) -> None:
        if self.dictionary is None:
            raise ValueError(
                "statistics lifecycle needs the federation dictionary; build "
                "this FederatedStats via build_federated_stats (or set "
                ".dictionary) before calling remove/add/refresh_source")

    def _local_stats(self, table: TripleTable, src: int):
        """One source's CS / intra-CP / link-export / summary — exactly the
        per-source loop body of ``build_federated_stats``."""
        from repro_torch.core.characteristic_pairs import compute_characteristic_pairs
        from repro_torch.stats.reduce import reduce_cs

        auth = self.dictionary.authority_array()
        kinds = np.asarray(self.dictionary.kinds, np.int8)
        entity_mask = kinds == 0  # IRI
        cs = compute_characteristic_sets(table)
        if self.max_cs is not None and cs.n_cs > self.max_cs:
            cs = reduce_cs(cs, self.max_cs)
        cp = compute_characteristic_pairs(table, cs, src=src)
        exp = export_link_stats(table, cs, src=src, entity_mask=entity_mask)
        summ = (build_summary(table, cs, auth, src=src, n_bits=self.n_bits,
                              entity_mask=entity_mask)
                if self.use_summaries else None)
        return cs, cp, exp, summ

    def _compute_pair(self, i: int, j: int) -> None:
        """(Re)run Algorithm 1 for the ordered pair (i, j), updating
        ``fed_cp`` and the per-pair pruning ledger."""
        res = compute_federated_cps(
            self.exports[i], self.exports[j],
            self.summaries[i] if self.use_summaries else None,
            self.summaries[j] if self.use_summaries else None,
        )
        self._pair_pruning[(i, j)] = (res.n_checked_pairs, res.n_possible_pairs)
        if res.cps.n_cp:
            self.fed_cp[(i, j)] = res.cps
        else:
            self.fed_cp.pop((i, j), None)

    def _refresh_pruning_totals(self) -> None:
        self.pruning_checked = sum(c for c, _ in self._pair_pruning.values())
        self.pruning_possible = sum(p for _, p in self._pair_pruning.values())

    def remove_source(self, sid: int) -> None:
        """Drop source ``sid`` and renumber the survivors — no statistic is
        recomputed (every surviving CS/CP/export/summary is reused; only the
        source tags and pair keys shift), so an N-source federation loses an
        endpoint in O(#pairs) dict work instead of an O(N²) rebuild.  Pure
        bookkeeping: unlike add/refresh it needs no build metadata, so it
        also works on directly-constructed stats."""
        if not 0 <= sid < self.n_sources:
            raise IndexError(f"source {sid} out of range (n={self.n_sources})")
        del self.cs[sid]
        del self.intra_cp[sid]
        if self.exports:                   # absent on directly-built stats
            del self.exports[sid]
        if self.summaries:
            del self.summaries[sid]

        def remap(i: int) -> int:
            return i - 1 if i > sid else i

        for j in range(sid, self.n_sources):
            self.intra_cp[j].retag(j, j)
            if self.exports:
                self.exports[j].src = j
            if self.summaries:
                self.summaries[j].retag(j)
        fed_cp: dict[tuple[int, int], CPStats] = {}
        for (i, j), cp in self.fed_cp.items():
            if sid in (i, j):
                continue
            cp.retag(remap(i), remap(j))
            fed_cp[(remap(i), remap(j))] = cp
        self.fed_cp = fed_cp
        self.fed_cs = {(remap(i), remap(j)): v for (i, j), v in self.fed_cs.items()
                       if sid not in (i, j)}
        self._pair_pruning = {(remap(i), remap(j)): v
                              for (i, j), v in self._pair_pruning.items()
                              if sid not in (i, j)}
        self._refresh_pruning_totals()
        self.epoch += 1

    def add_source(self, table: TripleTable) -> int:
        """Append a new source (recovery / federation growth): compute its
        local statistics plus the 2·N federated-CP pairs incident to it,
        reusing every existing source's ``LinkExport``/summary.  Returns the
        new source id."""
        self._require_lifecycle()
        src = self.n_sources
        cs, cp, exp, summ = self._local_stats(table, src)
        self.cs.append(cs)
        self.intra_cp.append(cp)
        self.exports.append(exp)
        if self.use_summaries:
            self.summaries.append(summ)
        for i in range(src):
            self._compute_pair(i, src)
            self._compute_pair(src, i)
        self._refresh_pruning_totals()
        self.epoch += 1
        return src

    def refresh_source(self, sid: int, table: TripleTable) -> None:
        """Re-derive source ``sid`` from (possibly changed) data: its local
        CS/CP/export/summary state is replaced wholesale — which also retires
        exactly its memoized-formula caches — and only the federated CPs
        incident to it are recomputed."""
        self._require_lifecycle()
        if not 0 <= sid < self.n_sources:
            raise IndexError(f"source {sid} out of range (n={self.n_sources})")
        cs, cp, exp, summ = self._local_stats(table, sid)
        self.cs[sid] = cs
        self.intra_cp[sid] = cp
        self.exports[sid] = exp
        if self.use_summaries:
            self.summaries[sid] = summ
        for i in range(self.n_sources):
            if i != sid:
                self._compute_pair(i, sid)
                self._compute_pair(sid, i)
        self._refresh_pruning_totals()
        self.epoch += 1


def build_federated_stats(fed: Federation, use_summaries: bool = True,
                          n_bits: int = 1 << 14, max_cs: int | None = None) -> FederatedStats:
    """End-to-end statistics pipeline for a federation (what a deployment's
    statistics service runs)."""
    from repro_torch.core.characteristic_pairs import compute_characteristic_pairs
    from repro_torch.stats.reduce import reduce_cs

    auth = fed.dictionary.authority_array()
    kinds = np.asarray(fed.dictionary.kinds, np.int8)
    entity_mask = kinds == 0  # IRI

    cs_list: list[CSStats] = []
    cp_list: list[CPStats] = []
    exports: list[LinkExport] = []
    summaries: list[EntitySummary] = []
    for i, src in enumerate(fed.sources):
        cs = compute_characteristic_sets(src.table)
        if max_cs is not None and cs.n_cs > max_cs:
            cs = reduce_cs(cs, max_cs)
        cs_list.append(cs)
        cp_list.append(compute_characteristic_pairs(src.table, cs, src=i))
        exports.append(export_link_stats(src.table, cs, src=i, entity_mask=entity_mask))
        if use_summaries:
            summaries.append(build_summary(src.table, cs, auth, src=i, n_bits=n_bits,
                                           entity_mask=entity_mask))

    stats = FederatedStats(cs=cs_list, intra_cp=cp_list, exports=exports, summaries=summaries,
                           use_summaries=use_summaries, n_bits=n_bits, max_cs=max_cs,
                           dictionary=fed.dictionary)
    for i in range(len(fed.sources)):
        for j in range(len(fed.sources)):
            if i == j:
                continue
            stats._compute_pair(i, j)
    stats._refresh_pruning_totals()
    return stats
