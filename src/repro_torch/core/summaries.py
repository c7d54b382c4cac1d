"""Entity summaries (paper §3.3) — TPU-adapted PARTree/Q-Tree.

The paper partitions entities by IRI "type" using a Radix tree and summarizes
the leaves with Q-Trees over least-significant bytes (LSBs) of hashed IRI
suffixes. A radix *trie over strings* does not vectorize, so we keep the same
two guarantees with TPU-friendly structures (DESIGN.md D2):

  * partition by IRI **authority** (the paper itself switches to authorities,
    "inspired by [14]");
  * within (authority, CS), a fixed-width **bitset signature** over
    ``splitmix64(entity_id) mod B`` bits, with per-bucket multiplicities so
    entity removal (dataset updates, §3.3) is supported.

Determinism of the hash gives the crucial property: an entity present in two
datasets sets the *same* bit in both summaries ⇒ candidate generation by
bitset-AND has **no false negatives**. False positives are pruned by the exact
intersection that follows (``federation.compute_federated_cps``).

The batched AND+popcount hot loop is numpy here, as in the reference
package (its Pallas ``summary_probe`` kernel is off the statistics path and
not ported yet).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.common.hashing import splitmix64
from repro_torch.core.characteristic_sets import CSStats
from repro_torch.rdf.dataset import TripleTable

DEFAULT_BITS = 1 << 14  # 16,384 buckets / 2 KiB per signature


def _signature(ents: np.ndarray, n_bits: int) -> np.ndarray:
    """Bitset (uint64 words) of hashed entity ids."""
    words = np.zeros(n_bits // 64, dtype=np.uint64)
    if len(ents) == 0:
        return words
    h = splitmix64(ents.astype(np.uint64)) % np.uint64(n_bits)
    np.bitwise_or.at(words, (h // np.uint64(64)).astype(np.int64), np.uint64(1) << (h % np.uint64(64)))
    return words


def _bucket_counts(ents: np.ndarray, n_bits: int) -> np.ndarray:
    h = (splitmix64(ents.astype(np.uint64)) % np.uint64(n_bits)).astype(np.int64)
    return np.bincount(h, minlength=n_bits).astype(np.uint16)


@dataclass
class EntitySummary:
    """Summary of one dataset: per-(authority, CS) subject signatures and
    per-(authority, CS, pred) object signatures."""

    src: int
    n_bits: int
    # subjects: keys aligned arrays + signature matrix rows
    subj_auth: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    subj_cs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    subj_sig: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.uint64))
    # objects: (authority, cs, pred) rows
    obj_auth: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    obj_cs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    obj_pred: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    obj_sig: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.uint64))
    # multiplicities for updates (optional, §3.3 "often updated" datasets)
    subj_counts: np.ndarray | None = None

    def nbytes(self) -> int:
        n = self.subj_sig.nbytes + self.obj_sig.nbytes
        n += self.subj_auth.nbytes + self.subj_cs.nbytes
        n += self.obj_auth.nbytes + self.obj_cs.nbytes + self.obj_pred.nbytes
        if self.subj_counts is not None:
            n += self.subj_counts.nbytes
        return int(n)

    def retag(self, src: int) -> "EntitySummary":
        """Renumber the source tag (statistics-lifecycle source removal);
        signatures are position-independent and stay valid."""
        self.src = src
        return self

    def remove_entities(self, ents: np.ndarray, cs_idx: int, auth: int) -> None:
        """Update support: decrement bucket multiplicities; clear a bit only
        when its bucket count reaches zero (paper §3.3)."""
        if self.subj_counts is None:
            raise ValueError("summary built without multiplicities")
        row = np.nonzero((self.subj_auth == auth) & (self.subj_cs == cs_idx))[0]
        if len(row) == 0:
            return
        r = int(row[0])
        h = (splitmix64(ents.astype(np.uint64)) % np.uint64(self.n_bits)).astype(np.int64)
        dec = np.bincount(h, minlength=self.n_bits)
        cnt = self.subj_counts[r].astype(np.int64) - dec
        cnt = np.maximum(cnt, 0)
        self.subj_counts[r] = cnt.astype(np.uint16)
        alive = cnt > 0
        words = np.zeros(self.n_bits // 64, dtype=np.uint64)
        idx = np.nonzero(alive)[0]
        np.bitwise_or.at(words, idx // 64, np.uint64(1) << (idx % 64).astype(np.uint64))
        self.subj_sig[r] = words


def build_summary(
    table: TripleTable,
    cs: CSStats,
    authorities: np.ndarray,
    src: int = 0,
    n_bits: int = DEFAULT_BITS,
    entity_mask: np.ndarray | None = None,
    with_counts: bool = False,
) -> EntitySummary:
    """Build the per-dataset summary the source shares with the engine.

    ``authorities``: term id -> authority id (from the dictionary).
    ``entity_mask``: term id -> bool, True if the term can be an entity
    (IRI); literal objects are not summarized (paper partitions IRIs only).
    """
    summ = EntitySummary(src=src, n_bits=n_bits)

    # subjects --------------------------------------------------------------
    keys: list[tuple[int, int]] = []
    sigs: list[np.ndarray] = []
    counts: list[np.ndarray] = []
    ent_auth = authorities[cs.ent_ids]
    for c in range(cs.n_cs):
        ents_c = cs.ent_ids[cs.ent_cs == c]
        for a in np.unique(ent_auth[cs.ent_cs == c]):
            ents = ents_c[authorities[ents_c] == a]
            keys.append((int(a), c))
            sigs.append(_signature(ents, n_bits))
            if with_counts:
                counts.append(_bucket_counts(ents, n_bits))
    if keys:
        summ.subj_auth = np.array([k[0] for k in keys], np.int32)
        summ.subj_cs = np.array([k[1] for k in keys], np.int32)
        summ.subj_sig = np.stack(sigs)
        if with_counts:
            summ.subj_counts = np.stack(counts)

    # objects ---------------------------------------------------------------
    c1 = cs.cs_of_entities(table.s)
    is_ent = authorities[table.o] >= 0
    if entity_mask is not None:
        is_ent = entity_mask[table.o]
    ok = (c1 >= 0) & is_ent
    okeys: list[tuple[int, int, int]] = []
    osigs: list[np.ndarray] = []
    if ok.any():
        cs_sel = c1[ok].astype(np.int64)
        p_sel = table.p[ok].astype(np.int64)
        o_sel = table.o[ok]
        a_sel = authorities[o_sel].astype(np.int64)
        n_cs = max(1, cs.n_cs)
        n_pred = int(p_sel.max()) + 1
        key = (a_sel * n_cs + cs_sel) * n_pred + p_sel
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        o_s = o_sel[order]
        starts = np.nonzero(np.concatenate([[True], key_s[1:] != key_s[:-1]]))[0]
        ends = np.append(starts[1:], len(key_s))
        for st, en in zip(starts, ends):
            k = int(key_s[st])
            p = k % n_pred
            c_ = (k // n_pred) % n_cs
            a = k // (n_pred * n_cs)
            okeys.append((int(a), int(c_), int(p)))
            osigs.append(_signature(np.unique(o_s[st:en]), n_bits))
    if okeys:
        summ.obj_auth = np.array([k[0] for k in okeys], np.int32)
        summ.obj_cs = np.array([k[1] for k in okeys], np.int32)
        summ.obj_pred = np.array([k[2] for k in okeys], np.int32)
        summ.obj_sig = np.stack(osigs)
    return summ


def candidate_cs_pairs(obj_summary: EntitySummary, subj_summary: EntitySummary) -> np.ndarray:
    """All (obj_row, subj_row) index pairs whose signatures intersect on the
    same authority — the no-false-negative candidate set for Algorithm 1.

    Returns an (n, 2) int32 array of row indices into ``obj_summary`` objects
    and ``subj_summary`` subjects.
    """
    if len(obj_summary.obj_auth) == 0 or len(subj_summary.subj_auth) == 0:
        return np.zeros((0, 2), np.int32)
    out: list[tuple[int, int]] = []
    # group subject rows by authority for pruning
    for a in np.unique(obj_summary.obj_auth):
        orows = np.nonzero(obj_summary.obj_auth == a)[0]
        srows = np.nonzero(subj_summary.subj_auth == a)[0]
        if len(srows) == 0:
            continue
        osig = obj_summary.obj_sig[orows]            # (no, W)
        ssig = subj_summary.subj_sig[srows]          # (ns, W)
        inter = (osig[:, None, :] & ssig[None, :, :])
        hit = inter.any(axis=2)
        oi, si = np.nonzero(hit)
        out.extend(zip(orows[oi].tolist(), srows[si].tolist()))
    if not out:
        return np.zeros((0, 2), np.int32)
    return np.asarray(out, dtype=np.int32)
