"""Characteristic Sets (paper §3.1, after Neumann & Moerkotte [11]).

A characteristic set (CS) groups the entities of a dataset that are described
by exactly the same set of predicates. Per CS ``C`` we keep
``count(C)`` (#entities) and ``occurrences(p, C)`` (#triples with predicate
``p`` whose subject is in ``C``) — precisely the statistics of Listing 1.1.

The implementation is columnar numpy (sort + segmented reduction), host
code exactly as in the reference package.  ``compute_characteristic_sets_torch``
is the device form of the per-subject signatures (the reference's
``compute_characteristic_sets_jnp``), in plain PyTorch on the card by
default; its segments feed ``repro_torch.kernels.ops.predicate_bitmaps``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.common.hashing import splitmix64
from repro_torch.rdf.dataset import TripleTable


@dataclass
class CSStats:
    """Columnar CS statistics for one dataset.

    CSR layout: CS ``c`` owns predicates ``pred_ids[indptr[c]:indptr[c+1]]``
    (sorted) with occurrence counts ``pred_occ`` aligned to ``pred_ids``.
    """

    cs_count: np.ndarray                 # (n_cs,) int64: count(C)
    indptr: np.ndarray                   # (n_cs + 1,) int64
    pred_ids: np.ndarray                 # (nnz,) int32, sorted within each CS
    pred_occ: np.ndarray                 # (nnz,) int64: occurrences(p, C)
    ent_ids: np.ndarray                  # sorted subject ids (int32)
    ent_cs: np.ndarray                   # (n_ent,) int32: CS index per subject
    _pred_index: dict[int, np.ndarray] = field(default_factory=dict, repr=False)
    _card_cache: dict = field(default_factory=dict, repr=False)  # memoized formulas

    @property
    def n_cs(self) -> int:
        return len(self.cs_count)

    def preds_of(self, c: int) -> np.ndarray:
        return self.pred_ids[self.indptr[c]: self.indptr[c + 1]]

    def occ_of(self, c: int) -> np.ndarray:
        return self.pred_occ[self.indptr[c]: self.indptr[c + 1]]

    def occurrences(self, c: int, pred: int) -> int:
        preds = self.preds_of(c)
        i = np.searchsorted(preds, pred)
        if i < len(preds) and preds[i] == pred:
            return int(self.occ_of(c)[i])
        return 0

    def cs_of_entity(self, ent: int) -> int:
        i = np.searchsorted(self.ent_ids, ent)
        if i < len(self.ent_ids) and self.ent_ids[i] == ent:
            return int(self.ent_cs[i])
        return -1

    def cs_of_entities(self, ents: np.ndarray) -> np.ndarray:
        """Vectorized entity -> CS index (-1 for unknown entities)."""
        idx = np.searchsorted(self.ent_ids, ents)
        idx = np.clip(idx, 0, max(0, len(self.ent_ids) - 1))
        ok = len(self.ent_ids) > 0
        hit = ok & (self.ent_ids[idx] == ents) if ok else np.zeros(len(ents), bool)
        out = np.where(hit, self.ent_cs[idx] if ok else 0, -1).astype(np.int32)
        return out

    # -- inverted index: predicate -> sorted CS indices ----------------------
    def cs_with_pred(self, pred: int) -> np.ndarray:
        cached = self._pred_index.get(int(pred))
        if cached is not None:
            return cached
        n_per = np.diff(self.indptr)
        owner = np.repeat(np.arange(self.n_cs, dtype=np.int32), n_per)
        hits = owner[self.pred_ids == pred]
        self._pred_index[int(pred)] = hits
        return hits

    def relevant_cs(self, preds: "list[int] | np.ndarray") -> np.ndarray:
        """CS indices whose predicate set is a superset of ``preds``.

        Only these CSs can contribute entities to a star query over ``preds``
        (§3.1: "only CSs including all of the query's predicates are
        relevant").
        """
        preds = np.asarray(preds, dtype=np.int64)
        if len(preds) == 0:
            return np.arange(self.n_cs, dtype=np.int32)
        out = self.cs_with_pred(int(preds[0]))
        for p in preds[1:]:
            if len(out) == 0:
                break
            out = np.intersect1d(out, self.cs_with_pred(int(p)), assume_unique=True)
        return out.astype(np.int32)

    def entities_of_cs(self, c: int) -> np.ndarray:
        return self.ent_ids[self.ent_cs == c]

    def nbytes(self) -> int:
        return int(
            self.cs_count.nbytes + self.indptr.nbytes + self.pred_ids.nbytes
            + self.pred_occ.nbytes + self.ent_ids.nbytes + self.ent_cs.nbytes
        )

    def invalidate_caches(self) -> None:
        """Drop the memoized formula results and the predicate inverted
        index.  The statistics lifecycle normally invalidates by *replacing*
        the CSStats object (refresh_source); this is the explicit hammer for
        out-of-band array mutation."""
        self._card_cache.clear()
        self._pred_index.clear()


def compute_characteristic_sets(table: TripleTable) -> CSStats:
    """Group the dataset's subjects by their exact predicate set.

    Sort-based: the table is already sorted by (s, p, o); we reduce to unique
    (s, p) rows with triple counts, derive a per-subject set signature, and
    group subjects by signature.
    """
    s, p = table.s, table.p
    n = len(s)
    if n == 0:
        z64 = np.zeros(0, np.int64)
        z32 = np.zeros(0, np.int32)
        return CSStats(z64, np.zeros(1, np.int64), z32, z64, z32, z32)

    # unique (s, p) with counts --------------------------------------------
    new_sp = np.ones(n, dtype=bool)
    new_sp[1:] = (s[1:] != s[:-1]) | (p[1:] != p[:-1])
    sp_start = np.nonzero(new_sp)[0]
    c_sp = np.diff(np.append(sp_start, n))           # triples per (s, p)
    us, up = s[sp_start], p[sp_start]                # unique (s, p), sorted

    # per-subject predicate-set signature ------------------------------------
    new_s = np.ones(len(us), dtype=bool)
    new_s[1:] = us[1:] != us[:-1]
    subj_start = np.nonzero(new_s)[0]
    n_subj = len(subj_start)
    subj_sizes = np.diff(np.append(subj_start, len(us)))
    ph = splitmix64(up.astype(np.uint64))
    # order-independent combine: (sum, xor, size) — 128+ bits, collisions ~0
    grp = np.repeat(np.arange(n_subj), subj_sizes)
    with np.errstate(over="ignore"):
        sig_sum = np.zeros(n_subj, np.uint64)
        np.add.at(sig_sum, grp, ph)
        sig_xor = np.zeros(n_subj, np.uint64)
        np.bitwise_xor.at(sig_xor, grp, ph)
    sig = np.stack([sig_sum, sig_xor, subj_sizes.astype(np.uint64)], axis=1)

    # group subjects by signature -> CS index --------------------------------
    _, first_idx, cs_of_subj = np.unique(sig, axis=0, return_index=True, return_inverse=True)
    cs_of_subj = cs_of_subj.astype(np.int32).reshape(-1)
    n_cs = len(first_idx)
    cs_count = np.bincount(cs_of_subj, minlength=n_cs).astype(np.int64)

    # CSR predicate lists from a representative subject ----------------------
    rep = first_idx  # subject index representative per CS
    rep_sizes = subj_sizes[rep]
    indptr = np.zeros(n_cs + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(rep_sizes)
    pred_ids = np.empty(indptr[-1], dtype=np.int32)
    for c in range(n_cs):
        st = subj_start[rep[c]]
        pred_ids[indptr[c]: indptr[c + 1]] = up[st: st + rep_sizes[c]]

    # occurrences(p, C): sum triple counts over subjects of the CS -----------
    cs_of_sp = cs_of_subj[grp]                       # CS per unique (s, p) row
    # within a subject, preds are sorted; position within subject:
    pos_in_subj = np.arange(len(us)) - subj_start[grp]
    flat = indptr[cs_of_sp] + pos_in_subj            # aligned with pred_ids CSR
    pred_occ = np.zeros(indptr[-1], dtype=np.int64)
    np.add.at(pred_occ, flat, c_sp)

    ent_ids = us[subj_start]
    return CSStats(
        cs_count=cs_count,
        indptr=indptr,
        pred_ids=pred_ids,
        pred_occ=pred_occ,
        ent_ids=ent_ids.astype(np.int32),
        ent_cs=cs_of_subj,
    )



# splitmix64's constants as int64 bit patterns (two's complement)
_SM_ADD = 0x9E3779B97F4A7C15 - (1 << 64)
_SM_MUL1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_SM_MUL2 = 0x94D049BB133111EB - (1 << 64)


def _lsr64(x, k: int):
    """Logical right shift of int64 tensors holding uint64 bit patterns
    (``>>`` on a signed tensor shifts arithmetically)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64_torch(x):
    """``common.hashing.splitmix64`` on an int64 tensor of uint64 bit
    patterns; additions and multiplications wrap modulo 2^64."""
    x = x + _SM_ADD
    x = (x ^ _lsr64(x, 30)) * _SM_MUL1
    x = (x ^ _lsr64(x, 27)) * _SM_MUL2
    return x ^ _lsr64(x, 31)


def compute_characteristic_sets_torch(s, p, device="cuda"):
    """Device path: per-subject predicate-set signatures by sort + segment
    ops, the counterpart of the reference's ``compute_characteristic_sets_jnp``.

    Returns the tuple that function returns, ``(subj_ids, sig_sum, deg,
    subj_seg, ph)``, as tensors on ``device``:

    * per subject segment (length ``n = len(s)``, an upper bound on the
      subjects; entries past the last subject are 0): ``subj_ids`` (dtype of
      ``s``), the wrapping ``sig_sum`` of the splitmix64 hashes of its
      distinct predicates (int64 holding uint64 bits) and ``deg`` (int32,
      its number of distinct predicates);
    * per row in ``(s, p)`` order: ``subj_seg`` (int64 subject segment) and
      ``ph`` (the row's predicate hash, 0 on repeats of an ``(s, p)`` row).
    """
    import torch

    s = torch.as_tensor(s, device=device)
    p = torch.as_tensor(p, device=device)
    n = s.shape[0]
    if n == 0:
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return (s.new_zeros(0), z, torch.zeros(0, dtype=torch.int32,
                                                device=device), z, z)
    # lexsort by (s, p): stable sort by p, then stably by s
    o1 = torch.argsort(p, stable=True)
    order = o1[torch.argsort(s[o1], stable=True)]
    s_, p_ = s[order], p[order]
    first = torch.ones(1, dtype=torch.bool, device=device)
    new_s = torch.cat([first, s_[1:] != s_[:-1]])
    new_sp = torch.cat([first, new_s[1:] | (p_[1:] != p_[:-1])])
    x = splitmix64_torch(p_.to(torch.int64))
    ph = torch.where(new_sp, x, 0)                  # count each (s, p) once
    subj_seg = torch.cumsum(new_s, 0) - 1
    sig_sum = torch.zeros(n, dtype=torch.int64, device=device).index_add_(
        0, subj_seg, ph)
    deg = torch.zeros(n, dtype=torch.int32, device=device).index_add_(
        0, subj_seg, new_sp.to(torch.int32))
    subj_ids = torch.zeros(n, dtype=s.dtype, device=device).scatter_reduce_(
        0, subj_seg, s_, reduce="amax", include_self=True)
    return subj_ids, sig_sum, deg, subj_seg, ph
