"""Bounded-buffer relational operators on tensors, the port of the
reference's ``jax.jit`` operators.

Every operator takes and returns fixed-capacity relations:

    rel = (data: (..., CAP, NCOLS) int32, valid: (..., CAP) bool,
           overflow: (...) bool)

with any number of leading batch dimensions, so the SPMD engine runs each
operator once over all of its ``(data, model)`` shards.  Where one
operator takes two relations (a join's probe and build sides), their batch
dimensions broadcast: a build side that is the same for every data shard
keeps that dimension at size 1 and is sorted once.  On a 2-D input each
operator returns what the reference returns, element for element: the same
stable sorts and the same int32 sums, so overflowing buffers keep the same
rows too.  Rows beyond the live count are zeroed and invalid; overflow
flags tell the host that a capacity was too small.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 2**31 - 1                  # the sort key of invalid rows

# unbound marker inside int32 columns (mirrors repro_torch.engine.local.UNDEF)
UNDEF = -1

OP_CODES = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` along the last dimension, batch dimensions broadcast."""
    batch = torch.broadcast_shapes(x.shape[:-1], idx.shape[:-1])
    return torch.gather(x.expand(*batch, x.shape[-1]), -1,
                        idx.expand(*batch, idx.shape[-1]))


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (..., K) of ``x`` (..., N, C), batch dimensions
    broadcast (a size-1 dimension of ``x`` is not copied)."""
    batch = torch.broadcast_shapes(x.shape[:-2], idx.shape[:-1])
    return torch.gather(x.expand(*batch, *x.shape[-2:]), -2,
                        idx.unsqueeze(-1).expand(*batch, idx.shape[-1], x.shape[-1]))


def searchsorted(seq: torch.Tensor, vals: torch.Tensor, side: str) -> torch.Tensor:
    """``searchsorted`` along the last dimension, where the leading
    dimensions of ``seq`` broadcast against those of ``vals``.  A dimension
    of size 1 in ``seq`` is moved into the searched values, so ``seq`` is
    searched once for every index along it, not copied."""
    vals = vals.to(seq.dtype)
    nb = max(seq.dim(), vals.dim()) - 1
    seq = seq.reshape((1,) * (nb + 1 - seq.dim()) + tuple(seq.shape))
    vals = vals.reshape((1,) * (nb + 1 - vals.dim()) + tuple(vals.shape))
    batch = torch.broadcast_shapes(seq.shape[:-1], vals.shape[:-1])
    vals = vals.expand(*batch, vals.shape[-1])
    rep = [i for i in range(nb) if seq.shape[i] == 1 and batch[i] != 1]
    keep = [i for i in range(nb) if i not in rep]
    perm = keep + rep + [nb]
    kept = [batch[i] for i in keep]
    s = seq.expand(*[batch[i] if i in keep else 1 for i in range(nb)],
                   seq.shape[-1]).permute(perm).reshape(*kept, seq.shape[-1])
    v = vals.permute(perm).reshape(*kept, -1)
    out = torch.searchsorted(s.contiguous(), v.contiguous(), side=side)
    out = out.reshape(*kept, *[batch[i] for i in rep], vals.shape[-1])
    inv = [perm.index(i) for i in range(nb + 1)]
    return out.permute(inv)


def make_rel(cap: int, ncols: int, *, device: str = "cuda"):
    return (torch.zeros((cap, ncols), dtype=torch.int32, device=device),
            torch.zeros(cap, dtype=torch.bool, device=device),
            torch.zeros((), dtype=torch.bool, device=device))


def compact(mask: torch.Tensor, cap: int):
    """Indices of the first ``cap`` True rows (stable), their validity, and
    an overflow flag.  Below ``cap`` rows the indices are padded with 0."""
    n = mask.shape[-1]
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    if n >= cap:
        idx = order[..., :cap]
    else:
        idx = torch.cat([order, order.new_zeros(*order.shape[:-1], cap - n)], -1)
    total = mask.sum(-1, dtype=torch.int32)
    valid = (torch.arange(cap, device=mask.device)
             < torch.clamp(total, max=n).unsqueeze(-1))
    return idx, valid, total > cap


def scan_pattern(table: torch.Tensor, trow: torch.Tensor, pattern,
                 cap: int, out_cols: tuple):
    """Match (s, p, o) with -1 wildcards against table (..., N, 3) rows
    (invalid rows marked by ``trow`` False); ``pattern`` is (..., 3).
    Returns a bounded relation over the columns in ``out_cols``."""
    pattern = torch.as_tensor(pattern, dtype=torch.int32, device=table.device)
    m = trow
    for c in range(3):
        v = pattern[..., c, None]
        m = m & ((v < 0) | (table[..., c] == v))
    idx, valid, ovf = compact(m, cap)
    data = take_rows(table, idx)[..., list(out_cols)]
    data = torch.where(valid.unsqueeze(-1), data, 0)
    return data, valid, ovf


def scan_rows(table: torch.Tensor, rows: torch.Tensor, live: torch.Tensor,
              pattern: tuple, cap: int, out_cols: tuple):
    """``scan_pattern`` over the candidate rows ``rows`` (..., L) of ``table``
    (..., N, 3), of which ``live`` (..., L) marks the real ones; ``pattern``
    is (s, p, o) as host ints, -1 a wildcard.  Where the live candidates
    hold, in table order, every valid row that can match, the result is
    ``scan_pattern``'s element for element, overflow included: the same
    matches, kept in the same order up to ``cap``."""
    cand = take_rows(table, rows)
    m = live
    for c, v in enumerate(pattern):
        if v >= 0:
            m = m & (cand[..., c] == v)
    idx, valid, ovf = compact(m, cap)
    data = take_rows(cand, idx)[..., list(out_cols)]
    data = torch.where(valid.unsqueeze(-1), data, 0)
    return data, valid, ovf


class PredicateIndex:
    """Each shard's valid rows ordered by (predicate, position): a stable
    sort on the predicate, so the rows of one predicate are a range of
    ``order`` and keep their table order within it.

    ``pred`` and ``trow`` are (..., N) host arrays, the leading dimensions
    the shards.  ``order`` (..., N) int32 lives on ``device``; the ranges
    stay on the host (``ranges[p]``: start and count, (2, ...) int64), so a
    scan knows its ranges without a read from the card."""

    def __init__(self, pred: np.ndarray, trow: np.ndarray, device):
        self.batch, self.n = pred.shape[:-1], pred.shape[-1]
        pred, trow = pred.reshape(-1, self.n), trow.reshape(-1, self.n)
        order = np.zeros(pred.shape, np.int32)
        ranges: dict[int, np.ndarray] = {}
        for b in range(len(pred)):
            pos = np.flatnonzero(trow[b])
            p = pred[b, pos]
            srt = np.argsort(p, kind="stable")
            order[b, :len(pos)] = pos[srt]
            p = p[srt]
            first = np.flatnonzero(np.diff(p, prepend=p[:1] - 1))
            counts = np.diff(np.r_[first, len(p)])
            for v, f, c in zip(p[first].tolist(), first.tolist(), counts.tolist()):
                if v not in ranges:
                    ranges[v] = np.zeros((2, len(pred)), np.int64)
                ranges[v][:, b] = f, c
        self.ranges = {v: r.reshape(2, *self.batch) for v, r in ranges.items()}
        self.order = torch.from_numpy(order.reshape(*self.batch, self.n)).to(device)

    def scan(self, table: torch.Tensor, pattern: tuple, on: np.ndarray, cap: int,
             out_cols: tuple):
        """``scan_pattern(table, trow & on[..., None], pattern, cap, out_cols)``
        for ``pattern`` (s, p, o) host ints with ``p`` bound, comparing only
        the rows of ``p`` in the shards where ``on`` (host bool, the batch
        shape) holds, padded to a power of two.  Returns the relation and
        the slots compared; a predicate that no such shard holds gives the
        empty relation, with no scan."""
        r = self.ranges.get(pattern[1])
        count = np.where(on, r[1], 0) if r is not None else np.zeros(self.batch, np.int64)
        width = int(count.max(initial=0))
        dev = self.order.device
        if width == 0:
            return (torch.zeros((*self.batch, cap, len(out_cols)), dtype=torch.int32,
                                device=dev),
                    torch.zeros((*self.batch, cap), dtype=torch.bool, device=dev),
                    torch.zeros(self.batch, dtype=torch.bool, device=dev)), 0
        width = 1 << (width - 1).bit_length()
        start, count = torch.from_numpy(np.stack([r[0], count])).to(dev).unsqueeze(-1)
        j = torch.arange(width, device=dev)
        rows = take(self.order, (start + j).clamp(max=self.n - 1)).long()
        live = j < count
        # the live candidates are p's rows: matching (s, -1, o) among them
        # is matching (s, p, o) in the whole table, so p needs no compare
        s, _, o = pattern
        return scan_rows(table, rows, live, (s, -1, o), cap, out_cols), live.numel()


def semi_bind(rel: torch.Tensor, valid: torch.Tensor, keys: torch.Tensor,
              kvalid: torch.Tensor, key_col: int, cap: int):
    """Bind-join filter: keep rel rows whose ``key_col`` appears in ``keys``
    (the shipped bindings). Mirrors dispatching a subquery with VALUES."""
    eq = ((rel[..., key_col].unsqueeze(-1) == keys.unsqueeze(-2))
          & kvalid.unsqueeze(-2))
    m = valid & eq.any(-1)
    idx, v, ovf = compact(m, cap)
    return torch.where(v.unsqueeze(-1), take_rows(rel, idx), 0), v, ovf


def _probe(left, lvalid, lkey, right, rvalid, rkey, outcnt_of):
    """The sort and search both merge joins share: the build side sorted by
    key (invalid rows last), each probe row's match range, and the output
    offsets of ``outcnt_of(lvalid, counts)`` rows per probe row."""
    rk = torch.where(rvalid, right[..., rkey], BIG)
    order = torch.argsort(rk, dim=-1, stable=True)
    rk_s = take(rk, order)
    lk = torch.where(lvalid, left[..., lkey], BIG - 1)
    start = searchsorted(rk_s, lk, "left")
    end = searchsorted(rk_s, lk, "right")
    counts = torch.where(lvalid, end - start, 0)
    offsets = torch.cumsum(outcnt_of(lvalid, counts), -1, dtype=torch.int32)
    return order, start, counts, offsets


def _locate(offsets, start, cap: int, L: int, R: int):
    """Output row ``t``'s (probe row, match rank, build position)."""
    t = torch.arange(cap, dtype=torch.int32, device=offsets.device)
    li = searchsorted(offsets, t, "right").clamp(0, L - 1)
    prev = torch.where(li > 0, take(offsets, (li - 1).clamp(min=0)), 0)
    rank = t - prev
    ri = (take(start, li) + rank).clamp(0, R - 1)
    return t, li, ri


def merge_join(left: torch.Tensor, lvalid: torch.Tensor, lkey: int,
               right: torch.Tensor, rvalid: torch.Tensor, rkey: int, cap: int):
    """Inner join on one key column with bounded output.

    Sorts the right side by key, computes per-left-row match counts and
    offsets, then materializes output row ``t`` by locating its (left row,
    match rank) via searchsorted on the cumulative counts.
    Output columns: left cols ++ right cols (join key duplicated).
    """
    L, R = left.shape[-2], right.shape[-2]
    order, start, _, offsets = _probe(left, lvalid, lkey, right, rvalid, rkey,
                                      lambda lv, counts: counts)
    total = offsets[..., -1]
    t, li, ri = _locate(offsets, start, cap, L, R)
    ri = take(order, ri)
    valid = (t < total.unsqueeze(-1)) & take(lvalid, li) & take(rvalid, ri)
    data = torch.cat([take_rows(left, li), take_rows(right, ri)], -1)
    data = torch.where(valid.unsqueeze(-1), data, 0)
    return data, valid, total > cap


def distinct(rel: torch.Tensor, valid: torch.Tensor, cap: int):
    """Sort rows lexicographically and keep first occurrences.  The order is
    the reference's ``lexsort``: the last column most significant, the
    validity least, built from stable sorts least significant key first."""
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    for c in range(rel.shape[-1]):
        order = take(order, torch.argsort(take(rel[..., c], order), dim=-1,
                                         stable=True))
    r = take_rows(rel, order)
    v = take(valid, order)
    same = (r[..., 1:, :] == r[..., :-1, :]).all(-1) & v[..., 1:] & v[..., :-1]
    first = torch.cat([torch.ones_like(v[..., :1]), ~same], -1)
    idx, vv, ovf = compact(v & first, cap)
    return torch.where(vv.unsqueeze(-1), take_rows(r, idx), 0), vv, ovf


def count_valid(valid: torch.Tensor) -> torch.Tensor:
    return valid.sum(-1, dtype=torch.int32)


# --------------------------------------------------------------------------
# Group-algebra operators (OPTIONAL / UNION / FILTER)
# --------------------------------------------------------------------------

def left_merge_join(left: torch.Tensor, lvalid: torch.Tensor, lkey: int,
                    right: torch.Tensor, rvalid: torch.Tensor, rkey: int,
                    cap: int):
    """OPTIONAL on one key column with bounded output: ``merge_join`` plus
    one pad row per unmatched valid left row, right columns set to UNDEF.
    Output columns: left cols ++ right cols, like ``merge_join``."""
    L, R = left.shape[-2], right.shape[-2]
    # every valid left row emits max(matches, 1) rows
    order, start, counts, offsets = _probe(
        left, lvalid, lkey, right, rvalid, rkey,
        lambda lv, counts: torch.where(lv, counts.clamp(min=1), 0))
    total = offsets[..., -1]
    t, li, ri = _locate(offsets, start, cap, L, R)
    matched = take(counts, li) > 0
    valid = (t < total.unsqueeze(-1)) & take(lvalid, li)
    rdata = torch.where(matched.unsqueeze(-1), take_rows(right, take(order, ri)),
                        UNDEF)
    data = torch.cat([take_rows(left, li), rdata], -1)
    data = torch.where(valid.unsqueeze(-1), data, 0)
    return data, valid, total > cap


def align_columns(rel: torch.Tensor, valid: torch.Tensor, col_map: tuple):
    """Schema alignment before ``union_rels``: output column j is input
    column ``col_map[j]``, or UNDEF where ``col_map[j] < 0`` (the variable is
    absent from this branch)."""
    undef = torch.full(rel.shape[:-1], UNDEF, dtype=torch.int32,
                       device=rel.device)
    data = torch.stack([rel[..., c] if c >= 0 else undef for c in col_map], -1)
    return torch.where(valid.unsqueeze(-1), data, 0), valid


def union_rels(a: torch.Tensor, avalid: torch.Tensor, b: torch.Tensor,
               bvalid: torch.Tensor, cap: int):
    """Union of two schema-aligned bounded relations (align branches with
    ``align_columns`` first), a-rows before b-rows, stable."""
    data = torch.cat([a, b], -2)
    valid = torch.cat([avalid, bvalid], -1)
    idx, v, ovf = compact(valid, cap)
    return torch.where(v.unsqueeze(-1), take_rows(data, idx), 0), v, ovf


def compare_mask(rel: torch.Tensor, valid: torch.Tensor, op: int,
                 lhs_col: int, rhs_col: int, lhs_const, rhs_const) -> torch.Tensor:
    """Row mask of one FILTER comparison (``OP_CODES``); a side is a column
    when its ``*_col >= 0``, else the ``*_const`` scalar.  Two-valued: rows
    with an UNDEF side are false.  Combine masks with torch logical ops for
    &&/||/! and compact with ``filter_rows``."""
    def side(col, const):
        if col >= 0:
            return rel[..., col]
        return torch.as_tensor(const, dtype=torch.int32,
                               device=rel.device).expand(rel.shape[:-1])

    lv, rv = side(lhs_col, lhs_const), side(rhs_col, rhs_const)
    bound = (lv != UNDEF) & (rv != UNDEF)
    res = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)[op](lv, rv)
    return valid & bound & res


def filter_rows(rel: torch.Tensor, valid: torch.Tensor, mask: torch.Tensor,
                cap: int):
    """Compact the rows where ``mask`` holds (FILTER application)."""
    idx, v, ovf = compact(valid & mask, cap)
    return torch.where(v.unsqueeze(-1), take_rows(rel, idx), 0), v, ovf
