"""On-device join-order DP: the resident layer sweep and the dense layer tile.

``repro_torch.core.join_order._dp_sweep`` prices, per popcount layer, every
(connected subset, connected partition) candidate pair and keeps the first
strict minimum per subset.  Two device entry points live here, each a
hand-written CUDA kernel (``csrc/``) beside its plain PyTorch version:

``dp_sweep``
    The whole member-batched sweep with the DP state resident on the card:
    ``csrc/dp_sweep.cu`` is one cooperative launch per sweep on the current
    stream, a persistent grid that loops over the layers with a grid
    barrier between them.  Warps walk the layer's work items (runs of at
    most ``ITEM_PAIRS`` pairs of one connected subset's column in the
    topology's column-major pair schedule, ``work_items``) for every member; the
    items of a split column merge their minima on the card.  Only the
    seeds go up and the final ``(cost, strat, split)`` comes back.
    Replaces the reference's ``dp_sweep_resident`` (one ``lax.scan``).

``dp_layer``
    One dense ``(B, R, C)`` layer tile priced and reduced per column:
    ``csrc/dp_layer.cu``, the rows split across threads and across blocks
    of row chunks (``_chunk_rows`` sizes them to fill the card), a
    lexicographic (cost, row) merge of the chunks' minima.  The tiled
    fallback for schedules over the memory budget.  Replaces the
    reference's Pallas ``dp_layer``.

Both price in float64 with the operation association of
``CostModel.join_candidates_v`` (the library is built with ``--fmad=false``
so no multiply-add is contracted) and reproduce the numpy sweep's
enumeration order and first-strict-minimum tie-breaking bit for bit.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  Plain-version calls launch
nothing and are not counted.

What the reference kept only for XLA's compile cache is gone: the bucketed
trace shapes (``_bucket``), the padding copies (``_pad3``/``_pad2``), the
program cache (``_ProgramCache``) and ``dp_layer_program``.  PyTorch runs
eagerly and the kernels take any extent.

The kernels are built, loaded and counted by ``repro_torch.kernels.build``
(nvcc at first use, plain C interface, ``ctypes``; ``build.LAUNCHES``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.build import D, I, P, register
from repro_torch.kernels.build import check as _check
from repro_torch.kernels.build import launch as _launch
from repro_torch.kernels.build import route as _route

_STRAT_EXCL, _STRAT_HASH, _STRAT_BIND = 2, 3, 4   # mirror join_order's codes
_BIG_ROW = 2**31 - 1                              # "no valid pair in this column"

register("dp_sweep", "dp_sweep.cu", "dp_sweep_run", [P] * 18 + [I] * 7 + [D] * 4)
register("dp_layer", "dp_layer.cu", "dp_layer_tile", [P] * 14 + [I] * 4 + [D] * 4)

# Pairs one warp of dp_sweep's kernel prices at most: a column with more
# pairs is cut into work items of this many (the last one shorter), whose
# minima the kernel merges.  Chosen from chip_smoke.py's timings of the
# resident cells over item sizes (`item_pairs_ms`, PERF.md).
ITEM_PAIRS = 256

_BLOCK_COLS = 32          # columns one dp_layer block covers at most
_MAX_CHUNK_ROWS = 4096    # rows one dp_layer block walks at most
_MIN_CHUNK_ROWS = 32


def sm_count(device) -> int:
    """The card's streaming multiprocessors (its
    ``cudaDevAttrMultiProcessorCount``): what ``dp_layer``'s row chunks
    are sized to fill and what ``dp_sweep``'s cooperative grid spans."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


# --------------------------------------------------------------------------
# Resident sweep
# --------------------------------------------------------------------------

def work_items(layer_cols: np.ndarray, col_ptr: np.ndarray, size: int,
               k: int = ITEM_PAIRS) -> "tuple[np.ndarray, np.ndarray]":
    """``dp_sweep``'s work list for one schedule: each real column's pair
    run ``[col_ptr[l, c], col_ptr[l, c + 1])`` cut, in order, into items of
    ``k`` pairs (the last one shorter; an empty run is one empty item).
    Returns ``items (N, 4)`` int32 rows ``(column, lo, hi, first)`` grouped
    by layer, layer ``l``'s at ``[item_ptr[l], item_ptr[l + 1])``;
    ``first`` is -1 for a column of one item and otherwise the index of the
    column's first item, where the kernel counts the column's arrivals."""
    rows, ptr = [], [0]
    for li in range(layer_cols.shape[0]):
        cols = np.flatnonzero(layer_cols[li] < size)
        lo = col_ptr[li, cols].astype(np.int64)
        hi = col_ptr[li, cols + 1].astype(np.int64)
        parts = np.maximum(1, -(-(hi - lo) // k))
        start = np.cumsum(parts) - parts            # column's first item
        of = np.repeat(np.arange(len(cols)), parts)
        i_lo = lo[of] + (np.arange(len(of)) - start[of]) * k
        first = np.where(parts[of] > 1, ptr[-1] + start[of], -1)
        rows.append(np.stack([cols[of], i_lo, np.minimum(i_lo + k, hi[of]),
                              first], axis=1))
        ptr.append(ptr[-1] + len(of))
    items = (np.concatenate(rows) if rows else np.empty((0, 4)))
    return items.astype(np.int32), np.array(ptr, np.int32)


def dp_sweep(params, pair_a, pair_b, layer_cols, col_ptr, card,
             excl_cost, excl_w, cost0, n_src0, src_w0, *, items, item_ptr):
    """Run the whole member-batched DP sweep with the state on the device.

    Schedule (int32): ``pair_a``/``pair_b`` ``(L, P)`` are the flat
    candidate pairs of each layer, column-major in the reference
    enumeration order; ``layer_cols`` ``(L, C)`` the layer's connected
    subsets (sentinel ``2^n``); ``col_ptr`` ``(L, C + 1)`` each column's run
    ``[col_ptr[l, c], col_ptr[l, c + 1])`` of pairs (positions from
    ``col_ptr[l, C]`` on are padding); ``items`` ``(N, 4)`` the kernel's
    work list ``(column, lo, hi, first)`` of ``work_items``, layer ``l``'s
    items at ``[item_ptr[l], item_ptr[l + 1])`` (only the kernel reads it).
    State (float64, ``(B, 2^n)``): subset cardinalities, the exclusive-leaf
    seeds (``excl_cost = inf`` where none) and the singleton seeds
    (``n_src0 > 0`` is the bindable plane).  ``params`` is the cost model's
    ``(intermediate_weight, transfer_weight, request_cost, bind_batch)``.

    Returns tensors on the inputs' device: ``cost (B, 2^n)`` float64,
    ``strat`` and ``split`` int32 (strategy codes of ``join_order``; strat
    0 == never written; split == the winning submask A)."""
    import torch

    dev = cost0.device
    L, P = pair_a.shape
    C = layer_cols.shape[1]
    B, size = cost0.shape
    for nm, t in (("pair_a", pair_a), ("pair_b", pair_b)):
        _check(nm, t, torch.int32, (L, P), dev)
    _check("layer_cols", layer_cols, torch.int32, (L, C), dev)
    _check("col_ptr", col_ptr, torch.int32, (L, C + 1), dev)
    N = items.shape[0]
    _check("items", items, torch.int32, (N, 4), dev)
    _check("item_ptr", item_ptr, torch.int32, (L + 1,), dev)
    for nm, t in (("card", card), ("excl_cost", excl_cost),
                  ("excl_w", excl_w), ("cost0", cost0), ("n_src0", n_src0),
                  ("src_w0", src_w0)):
        _check(nm, t, torch.float64, (B, size), dev)
    if _route(dev) == "plain":
        return dp_sweep_plain(params, pair_a, pair_b, layer_cols, col_ptr,
                              card, excl_cost, excl_w, cost0, n_src0, src_w0)
    if items.data_ptr() % 16:
        raise ValueError("items: not 16-byte aligned")

    iw, tw, rc, bb = (float(v) for v in params)
    # the kernel fills every output itself (seeds copied, winners cleared)
    # and its working state, one (cost, card, n_src, src_w) record per
    # (member, mask)
    state = torch.empty((B, size, 4), dtype=torch.float64, device=dev)
    cost = torch.empty((B, size), dtype=torch.float64, device=dev)
    strat, split = (torch.empty((B, size), dtype=torch.int32, device=dev)
                    for _ in range(2))
    # per (member, item): a split column's partial (cost, position,
    # is_bind) and, at its first item, the column's arrival counter
    part = torch.empty((B * N, 2), dtype=torch.int64, device=dev)
    arrived = torch.empty(B * N, dtype=torch.int32, device=dev)
    _launch("dp_sweep", pair_a.data_ptr(), pair_b.data_ptr(),
            col_ptr.data_ptr(), layer_cols.data_ptr(), items.data_ptr(),
            item_ptr.data_ptr(), card.data_ptr(), excl_cost.data_ptr(),
            excl_w.data_ptr(), cost0.data_ptr(), n_src0.data_ptr(),
            src_w0.data_ptr(), state.data_ptr(), cost.data_ptr(),
            strat.data_ptr(), split.data_ptr(),
            part.data_ptr(), arrived.data_ptr(), L, B, size, P, C, N,
            sm_count(dev), iw, tw, rc, bb)
    return cost, strat, split


def dp_sweep_plain(params, pair_a, pair_b, layer_cols, col_ptr, card,
                   excl_cost, excl_w, cost0, n_src0, src_w0):
    """Plain PyTorch version of ``dp_sweep`` (same arguments): a loop over
    layers with gathers, a segmented first-strict-minimum through
    ``scatter_reduce`` (costs, then the flat positions attaining them) and
    the state scatter.  Each pair's column comes from ``col_ptr``; padding
    pairs get column ``C``.  Scatter targets are one column wider (``C + 1``
    / ``2^n + 1``) so padded pairs and columns land in a column that is
    sliced off."""
    import torch

    from repro_torch.core.cost import CostModel

    dev = cost0.device
    f64 = torch.float64
    B, size = cost0.shape
    L, P = pair_a.shape
    C = layer_cols.shape[1]
    big = torch.iinfo(torch.int64).max

    def widen(x, fill):
        return torch.cat([x, torch.full((B, 1), fill, dtype=x.dtype,
                                        device=dev)], dim=1)

    cost = widen(cost0.clone(), float("inf"))
    n_src = widen(n_src0.clone(), 0.0)
    src_w = widen(src_w0.clone(), 1.0)
    strat = torch.zeros((B, size + 1), dtype=torch.int32, device=dev)
    split = torch.zeros((B, size + 1), dtype=torch.int32, device=dev)
    pos = torch.arange(P, dtype=torch.int64, device=dev)
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    for layer in range(L):
        a = pair_a[layer].long()
        b = pair_b[layer].long()
        seg = torch.searchsorted(col_ptr[layer, 1:].long(), pos, right=True)
        cols = layer_cols[layer].long()
        pad_pair = seg >= C
        pad_col = cols >= size
        a_g = torch.where(pad_pair, 0, a)
        b_g = torch.where(pad_pair, 0, b)
        cols_g = torch.where(pad_col, 0, cols)

        ns_b = n_src[:, b_g]
        pair_c, is_bind = CostModel.join_candidates_params_torch(
            params, cost[:, a_g], cost[:, b_g],
            card[:, torch.where(pad_pair, 0, a ^ b)], card[:, a_g], ns_b,
            src_w[:, b_g], ns_b > 0)
        pair_c = torch.where(pad_pair[None, :], inf, pair_c)

        seg_b = seg[None, :].expand(B, P)
        seg_min = torch.full((B, C + 1), float("inf"), dtype=f64,
                             device=dev).scatter_reduce(
            1, seg_b, pair_c, reduce="amin", include_self=True)
        elig = (pair_c == seg_min.gather(1, seg_b)) & torch.isfinite(pair_c)
        first = torch.full((B, C + 1), big, dtype=torch.int64,
                           device=dev).scatter_reduce(
            1, seg_b, torch.where(elig, pos[None, :], big), reduce="amin",
            include_self=True)
        seg_min = seg_min[:, :C]
        fp = torch.clamp_max(first[:, :C], P - 1)
        split_a = a[fp]                                   # (B, C)
        bind_at = is_bind.gather(1, fp)

        ec = torch.where(pad_col[None, :], inf, excl_cost[:, cols_g])
        ew = excl_w[:, cols_g]
        pair_win = seg_min < ec
        has_excl = torch.isfinite(ec)
        is_excl = has_excl & ~pair_win
        cost[:, cols] = torch.where(pair_win, seg_min, ec)
        n_src[:, cols] = is_excl.to(f64)
        src_w[:, cols] = torch.where(is_excl, ew, 1.0)
        strat[:, cols] = torch.where(
            pair_win, torch.where(bind_at, _STRAT_BIND, _STRAT_HASH),
            torch.where(has_excl, _STRAT_EXCL, 0)).to(torch.int32)
        split[:, cols] = torch.where(pair_win, split_a, 0).to(torch.int32)
    return (cost[:, :size].contiguous(), strat[:, :size].contiguous(),
            split[:, :size].contiguous())


# --------------------------------------------------------------------------
# Dense layer tile
# --------------------------------------------------------------------------

def dp_layer(cost_a, cost_b, card_a, n_src_b, src_w_b, bindable, valid,
             card_s, params):
    """Price one dense layer tile and reduce it per column.

    ``cost_a``/``cost_b``/``card_a``/``n_src_b``/``src_w_b`` are ``(B, R, C)``
    float64 per-pair gathers (member, relative submask row, connected-subset
    column), ``bindable`` ``(B, R, C)`` int8, ``valid`` the ``(R, C)`` int8
    connectivity mask, ``card_s`` the ``(B, C)`` float64 subset
    cardinalities.  Returns ``(best (B, C) float64, first_row (B, C) int32,
    is_bind (B, C) uint8)``: the first strict minimum over the valid rows
    (``inf``/``2^31 - 1``/0 where no valid pair has a finite cost)."""
    import torch

    dev = cost_a.device
    B, R, C = cost_a.shape
    for nm, t in (("cost_a", cost_a), ("cost_b", cost_b), ("card_a", card_a),
                  ("n_src_b", n_src_b), ("src_w_b", src_w_b)):
        _check(nm, t, torch.float64, (B, R, C), dev)
    _check("bindable", bindable, torch.int8, (B, R, C), dev)
    _check("valid", valid, torch.int8, (R, C), dev)
    _check("card_s", card_s, torch.float64, (B, C), dev)
    if _route(dev) == "plain":
        return dp_layer_plain(cost_a, cost_b, card_a, n_src_b, src_w_b,
                              bindable, valid, card_s, params)

    iw, tw, rc, bb = (float(v) for v in params)
    best = torch.empty((B, C), dtype=torch.float64, device=dev)
    row = torch.empty((B, C), dtype=torch.int32, device=dev)
    bind = torch.empty((B, C), dtype=torch.uint8, device=dev)
    chunk = _chunk_rows(B, R, C, sm_count(dev))
    n_chunks = -(-R // chunk) if R else 1
    # per-chunk minima, merged by a second kernel when R spans chunks
    n_part = B * C * n_chunks if n_chunks > 1 else 0
    part = [torch.empty(n_part, dtype=t, device=dev)
            for t in (torch.float64, torch.int32, torch.uint8)]
    _launch("dp_layer", cost_a.data_ptr(), cost_b.data_ptr(),
            card_a.data_ptr(), n_src_b.data_ptr(), src_w_b.data_ptr(),
            bindable.data_ptr(), valid.data_ptr(), card_s.data_ptr(),
            best.data_ptr(), row.data_ptr(), bind.data_ptr(),
            *(p.data_ptr() for p in part), B, R, C, chunk, iw, tw, rc, bb)
    return best, row, bind


def _chunk_rows(B: int, R: int, C: int, sms: int) -> int:
    """Rows one ``dp_layer`` block walks: at most ``_MAX_CHUNK_ROWS``, halved
    (down to ``_MIN_CHUNK_ROWS``) until the grid of (member x column group,
    row chunk) blocks covers the card's ``sms`` SMs at least twice."""
    groups = B * -(-C // _BLOCK_COLS)
    chunk = _MAX_CHUNK_ROWS
    while chunk > _MIN_CHUNK_ROWS and groups * -(-R // chunk) < 2 * sms:
        chunk //= 2
    return max(chunk, -(-R // 65535))       # the grid's y extent


def dp_layer_plain(cost_a, cost_b, card_a, n_src_b, src_w_b, bindable, valid,
                   card_s, params):
    """Plain PyTorch version of ``dp_layer`` (same inputs and outputs)."""
    import torch

    from repro_torch.core.cost import CostModel

    B, R, C = cost_a.shape
    dev = cost_a.device
    pair_c, is_bind = CostModel.join_candidates_params_torch(
        params, cost_a, cost_b, card_s[:, None, :], card_a, n_src_b, src_w_b,
        bindable != 0)
    ok = (valid != 0)[None, :, :]
    pair = torch.where(ok, pair_c, float("inf"))
    if R == 0:
        best = torch.full((B, C), float("inf"), dtype=torch.float64,
                          device=dev)
    else:
        best = pair.amin(dim=1)
    rows = torch.arange(R, dtype=torch.int64, device=dev)[None, :, None]
    is_min = (ok & (pair == best[:, None, :])
              & torch.isfinite(best)[:, None, :])
    first = torch.where(is_min, rows, _BIG_ROW)
    first = (first.amin(dim=1) if R else
             torch.full((B, C), _BIG_ROW, dtype=torch.int64, device=dev))
    bind = (is_min & (rows == first[:, None, :]) & is_bind).any(dim=1)
    return best, first.to(torch.int32), bind.to(torch.uint8)


def as_numpy(*ts) -> "tuple[np.ndarray, ...]":
    """Copy device results back to host numpy arrays."""
    return tuple(t.cpu().numpy() for t in ts)
