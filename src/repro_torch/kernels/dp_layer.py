"""On-device join-order DP: the resident layer sweep and the dense layer tile.

``repro_torch.core.join_order._dp_sweep`` prices, per popcount layer, every
(connected subset, connected partition) candidate pair and keeps the first
strict minimum per subset.  Two device entry points live here, each a
hand-written CUDA kernel (``csrc/``) beside its plain PyTorch version:

``dp_sweep``
    The whole member-batched sweep with the DP state resident on the card:
    ``csrc/dp_sweep.cu`` runs once per layer (``L = n - 1`` launches on the
    current stream), one warp per (member, connected subset) over the
    subset's contiguous run of the topology's column-major pair schedule.
    Only the seeds go up and the final ``(cost, strat, split)`` comes back.
    Replaces the reference's ``dp_sweep_resident`` (one ``lax.scan``).

``dp_layer``
    One dense ``(B, R, C)`` layer tile priced and reduced per column:
    ``csrc/dp_layer.cu``, one thread per (member, column) walking the rows
    in order.  The tiled fallback for schedules over the memory budget.
    Replaces the reference's Pallas ``dp_layer``.

Both price in float64 with the operation association of
``CostModel.join_candidates_v`` (the library is built with ``--fmad=false``
so no multiply-add is contracted) and reproduce the numpy sweep's
enumeration order and first-strict-minimum tie-breaking bit for bit.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches (plain-version calls do not count).

What the reference kept only for XLA's compile cache is gone: the bucketed
trace shapes (``_bucket``), the padding copies (``_pad3``/``_pad2``), the
program cache (``_ProgramCache``) and ``dp_layer_program``.  PyTorch runs
eagerly and the kernels take any extent.

The kernels are compiled at first use with ``nvcc`` into shared libraries
with a plain C interface (loaded with ``ctypes``), under ``build/kernels/``
at the repository root, keyed by a hash of the source and the flags.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_STRAT_EXCL, _STRAT_HASH, _STRAT_BIND = 2, 3, 4   # mirror join_order's codes
_BIG_ROW = 2**31 - 1                              # "no valid pair in this column"

# kernel launches per wrapper (plain-version calls are not counted)
LAUNCHES = {"dp_sweep": 0, "dp_layer": 0}

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO_ROOT = Path(__file__).resolve().parents[3]
SOURCES = {"dp_sweep": "dp_sweep.cu", "dp_layer": "dp_layer.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "dp_sweep": ("dp_sweep_layer", [_P] * 12 + [_I] * 5 + [_D] * 4 + [_P]),
    "dp_layer": ("dp_layer_tile", [_P] * 11 + [_I] * 3 + [_D] * 4 + [_P]),
}
_LIBS: dict = {}
BUILD_LOG: dict = {}      # nvcc's stderr per kernel (ptxas register report)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    return _REPO_ROOT / "build" / "kernels"


def _lib_path(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{key}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.environ.get("NVCC")]
    if CUDA_HOME:
        cand.append(str(Path(CUDA_HOME) / "bin" / "nvcc"))
    cand.append(shutil.which("nvcc"))
    for c in cand:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME): the CUDA "
                       "kernels cannot be built")


def build_kernels(names: "tuple[str, ...]" = tuple(SOURCES)) -> "list[str]":
    """Compile every kernel library that is not built yet: one ``nvcc`` per
    source, all started together.  Returns the names it compiled."""
    jobs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    failed = []
    for name, out, tmp, proc in jobs:
        _, err = proc.communicate()
        BUILD_LOG[name] = err.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{BUILD_LOG[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return [j[0] for j in jobs]


def _lib(name: str):
    fn = _LIBS.get(name)
    if fn is None:
        build_kernels((name,))
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(_lib_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return fn


def _check(name: str, t, dtype, shape: tuple, device) -> None:
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _route(device) -> str:
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "kernel"
    raise ValueError(f"no dp kernel for device {device}")


def _launch(name: str, *args) -> None:
    import torch

    rc = _lib(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


# --------------------------------------------------------------------------
# Resident sweep
# --------------------------------------------------------------------------

def dp_sweep(params, pair_a, pair_b, layer_cols, col_ptr, card,
             excl_cost, excl_w, cost0, n_src0, src_w0):
    """Run the whole member-batched DP sweep with the state on the device.

    Schedule (int32): ``pair_a``/``pair_b`` ``(L, P)`` are the flat
    candidate pairs of each layer, column-major in the reference
    enumeration order; ``layer_cols`` ``(L, C)`` the layer's connected
    subsets (sentinel ``2^n``); ``col_ptr`` ``(L, C + 1)`` each column's run
    ``[col_ptr[l, c], col_ptr[l, c + 1])`` of pairs (positions from
    ``col_ptr[l, C]`` on are padding).
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
    for nm, t in (("card", card), ("excl_cost", excl_cost),
                  ("excl_w", excl_w), ("cost0", cost0), ("n_src0", n_src0),
                  ("src_w0", src_w0)):
        _check(nm, t, torch.float64, (B, size), dev)
    if _route(dev) == "plain":
        return dp_sweep_plain(params, pair_a, pair_b, layer_cols, col_ptr,
                              card, excl_cost, excl_w, cost0, n_src0, src_w0)

    iw, tw, rc, bb = (float(v) for v in params)
    cost = cost0.clone()
    n_src = n_src0.clone()
    src_w = src_w0.clone()
    strat = torch.zeros((B, size), dtype=torch.int32, device=dev)
    split = torch.zeros((B, size), dtype=torch.int32, device=dev)
    for layer in range(L):
        _launch("dp_sweep", pair_a.data_ptr(), pair_b.data_ptr(),
                col_ptr.data_ptr(), layer_cols.data_ptr(), card.data_ptr(),
                excl_cost.data_ptr(), excl_w.data_ptr(), cost.data_ptr(),
                n_src.data_ptr(), src_w.data_ptr(), strat.data_ptr(),
                split.data_ptr(), layer, B, size, P, C, iw, tw, rc, bb)
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
    _launch("dp_layer", cost_a.data_ptr(), cost_b.data_ptr(),
            card_a.data_ptr(), n_src_b.data_ptr(), src_w_b.data_ptr(),
            bindable.data_ptr(), valid.data_ptr(), card_s.data_ptr(),
            best.data_ptr(), row.data_ptr(), bind.data_ptr(), B, R, C,
            iw, tw, rc, bb)
    return best, row, bind


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
