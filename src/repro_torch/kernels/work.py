"""The work each LM kernel does: its operations and the bytes it must move.

One count, read by two callers: ``chip_smoke.py``, which turns it into a
kernel's bound on the card, and the dry-run's op-trace analyzer
(``launch/roofline.py``), which books each kernel as one op carrying this
work, never the plain version's.  A byte count takes each input read once
and each output written once; operation counts take only what these inputs
need (the causal mask's visible pairs, not the whole square).

* ``flops`` -- for flash attention the tensor-core operations (two per
  multiply-add), for the selective scan its FP32-pipe instructions;
* ``bytes`` -- device-memory traffic at ``itemsize`` bytes an element for
  the inputs and outputs of the call's type, 4 for its float32 extras
  (``lse``, the scan's tensors);
* ``exps`` -- exponentials (the scan's, one per state update).
"""
from __future__ import annotations

from typing import NamedTuple


class Work(NamedTuple):
    flops: int
    bytes: int
    exps: int = 0


def visible_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """(query, key) pairs of an ``S``-token attention that the mask leaves
    visible: causal drops keys after the query, a window drops keys
    ``window`` or more behind it."""
    if not window or window >= S:
        return S * (S + 1) // 2 if causal else S * S
    # queries 0..window-1 see every earlier key, the rest ``window`` of them
    behind = window * (window + 1) // 2 + (S - window) * window
    # non-causal: the keys after each query too
    return behind if causal else behind + S * (S - 1) // 2


def flash_attention(B: int, S: int, H: int, KV: int, hd: int, *,
                    causal: bool = True, window: int = 0, itemsize: int = 4,
                    with_lse: bool = False) -> Work:
    """The forward kernel: QK^T and PV over the visible pairs; q, k, v
    read and o written (``lse``, float32, written too in training)."""
    ops = 4 * B * H * hd * visible_pairs(S, causal, window)
    nbytes = itemsize * B * S * hd * (2 * H + 2 * KV)
    if with_lse:
        nbytes += 4 * B * H * S
    return Work(ops, nbytes)


def flash_attention_bwd(B: int, S: int, H: int, KV: int, hd: int, *,
                        causal: bool = True, window: int = 0,
                        itemsize: int = 4) -> Work:
    """The backward kernel: S and dO V^T recomputed, then dV, dQ and dK --
    five products over the visible pairs; q, out, dout read and dq written
    (B, S, H, hd), k, v read and dk, dv written (B, S, KV, hd), lse read."""
    ops = 10 * B * H * hd * visible_pairs(S, causal, window)
    nbytes = itemsize * B * S * hd * (4 * H + 4 * KV) + 4 * B * H * S
    return Work(ops, nbytes)


def n_chunks(S: int, chunk: int = 16) -> int:
    return -(-S // chunk)


def ssm_scan(B: int, S: int, D: int, N: int, *, keep_chunks: int = 0) -> Work:
    """The forward scan: dt, x read and y written (B, S, D); bt, ct read
    (B, S, N); a read (D, N); the final state written (B, D, N), and with
    ``keep_chunks`` that many states of every row kept for the backward.
    FP32-pipe instructions per (b, t, d, n): dt * a, dtx * B, the update's
    multiply-add and y's; per (b, t, d): dt * x; one exponential per
    (b, t, d, n)."""
    nbytes = 4 * (3 * B * S * D + 2 * B * S * N + D * N + B * D * N
                  + B * keep_chunks * D * N)
    return Work(B * S * D * (4 * N + 1), nbytes, B * S * D * N)


def ssm_scan_bwd(B: int, S: int, D: int, N: int, *, n_chunk: int,
                 dh_last: bool = False) -> Work:
    """The backward scan: dt, x, dy read and ddt, dx written (B, S, D); bt,
    ct read and their gradients written (B, S, N); a read and da written
    (D, N); the ``n_chunk`` kept states read (B, n_chunk, D, N), and
    ``dh_last`` (B, D, N) when given.  FP32-pipe instructions per (b, t, d,
    n): the state's recomputation (3), the reverse step (11) and the sums
    over d of dB and dC (2); one exponential, kept from the
    recomputation."""
    nbytes = 4 * (5 * B * S * D + 4 * B * S * N + 2 * D * N
                  + B * n_chunk * D * N + (B * D * N if dh_last else 0))
    return Work(B * S * D * N * 16, nbytes, B * S * D * N)
