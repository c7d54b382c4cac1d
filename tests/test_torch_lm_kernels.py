"""The LM kernels' plain versions (``repro_torch.kernels.flash_attention``
and ``ssm_scan``, which the wrappers run for CPU tensors) against the
reference: its Pallas kernels in interpret mode, its ``ops`` wrappers, its
oracles (``kernels/ref.py::ssm_scan_ref``, ``models/mamba.py::_scan_chunk``)
and its model attention (``gqa_scores``/``gqa_output``) where the Pallas
kernel rejects the shape (ragged ``S``).  Tolerances are the reference
tests' own: 2e-5 (flash, float32), 2e-2 (flash, bfloat16), 2e-4 (scan)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as ref_ssm  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain  # noqa: E402

F32, BF16 = 2e-5, 2e-2


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S,hd,bq,bk", [(256, 128, 128, 128),
                                        (512, 128, 128, 256),
                                        (256, 256, 128, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128), (False, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_kernel(S, hd, bq, bk, causal, window,
                                           dtype):
    """The reference test's shapes and inputs: q pre-scaled by the caller,
    so the port runs with ``scale=1.0`` on one head per (batch * head)."""
    rng = np.random.default_rng(S + hd + int(causal))
    BH = 2
    jdt = getattr(jnp, dtype)
    q = jnp.asarray(rng.normal(size=(BH, S, hd)), jdt) * hd ** -0.5
    k = jnp.asarray(rng.normal(size=(BH, S, hd)), jdt)
    v = jnp.asarray(rng.normal(size=(BH, S, hd)), jdt)
    want = ref_flash(q, k, v, causal=causal, window=window, block_q=bq,
                     block_k=bk)
    tq, tk, tv = (_t(np.asarray(a, np.float32), getattr(torch, dtype))[:, :, None]
                  for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, window=window, scale=1.0)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    _close(got[:, :, 0], np.asarray(want, np.float32),
           F32 if dtype == "float32" else BF16)


def test_flash_gqa_matches_reference_wrapper():
    """``ops.flash_attention_gqa`` against the reference's wrapper (KV heads
    repeated, then the Pallas kernel) at its own test's shape."""
    rng = np.random.default_rng(1)
    B, S, H, KV, hd = 2, 256, 4, 2, 128
    q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32)
               for h in (H, KV, KV))
    want = ref_ops.flash_attention_gqa(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v))
    before = dict(build.LAUNCHES)
    got = ops.flash_attention_gqa(_t(q), _t(k), _t(v))
    assert build.LAUNCHES == before        # the CPU runs the plain version
    _close(got, want, F32)


def _naive_gqa(q, k, v, causal, window):
    """The reference model's attention math: ``gqa_scores`` and
    ``gqa_output`` around a masked softmax."""
    S = q.shape[1]
    s = ref_layers.gqa_scores(q, k).astype(jnp.float32)
    i = jnp.arange(S)[:, None]
    j = jnp.arange(S)[None, :]
    mask = jnp.zeros((S, S), jnp.float32)
    if causal:
        mask = jnp.where(j > i, ref_layers.NEG_INF, mask)
    if window:
        mask = mask + jnp.where(i - j >= window, ref_layers.NEG_INF, 0.0)
    return ref_layers.gqa_output(jax.nn.softmax(s + mask, -1), v)


@pytest.mark.parametrize("S,H,KV,hd", [(200, 14, 2, 64), (37, 4, 1, 16),
                                       (130, 6, 3, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 50), (False, 0),
                                           (False, 24)])
def test_flash_ragged_and_narrow_match_model_attention(S, H, KV, hd, causal,
                                                       window):
    """Shapes the Pallas kernel rejects (``S % 128 != 0``, ``hd`` 64 or 16)
    against the reference's naive GQA softmax."""
    rng = np.random.default_rng(S * hd + H)
    q, k, v = (rng.normal(size=(2, S, h, hd)).astype(np.float32)
               for h in (H, KV, KV))
    want = _naive_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                      window)
    _close(ops.flash_attention_gqa(_t(q), _t(k), _t(v), causal=causal,
                                   window=window), want, F32)
    wb = _naive_gqa(*(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)
                      for a in (q, k, v)), causal, window)
    got = ops.flash_attention_gqa(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                                  causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    _close(got, wb, BF16)


def test_flash_plain_rejects_bad_arguments():
    q = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="group"):
        flash_attention(q, torch.zeros((1, 8, 2, 16)), torch.zeros((1, 8, 2, 16)))
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="shape"):
        flash_attention_plain(q, q, torch.zeros((1, 9, 3, 16)))


def _scan_inputs(rng, B, S, D, N):
    """The reference test's recipe."""
    dt = np.abs(rng.normal(0.1, 0.05, (B, S, D))).astype(np.float32)
    bt = rng.normal(size=(B, S, N)).astype(np.float32)
    ct = rng.normal(size=(B, S, N)).astype(np.float32)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    a = -np.abs(rng.normal(1.0, 0.3, (D, N))).astype(np.float32)
    return dt, bt, ct, x, a


@pytest.mark.parametrize("B,S,D,N,chunk", [(1, 64, 256, 8, 32),
                                           (2, 128, 256, 16, 64)])
def test_ssm_plain_matches_pallas_kernel_and_oracle(B, S, D, N, chunk):
    args = _scan_inputs(np.random.default_rng(B + S + D + N), B, S, D, N)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(ref_ssm(*jargs, chunk=chunk))
    np.testing.assert_allclose(want, np.asarray(ref_oracles.ssm_scan_ref(*jargs)),
                               rtol=2e-4, atol=2e-4)
    y, _ = ssm_scan(*(_t(a) for a in args))
    _close(y, want, 2e-4)


@pytest.mark.parametrize("B,S,D,N", [(2, 50, 300, 16), (1, 1, 5, 8),
                                     (3, 77, 33, 32), (1, 31, 40, 16),
                                     (1, 65, 70, 17)])
def test_ssm_plain_ragged_and_final_state(B, S, D, N):
    """Ragged shapes against the associative-scan oracle, and the final
    state against ``_scan_chunk``'s ``h[:, -1]`` (its ``y`` carries the
    ``D * x`` skip on top)."""
    args = _scan_inputs(np.random.default_rng(7 * S + D), B, S, D, N)
    dt, bt, ct, x, a = args
    y, h_last = ops.selective_scan(*(_t(v) for v in args))
    assert y.shape == (B, S, D) and h_last.shape == (B, D, N)
    _close(y, ref_oracles.ssm_scan_ref(*(jnp.asarray(v) for v in args)), 2e-4)
    skip = np.random.default_rng(S).normal(size=(D,)).astype(np.float32)
    p = {"A_log": jnp.log(-jnp.asarray(a)), "D": jnp.asarray(skip)}
    y_ref, h_ref = ref_mamba._scan_chunk(p, jnp.asarray(dt), jnp.asarray(bt),
                                         jnp.asarray(ct), jnp.asarray(x),
                                         jnp.zeros((B, D, N), jnp.float32))
    _close(h_last, h_ref, 2e-4)
    _close(y + _t(skip) * _t(x), y_ref, 2e-4)


@pytest.mark.parametrize("dt_mean", [3.0, 0.003])
def test_ssm_plain_strong_and_weak_decay_match_oracle(dt_mean):
    """Large dt (each state forgets within a few steps) and small dt (the
    state carries across the whole sequence): ``y`` against the
    associative-scan oracle and the final state against ``_scan_chunk``."""
    rng = np.random.default_rng(int(dt_mean * 1000))
    B, S, D, N = 2, 131, 64, 16
    args = list(_scan_inputs(rng, B, S, D, N))
    args[0] = np.abs(rng.normal(dt_mean, dt_mean / 3, (B, S, D))).astype(
        np.float32)
    y, h_last = ssm_scan(*(_t(v) for v in args))
    jargs = [jnp.asarray(v) for v in args]
    _close(y, ref_oracles.ssm_scan_ref(*jargs), 2e-4)
    p = {"A_log": jnp.log(-jargs[4]), "D": jnp.zeros((D,), jnp.float32)}
    _, h_ref = ref_mamba._scan_chunk(p, *jargs[:4],
                                     jnp.zeros((B, D, N), jnp.float32))
    _close(h_last, h_ref, 2e-4)


def test_ssm_plain_rejects_bad_arguments():
    x = torch.zeros((1, 8, 4))
    bt = torch.zeros((1, 8, 2))
    with pytest.raises(ValueError, match="shape"):
        ssm_scan(x, bt, bt, x, torch.zeros((4, 3)))
    with pytest.raises(TypeError, match="dtype"):
        ssm_scan_plain(x.double(), bt, bt, x, torch.zeros((4, 2)))


def test_ssm_plain_gives_zero_y_without_state():
    """N = 0: ``y`` is the empty sum over states, zeros, as the reference's
    oracle gives; the wrapper (plain on the CPU) returns the same."""
    B, S, D, N = 2, 5, 7, 0
    args = _scan_inputs(np.random.default_rng(3), B, S, D, N)
    y0, h0 = ssm_scan_plain(*(_t(v) for v in args))
    y, h = ssm_scan(*(_t(v) for v in args))
    assert y.shape == y0.shape == (B, S, D) and h.shape == h0.shape == (B, D, 0)
    assert not y.any() and not y0.any()
    _close(y0, ref_oracles.ssm_scan_ref(*(jnp.asarray(v) for v in args)), 0)
