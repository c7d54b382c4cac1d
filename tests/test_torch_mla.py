"""The port's MLA (``repro_torch.models.mla``) against the reference's
``repro.models.mla`` on the CPU, function by function, on the same weights
(the reference's ``init_mla`` draws with its two norms perturbed, carried
across as numpy) and numpy-seeded inputs: ``init_mla``'s shapes,
``_mla_qkv``, ``_mla_attend``, ``mla_attention``, ``mla_prefill``,
``mla_decode`` with ``PerfFlags.mla_absorb`` off and on (each against the
reference's same branch, shared and per-slot positions) and
``_mla_attend_absorbed``.  float32; the tolerance is 1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import PerfFlags as RefPerfFlags  # noqa: E402
from repro.config.base import reduced_config as ref_reduced  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import mla as RMLA  # noqa: E402
from repro_torch.config.base import PerfFlags, reduced_config  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402

TOL = 1e-4
ARCH = "deepseek-v2-236b"


@pytest.fixture(scope="module")
def mla():
    cfg, rcfg = reduced_config(get_arch(ARCH)), ref_reduced(ref_get_arch(ARCH))
    tree = jax.tree.map(np.asarray, RMLA.init_mla(
        rcfg, jax.random.PRNGKey(11), jnp.float32))
    rng = np.random.default_rng(11)
    for k in ("q_norm", "kv_norm"):
        tree[k] = (tree[k] + 0.1 * rng.normal(size=tree[k].shape)
                   ).astype(np.float32)
    params = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return cfg, rcfg, jax.tree.map(jnp.asarray, tree), params, rng


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _x(rng, B, S, d):
    return rng.normal(size=(B, S, d)).astype(np.float32)


def test_init_mla_shapes_match_reference(mla):
    cfg, rcfg, rp, _, _ = mla
    own = MLA.init_mla(cfg, torch.Generator().manual_seed(0), torch.float32,
                       "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in rp.items()}


def test_mla_qkv_matches_reference(mla):
    cfg, rcfg, rp, p, rng = mla
    x = _x(rng, 2, 9, cfg.d_model)
    pos = np.arange(9)[None, :] + np.array([[0], [5]])
    got = MLA._mla_qkv(p, cfg, _t(x), torch.from_numpy(pos))
    want = RMLA._mla_qkv(rp, rcfg, jnp.asarray(x), jnp.asarray(pos))
    assert got[3].shape == (2, 9, 1, cfg.mla.rope_dim)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        _close(a, b)


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_attend_matches_reference(mla, absorbed):
    """``_mla_attend`` and ``_mla_attend_absorbed`` on the same queries,
    latents and rope keys, with a causal mask."""
    cfg, rcfg, rp, p, rng = mla
    m = cfg.mla
    B, S = 2, 7
    q_nope = rng.normal(size=(B, S, cfg.n_heads, m.nope_dim)).astype(np.float32)
    q_rope = rng.normal(size=(B, S, cfg.n_heads, m.rope_dim)).astype(np.float32)
    latent = rng.normal(size=(B, S, m.kv_lora)).astype(np.float32)
    k_rope = rng.normal(size=(B, S, 1, m.rope_dim)).astype(np.float32)
    mask = np.where(np.arange(S)[None, :] > np.arange(S)[:, None], -1e9,
                    0.0).astype(np.float32)
    fn, rfn = ((MLA._mla_attend_absorbed, RMLA._mla_attend_absorbed)
               if absorbed else (MLA._mla_attend, RMLA._mla_attend))
    got = fn(p, cfg, _t(q_nope), _t(q_rope), _t(latent), _t(k_rope),
             _t(mask))
    want = rfn(rp, rcfg, *(jnp.asarray(a) for a in
                           (q_nope, q_rope, latent, k_rope, mask)))
    _close(got, want)


def test_mla_attention_and_prefill_match_reference(mla):
    cfg, rcfg, rp, p, rng = mla
    x = _x(rng, 2, 13, cfg.d_model)
    _close(MLA.mla_attention(p, cfg, _t(x)),
           RMLA.mla_attention(rp, rcfg, jnp.asarray(x)))
    pos = np.arange(13)[None, :] + 3
    got = MLA.mla_prefill(p, cfg, _t(x), torch.from_numpy(pos))
    want = RMLA.mla_prefill(rp, rcfg, jnp.asarray(x), jnp.asarray(pos))
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        _close(a, b)


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_decode_matches_reference(mla, absorb):
    """Decode steps from a prefilled cache, each branch of
    ``PerfFlags.mla_absorb`` against the reference's same branch; per-slot
    then shared positions; the caches after each step."""
    cfg, rcfg, rp, p, rng = mla
    cfg = dataclasses.replace(cfg, perf=PerfFlags(mla_absorb=absorb))
    rcfg = dataclasses.replace(rcfg, perf=RefPerfFlags(mla_absorb=absorb))
    m = cfg.mla
    T, S_ctx = 9, 16
    x = _x(rng, 2, T, cfg.d_model)
    _, lat, kr = RMLA.mla_prefill(rp, rcfg, jnp.asarray(x))
    latent = np.zeros((2, S_ctx, m.kv_lora), np.float32)
    krope = np.zeros((2, S_ctx, 1, m.rope_dim), np.float32)
    latent[:, :T], krope[:, :T] = np.asarray(lat), np.asarray(kr)
    cache = {"latent": _t(latent), "k_rope": _t(krope)}
    rcache = {"latent": jnp.asarray(latent), "k_rope": jnp.asarray(krope)}
    step = jax.jit(lambda c, xx, pos: RMLA.mla_decode(rp, rcfg, xx, c, pos))
    for pos in (np.array([T, T - 4], np.int32), np.array([T + 1, T - 3],
                                                         np.int32),
                np.int32(T + 2)):
        x1 = _x(rng, 2, 1, cfg.d_model)
        got, cache = MLA.mla_decode(p, cfg, _t(x1), cache,
                                    torch.from_numpy(np.array(pos)))
        want, rcache = step(rcache, jnp.asarray(x1), jnp.asarray(pos))
        _close(got, want)
        for k in ("latent", "k_rope"):
            _close(cache[k], rcache[k])


def test_absorbed_decode_equals_expanded(mla):
    """The absorption is exact algebra: both branches agree within
    ``TOL`` on the same cache."""
    cfg, _, _, p, rng = mla
    m = cfg.mla
    outs = []
    for absorb in (False, True):
        c = dataclasses.replace(cfg, perf=PerfFlags(mla_absorb=absorb))
        r = np.random.default_rng(3)
        cache = {"latent": _t(r.normal(size=(2, 12, m.kv_lora))),
                 "k_rope": _t(r.normal(size=(2, 12, 1, m.rope_dim)))}
        out, _ = MLA.mla_decode(p, c, _t(_x(r, 2, 1, cfg.d_model)), cache,
                                torch.tensor([7, 11]))
        outs.append(out)
    _close(outs[1], outs[0].numpy())
