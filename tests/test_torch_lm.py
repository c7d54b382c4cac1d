"""The port's LM (``repro_torch.models``) against the reference package on
the CPU, on the same weights: the reference's params are drawn from one
seed, their 1-D leaves (norms, biases, ``A_log``, ``D``) perturbed with
numpy noise so that every term counts, and carried across with
``params_from_jax``.  Layers, prefill (logits and every cache), decode
steps (shared and per-slot positions) and full-sequence logits for every
configuration of the zoo, reduced: dense GQA (QKV bias, qk-norm, local
windows, tied embeddings), Mamba-1, MoE (with shared experts and a dense
prelude layer, or every other layer), MLA, the enc-dec path (whisper: the
encoder's states in the decode caches, ``frames`` in the forward) and the
VLM prefix (chameleon: ``patch_embeds``); and the int8 KV cache.
Everything is float32; the tolerance is 1e-4 (the two packages sum in
different orders)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import PerfFlags as RefPerfFlags  # noqa: E402
from repro.config.base import reduced_config as ref_reduced  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import mamba as RM  # noqa: E402
from repro.models import model as RMDL  # noqa: E402
from repro_torch.config.base import PerfFlags, reduced_config  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models import model as MDL  # noqa: E402
from repro_torch.models.convert import (caches_from_jax,  # noqa: E402
                                        params_from_jax, params_to_jax)

TOL = 1e-4
ARCHS = list(ARCH_IDS)


@functools.lru_cache(maxsize=None)
def ref_fns(rcfg):
    """The reference's prefill, decode step and forward for ``rcfg``, each
    jitted once (eager JAX dispatch is slower than one compile)."""
    return (jax.jit(lambda p, t, s: RMDL.prefill_with_caches(rcfg, p, t, s),
                    static_argnums=2),
            jax.jit(lambda p, c, t, pos: RMDL.decode_step(rcfg, p, c, t, pos)),
            jax.jit(lambda p, b: RMDL.forward(rcfg, p, b)))


def perturbed_params(arch: str, seed: int = 0):
    """(port cfg, reference cfg, numpy param tree, reference params, port
    params) from one seed."""
    rcfg = ref_reduced(ref_get_arch(arch))
    cfg = reduced_config(get_arch(arch))
    tree = jax.tree.map(np.asarray, RMDL.init_params(
        rcfg, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)

    def noisy(a, ndim):         # a per-layer vector (stacked: (n_groups, w))
        if a.ndim == ndim:
            a = a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        return np.asarray(a, np.float32)

    if "groups" in tree:
        tree["groups"] = jax.tree.map(lambda a: noisy(a, 2), tree["groups"])
    tree["final_norm"] = noisy(tree["final_norm"], 1)
    for k in sorted(tree):
        if k.startswith("prelude_") or k == "encdec":
            tree[k] = jax.tree.map(lambda a: noisy(a, 1), tree[k])
    return cfg, rcfg, tree, jax.tree.map(jnp.asarray, tree), \
        params_from_jax(cfg, tree, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return (request.param,) + perturbed_params(request.param)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _layer(tree, li, pat=1):
    g, s = divmod(li, pat)
    return jax.tree.map(lambda a: jnp.asarray(a[g]), tree["groups"][f"slot_{s}"])


def test_configs_are_the_references():
    from repro.configs import ARCH_IDS as ref_ids

    assert ARCH_IDS == ref_ids
    for arch in ARCH_IDS:
        a, b = get_arch(arch), ref_get_arch(arch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), arch
        assert a.param_count() == b.param_count()
        assert dataclasses.asdict(reduced_config(a)) == \
            dataclasses.asdict(ref_reduced(b))
    assert get_arch("qwen2-0.5b").param_count() == 494_004_224
    assert get_arch("falcon-mamba-7b").param_count() == 7_271_350_272


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    _close(L.rmsnorm(_t(x), _t(w), 1e-6), RL.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    pos = np.arange(9)[None, :] + np.array([[0], [40]])
    _close(L.rope(_t(x), torch.from_numpy(pos), 1e6),
           RL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    _close(L.rope(_t(x), torch.arange(9)[None], 1e4),
           RL.rope(jnp.asarray(x), jnp.arange(9)[None], 1e4))


def test_rope_takes_cos_and_sin_exact_without_vector_math():
    """F2 (ROADMAP queue 3): on the CPU ``torch.cos`` / ``torch.sin`` go to
    MKL's vector math, whose first call in a process now and then returns
    float32 values up to 1.5e-4 off; that moved the CPU side of the card
    prefill test.  ``rope`` takes its rotation from ``torch.polar`` instead:
    it calls neither, and its output equals the rotation computed in
    float64 and rounded once, to float32 rounding, at the test's 150
    positions and past them."""
    from torch.overrides import TorchFunctionMode

    class Calls(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.names.append(getattr(func, "__name__", str(func)))
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 300, 2, 64)).astype(np.float32)
    pos = np.arange(300)[None, :]
    with Calls() as calls:
        got = L.rope(_t(x), torch.from_numpy(pos), 1e6).numpy()
    assert "polar" in calls.names
    assert not {"cos", "sin", "cos_", "sin_"} & set(calls.names)
    half = 32
    freqs = 1e6 ** (-torch.arange(0, half, dtype=torch.float32) / half)
    ang = (torch.from_numpy(pos)[..., None].float() * freqs).double().numpy()
    cos = np.cos(ang)[..., None, :].astype(np.float32).astype(np.float64)
    sin = np.sin(ang)[..., None, :].astype(np.float32).astype(np.float64)
    x64 = x.astype(np.float64)
    x1, x2 = x64[..., :half], x64[..., half:]
    want = np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


def test_attention_layers_match_reference():
    arch = "qwen2-0.5b"
    cfg, rcfg, tree, _, params = perturbed_params(arch, seed=1)
    lp, rlp = params["layers"][1]["mixer"], _layer(tree, 1)["mixer"]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 13, cfg.d_model)).astype(np.float32)
    out, k, v = L.attention_prefill(lp, cfg, _t(x), local=False)
    rout, rk, rv = RL.attention_prefill(rlp, rcfg, jnp.asarray(x), local=False)
    for a, b in ((out, rout), (k, rk), (v, rv)):
        _close(a, b)
    _close(L.attention(lp, cfg, _t(x), local=False),
           RL.attention(rlp, rcfg, jnp.asarray(x), local=False))
    # one decode step on a filled cache, shared and per-slot positions
    S_ctx = 24
    kc = np.zeros((2, S_ctx, cfg.n_kv_heads, cfg.hd), np.float32)
    vc = kc.copy()
    kc[:, :13] = np.asarray(rk)
    vc[:, :13] = np.asarray(rv)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    for pos in (np.int32(13), np.array([13, 5], np.int32)):
        cache = {"k": _t(kc), "v": _t(vc)}
        got, cache = L.attention_decode(lp, cfg, _t(x1), cache,
                                        torch.from_numpy(np.array(pos)),
                                        local=False)
        want, rcache = RL.attention_decode(
            rlp, rcfg, jnp.asarray(x1), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
            jnp.asarray(pos), local=False)
        _close(got, want)
        _close(cache["k"], rcache["k"])
        _close(cache["v"], rcache["v"])


def test_mamba_layers_match_reference():
    arch = "falcon-mamba-7b"
    cfg, rcfg, tree, _, params = perturbed_params(arch, seed=2)
    lp, rlp = params["layers"][0]["mixer"], _layer(tree, 0)["mixer"]
    x = np.random.default_rng(2).normal(size=(2, 19, cfg.d_model)).astype(np.float32)
    out, cache = M.mamba_prefill(lp, cfg, _t(x))
    rout, rcache = RM.mamba_prefill(rlp, rcfg, jnp.asarray(x))
    _close(out, rout)
    _close(cache["conv"], rcache["conv"])
    _close(cache["state"], rcache["state"])
    _close(M.mamba_block(lp, cfg, _t(x)), RM.mamba_block(rlp, rcfg, jnp.asarray(x)))
    x1 = np.random.default_rng(3).normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    got, gcache = M.mamba_decode(lp, cfg, _t(x1), cache)
    want, wcache = RM.mamba_decode(rlp, rcfg, jnp.asarray(x1), rcache)
    _close(got, want)
    _close(gcache["conv"], wcache["conv"])
    _close(gcache["state"], wcache["state"])


def _assert_caches(got, rtree, cfg):
    want = caches_from_jax(cfg, jax.tree.map(np.asarray, rtree), "cpu")
    assert len(got) == len(want) == cfg.n_layers + cfg.encdec
    for li, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys(), li
        for key in b:
            assert a[key].shape == b[key].shape, (li, key)
            assert a[key].dtype == b[key].dtype, (li, key)
            _close(a[key], b[key])


def _extras(cfg, B, S, rng) -> dict:
    """The batch entries beside the tokens: enc-dec's ``frames``, the VLM's
    ``patch_embeds``."""
    out = {}
    if cfg.encdec:
        out["frames"] = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)
                                   ).astype(np.float32)
    if cfg.vlm_prefix:
        out["patch_embeds"] = rng.normal(size=(B, cfg.vlm_prefix, cfg.d_model)
                                         ).astype(np.float32)
    return out


def _encdec_caches(cfg, rcfg, params, rparams, frames, S_ctx):
    """Both packages' zeroed decode caches with the encoder's states of
    ``frames`` in place (``tests/test_models_smoke.py``'s way)."""
    caches = MDL.init_decode_caches(cfg, frames.shape[0], S_ctx,
                                    torch.float32, "cpu")
    enc = MDL.encode(cfg, params, _t(frames))
    renc = RMDL._encoder(rcfg, rparams, jnp.asarray(frames))
    _close(enc, renc)
    caches[-1]["enc_out"] = enc
    rcaches = RMDL.init_decode_caches(rcfg, frames.shape[0], S_ctx,
                                      jnp.float32)
    rcaches["enc_out"] = renc
    return caches, rcaches


def test_prefill_and_decode_match_reference(lm):
    """``prefill_with_caches`` (last-token logits and every cache), then
    decode steps from those caches with a per-slot position vector, then
    with a shared position.  Enc-dec has no prefill (both packages raise):
    its caches start zeroed with the encoder's states of random frames, and
    the prompt goes in token by token."""
    arch, cfg, rcfg, tree, rparams, params = lm
    rng = np.random.default_rng(4)
    T, S_ctx = 11, 24
    toks = rng.integers(1, cfg.vocab, (2, T))
    if cfg.encdec:
        with pytest.raises(ValueError, match="encoder"):
            MDL.prefill_with_caches(cfg, params, torch.from_numpy(toks), S_ctx)
        frames = _extras(cfg, 2, T, rng)["frames"]
        caches, rcaches = _encdec_caches(cfg, rcfg, params, rparams, frames,
                                         S_ctx)
        for t in range(T):
            logits, caches = MDL.decode_step(cfg, params, caches,
                                             torch.from_numpy(toks[:, t:t + 1]),
                                             torch.tensor(t))
            rlogits, rcaches = ref_fns(rcfg)[1](rparams, rcaches,
                                                jnp.asarray(toks[:, t:t + 1]),
                                                jnp.int32(t))
    else:
        logits, caches = MDL.prefill_with_caches(
            cfg, params, torch.from_numpy(toks), S_ctx)
        rlogits, rcaches = ref_fns(rcfg)[0](rparams, jnp.asarray(toks), S_ctx)
    assert logits.shape == (2, 1, cfg.vocab)
    _close(logits, rlogits)
    _assert_caches(caches, rcaches, cfg)
    for step in range(3):
        nxt = rng.integers(1, cfg.vocab, (2, 1))
        pos = np.array([T + step, T + step], np.int32)
        logits, caches = MDL.decode_step(cfg, params, caches,
                                         torch.from_numpy(nxt),
                                         torch.from_numpy(pos))
        rlogits, rcaches = ref_fns(rcfg)[1](rparams, rcaches,
                                            jnp.asarray(nxt), jnp.asarray(pos))
        _close(logits, rlogits)
    _assert_caches(caches, rcaches, cfg)
    nxt = rng.integers(1, cfg.vocab, (2, 1))
    logits, caches = MDL.decode_step(cfg, params, caches, torch.from_numpy(nxt),
                                     torch.tensor(T + 3))
    rlogits, rcaches = ref_fns(rcfg)[1](rparams, rcaches, jnp.asarray(nxt),
                                        jnp.int32(T + 3))
    _close(logits, rlogits)
    _assert_caches(caches, rcaches, cfg)


def test_decode_from_empty_caches_with_ragged_slots(lm):
    """Token-by-token decode from zeroed caches, the two slots at different
    positions (the serving engine's per-slot vector)."""
    arch, cfg, rcfg, tree, rparams, params = lm
    caches = MDL.init_decode_caches(cfg, 2, 16, torch.float32, "cpu")
    rcaches = RMDL.init_decode_caches(rcfg, 2, 16, jnp.float32)
    _assert_caches(caches, rcaches, cfg)
    rng = np.random.default_rng(5)
    for step in range(5):
        toks = rng.integers(1, cfg.vocab, (2, 1))
        pos = np.array([step, max(0, step - 2)], np.int32)
        logits, caches = MDL.decode_step(cfg, params, caches,
                                         torch.from_numpy(toks),
                                         torch.from_numpy(pos))
        rlogits, rcaches = ref_fns(rcfg)[1](rparams, rcaches,
                                            jnp.asarray(toks), jnp.asarray(pos))
        _close(logits, rlogits)
    _assert_caches(caches, rcaches, cfg)


def test_forward_matches_reference(lm):
    """Full-sequence logits and the MoE aux loss (zero without MoE), with
    ``frames`` for enc-dec and ``patch_embeds`` over the VLM prefix."""
    arch, cfg, rcfg, tree, rparams, params = lm
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(1, cfg.vocab, (2, 17)),
             **_extras(cfg, 2, 17, rng)}
    logits, aux = MDL.forward(cfg, params, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    rlogits, raux = ref_fns(rcfg)[2](rparams, {k: jnp.asarray(v)
                                               for k, v in batch.items()})
    assert logits.shape == (2, 17, cfg.vocab)
    _close(logits, rlogits)
    _close(aux, raux)
    assert (float(aux) > 0) == (cfg.moe is not None)
    if cfg.vlm_prefix:          # the prefix is the patch embeddings' alone
        other = dict(batch, tokens=batch["tokens"].copy())
        other["tokens"][:, : cfg.vlm_prefix] = 0
        alt, _ = MDL.forward(cfg, params, {k: torch.from_numpy(v)
                                           for k, v in other.items()})
        torch.testing.assert_close(alt, logits, rtol=0, atol=0)


def _uncounted(cfg) -> int:
    """Params that ``ArchConfig.param_count`` leaves out: the final norm,
    QKV biases and qk-norm weights, MLA's two norms, a Mamba layer's
    ``conv_b``/``dt_bias``/``D``, less the FFN norm it counts for a layer
    without an FFN; for enc-dec the two position tables, the encoder's
    final norm and the cross-attention norms (its cross-attention weights
    are counted once per encoder layer; there is one per decoder layer).
    ``param_count`` knows the mixers ``g``, ``l`` and ``m`` only: jamba's
    attention layers (``a``) count neither their attention nor their
    FFN."""
    d = cfg.d_model
    att = ((cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd * cfg.qkv_bias
           + 2 * cfg.hd * cfg.qk_norm)
    extra = d
    for li in range(cfg.n_layers):
        mixer, ffn = MDL._layer_kinds(cfg, li)
        extra -= d if ffn == "none" else 0
        if mixer not in "glm":
            m = cfg.moe
            extra += 2 * d * (cfg.n_heads + cfg.n_kv_heads) * cfg.hd
            extra += (3 * d * m.d_expert * (m.n_experts + m.n_shared)
                      + d * m.n_experts) if ffn == "moe" else \
                3 * d * (m.d_ff_dense if m and m.d_ff_dense else cfg.d_ff)
        if mixer == "m":
            extra += 3 * cfg.ssm.expand * d
        elif cfg.mla is not None:
            extra += cfg.mla.q_lora + cfg.mla.kv_lora
        else:
            extra += att
    if cfg.encdec:
        extra += (8192 + cfg.enc_seq + 1) * d + cfg.n_layers * (d + att) \
            + cfg.enc_layers * att \
            + (cfg.n_layers - cfg.enc_layers) * 4 * d * cfg.n_heads * cfg.hd
    return extra


def _flat(tree, path=""):
    """{path: tensor} of a nested dict/list of tensors."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _leaves(tree):
    return list(_flat(tree).values())


def _reference_layer(cfg, tree, li):
    """Layer ``li``'s reference leaves: a prelude layer, or its group slot
    at its group."""
    prelude, _, pat = MDL.group_structure(cfg)
    if li in prelude:
        return tree[f"prelude_{li}"]
    g, s = divmod(li - len(prelude), pat)
    return jax.tree.map(lambda a: np.asarray(a)[g], tree["groups"][f"slot_{s}"])


def _equal_trees(got, want, where):
    got_l = jax.tree_util.tree_flatten_with_path(got)[0]
    want_l = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_l] == [p for p, _ in want_l], where
    for (path, a), (_, b) in zip(got_l, want_l):
        assert a.shape == b.shape, (where, path)
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trip(arch):
    cfg, rcfg, tree, _, params = perturbed_params(arch, seed=3)
    assert len(params["layers"]) == cfg.n_layers
    for li, lp in enumerate(params["layers"]):
        _equal_trees(lp, _reference_layer(cfg, tree, li), li)
    assert ("encdec" in params) == cfg.encdec
    if cfg.encdec:
        _equal_trees(params["encdec"], tree["encdec"], "encdec")
    # and back to the reference's layout, every leaf exact
    back = params_to_jax(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    n = sum(t.numel() for t in _leaves(params))
    assert n == cfg.param_count() + _uncounted(cfg)
    # the port's own init draws the same shapes, on the asked device
    own = MDL.init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                          "cpu")
    assert {k: t.shape for k, t in _flat(own).items()} == \
        {k: t.shape for k, t in _flat(params).items()}
    assert sum(t.numel() for t in _leaves(own)) == n
    assert all(t.device.type == "cpu" for t in _leaves(own))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_counts(arch):
    """At the published widths the port's layer shapes hold exactly
    ``param_count`` plus the uncounted vectors (shapes only; nothing is
    drawn at full size here)."""
    cfg = get_arch(arch)
    with torch.device("meta"):
        params = MDL.init_params(cfg, None, torch.float32, "meta")
    n = sum(t.numel() for t in _leaves(params))
    assert n == cfg.param_count() + _uncounted(cfg)


def test_dense_prelude_takes_d_ff_dense():
    """DeepSeek's dense layer 0 is ``moe.d_ff_dense`` wide (12,288 at full
    width), not ``d_ff`` (the experts' 1,536)."""
    cfg = get_arch("deepseek-v2-236b")
    with torch.device("meta"):
        lp = MDL.init_layer(cfg, 0, None, torch.float32, "meta")
        moe = MDL.init_layer(cfg, 1, None, torch.float32, "meta")
    assert lp["ffn"]["wi"].shape == (cfg.d_model, 12288)
    assert moe["ffn"]["wi"].shape == (160, cfg.d_model, 1536)


def _int8_cfgs(arch="qwen2-0.5b"):
    cfg, rcfg = reduced_config(get_arch(arch)), ref_reduced(ref_get_arch(arch))
    return (dataclasses.replace(cfg, perf=PerfFlags(kv_quant_int8=True)),
            dataclasses.replace(rcfg, perf=RefPerfFlags(kv_quant_int8=True)))


def test_quant_kv_matches_reference_exactly():
    """On the same float inputs the int8 values and scales are the
    reference's bit for bit, halves rounded to even and zero rows at the
    1e-8 floor."""
    rng = np.random.default_rng(7)
    t = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    t[0, 0, 0] = 0.0
    t[1, 2, 1, :4] = [127.0, 0.5, 1.5, -2.5]      # scale 1: exact halves
    t[1, 2, 1, 4:] = 0.25
    q, s = L._quant_kv(_t(t))
    rq, rs = RL._quant_kv(jnp.asarray(t))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert q[1, 2, 1, :4].tolist() == [127, 0, 2, -2]


def _int8_close(got, want, f_got, f_want, s_want):
    """int8 cache values equal, or one unit apart where the float values
    quantized (``f_got`` and ``f_want``, each package's, within ``TOL``)
    lie across a rounding boundary within their difference."""
    got, want = got.numpy().astype(np.int32), np.asarray(want).astype(np.int32)
    diff = got != want
    assert np.abs(got - want).max(initial=0) <= 1
    if diff.any():
        q = np.asarray(f_want) / np.asarray(s_want)[..., None]
        edge = np.abs(q - np.floor(q) - 0.5)
        reach = np.abs(f_got.numpy() - np.asarray(f_want)) \
            / np.asarray(s_want)[..., None] + 1e-5 * np.abs(q) + 1e-6
        assert (edge[diff] <= reach[diff]).all()


def _reference_caches(cfg, caches) -> dict:
    """The reference's cache tree (numpy) of the port's per-layer caches."""
    prelude, n_groups, pat = MDL.group_structure(cfg)
    out = {f"prelude_{li}": {k: t.numpy() for k, t in caches[li].items()}
           for li in prelude}
    base = len(prelude)
    if n_groups:
        out["groups"] = {f"slot_{s}": {k: np.stack([
            caches[base + g * pat + s][k].numpy() for g in range(n_groups)])
            for k in caches[base + s]} for s in range(pat)}
    return out


def test_int8_kv_cache_matches_reference(record_property):
    """``PerfFlags.kv_quant_int8``.  Prefill: logits within ``TOL``, the
    int8 caches and scales against the reference's (prefill attention runs
    on the float k, v, which a float prefill of the same model caches, so
    each package's pre-quantization values are known: int8 values equal, or
    one unit apart across a rounding boundary within the floats'
    difference).  Then decode steps, the reference each time stepping from
    the port's caches: a row whose new int8 entries equal the reference's
    in every layer gives logits within ``TOL``; a row where one of them
    crossed a rounding boundary (one unit) is counted."""
    cfg, rcfg = _int8_cfgs()
    fcfg = reduced_config(get_arch("qwen2-0.5b"))
    _, _, tree, rparams, params = perturbed_params("qwen2-0.5b", seed=8)
    rng = np.random.default_rng(8)
    T, S_ctx = 13, 24
    toks = rng.integers(1, cfg.vocab, (2, T))
    logits, caches = MDL.prefill_with_caches(cfg, params, torch.from_numpy(toks),
                                             S_ctx)
    rlogits, rcaches = ref_fns(rcfg)[0](rparams, jnp.asarray(toks), S_ctx)
    _, fcaches = MDL.prefill_with_caches(fcfg, params, torch.from_numpy(toks),
                                         S_ctx)
    _, rfcaches = ref_fns(ref_reduced(ref_get_arch("qwen2-0.5b")))[0](
        rparams, jnp.asarray(toks), S_ctx)
    _close(logits, rlogits)
    want = caches_from_jax(cfg, jax.tree.map(np.asarray, rcaches), "cpu")
    fwant = caches_from_jax(cfg, jax.tree.map(np.asarray, rfcaches), "cpu")
    for c, w, fc, fw in zip(caches, want, fcaches, fwant):
        assert c["k"].dtype == torch.int8 and c["k_scale"].dtype == torch.float32
        for n in ("k", "v"):
            _close(c[n + "_scale"], w[n + "_scale"])
            _int8_close(c[n][:, :T], w[n][:, :T], fc[n][:, :T], fw[n][:, :T],
                        w[n + "_scale"][:, :T])
            assert not c[n][:, T:].any() and not c[n + "_scale"][:, T:].any()
    flipped = 0
    for step in range(4):
        nxt = rng.integers(1, cfg.vocab, (2, 1))
        pos = np.array([T + step, T + step - 3], np.int32)
        start = jax.tree.map(jnp.asarray, _reference_caches(cfg, caches))
        logits, caches = MDL.decode_step(cfg, params, caches,
                                         torch.from_numpy(nxt),
                                         torch.from_numpy(pos))
        rlogits, rcaches = ref_fns(rcfg)[1](rparams, start, jnp.asarray(nxt),
                                            jnp.asarray(pos))
        want = caches_from_jax(cfg, jax.tree.map(np.asarray, rcaches), "cpu")
        for b in range(2):
            same = True
            for c, w in zip(caches, want):
                _close(c["k_scale"][b], w["k_scale"][b])
                _close(c["v_scale"][b], w["v_scale"][b])
                for n in ("k", "v"):
                    d = (c[n][b].int() - w[n][b].int()).abs()
                    assert int(d.max()) <= 1
                    same = same and not d.any()
            if same:
                _close(logits[b], rlogits[b])
            else:
                flipped += 1
    assert flipped <= 2
    record_property("decode_rows_with_a_rounding_flip", flipped)


def test_int8_prefill_cache_survives_slot_placement():
    """The prefill hands int8 values and scales to ``ServeEngine``'s slot
    placement, whose cast to the cache's type then changes nothing."""
    from repro_torch.serve.engine import ServeEngine

    cfg, _ = _int8_cfgs()
    _, _, _, _, params = perturbed_params("qwen2-0.5b", seed=9)
    eng = ServeEngine(cfg, params, n_slots=2, ctx_len=16, device="cpu")
    _, pre = MDL.prefill_with_caches(cfg, params, torch.ones((1, 5), dtype=torch.int64), 16)
    eng._place_slot(1, pre)
    for cache, p in zip(eng.caches, pre):
        for key, c_all in cache.items():
            assert c_all.dtype == p[key].dtype
            assert torch.equal(c_all[1], p[key][0])
    kv = sum(t.numel() * t.element_size() for c in eng.caches
             for t in c.values())
    f32 = MDL.init_decode_caches(reduced_config(get_arch("qwen2-0.5b")), 2,
                                 16, torch.float32, "cpu")
    assert kv * 4 == sum(t.numel() * t.element_size() for c in f32
                         for t in c.values()) * (1 + 4 / cfg.hd)


def test_cpu_model_path_runs_no_kernel(lm):
    arch, cfg, rcfg, tree, rparams, params = lm
    before = dict(build.LAUNCHES)
    if cfg.encdec:
        MDL.forward(cfg, params, {
            "tokens": torch.ones((1, 5), dtype=torch.int64),
            "frames": torch.zeros((1, cfg.enc_seq, cfg.d_model))})
    else:
        MDL.prefill_with_caches(cfg, params,
                                torch.ones((1, 5), dtype=torch.int64), 8)
    assert build.LAUNCHES == before
