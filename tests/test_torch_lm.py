"""The port's LM (``repro_torch.models``) against the reference package on
the CPU, on the same weights: the reference's params are drawn from one
seed, their 1-D leaves (norms, biases, ``A_log``, ``D``) perturbed with
numpy noise so that every term counts, and carried across with
``params_from_jax``.  Layers, prefill (logits and every cache), decode
steps (shared and per-slot positions) and full-sequence logits, for reduced
``qwen2-0.5b`` (dense GQA with QKV bias, tied embeddings) and
``falcon-mamba-7b`` (Mamba-1).  Everything is float32; the tolerance is
1e-4 (the two packages sum in different orders)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

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
from repro_torch.models.convert import caches_from_jax, params_from_jax  # noqa: E402

TOL = 1e-4
ARCHS = ["qwen2-0.5b", "falcon-mamba-7b"]


def perturbed_params(arch: str, seed: int = 0):
    """(port cfg, reference cfg, numpy param tree, reference params, port
    params) from one seed."""
    rcfg = ref_reduced(ref_get_arch(arch))
    cfg = reduced_config(get_arch(arch))
    tree = jax.tree.map(np.asarray, RMDL.init_params(
        rcfg, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)

    def noisy(a):               # a per-layer vector, stacked (n_groups, width)
        if a.ndim == 2:
            a = a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        return np.asarray(a, np.float32)

    tree["groups"] = jax.tree.map(noisy, tree["groups"])
    tree["final_norm"] = noisy(tree["final_norm"][None])[0]
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
    assert len(got) == len(want) == cfg.n_layers
    for li, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys(), li
        for key in b:
            assert a[key].shape == b[key].shape, (li, key)
            _close(a[key], b[key])


def test_prefill_and_decode_match_reference(lm):
    """``prefill_with_caches`` (last-token logits and every cache), then
    decode steps from those caches with a per-slot position vector, then
    with a shared position."""
    arch, cfg, rcfg, tree, rparams, params = lm
    rng = np.random.default_rng(4)
    T, S_ctx = 11, 24
    toks = rng.integers(1, cfg.vocab, (2, T))
    logits, caches = MDL.prefill_with_caches(cfg, params, torch.from_numpy(toks),
                                             S_ctx)
    rlogits, rcaches = RMDL.prefill_with_caches(rcfg, rparams, jnp.asarray(toks),
                                                S_ctx)
    assert logits.shape == (2, 1, cfg.vocab)
    _close(logits, rlogits)
    _assert_caches(caches, rcaches, cfg)
    for step in range(3):
        nxt = rng.integers(1, cfg.vocab, (2, 1))
        pos = np.array([T + step, T + step], np.int32)
        logits, caches = MDL.decode_step(cfg, params, caches,
                                         torch.from_numpy(nxt),
                                         torch.from_numpy(pos))
        rlogits, rcaches = RMDL.decode_step(rcfg, rparams, rcaches,
                                            jnp.asarray(nxt), jnp.asarray(pos))
        _close(logits, rlogits)
    _assert_caches(caches, rcaches, cfg)
    nxt = rng.integers(1, cfg.vocab, (2, 1))
    logits, caches = MDL.decode_step(cfg, params, caches, torch.from_numpy(nxt),
                                     torch.tensor(T + 3))
    rlogits, rcaches = RMDL.decode_step(rcfg, rparams, rcaches, jnp.asarray(nxt),
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
        rlogits, rcaches = RMDL.decode_step(rcfg, rparams, rcaches,
                                            jnp.asarray(toks), jnp.asarray(pos))
        _close(logits, rlogits)
    _assert_caches(caches, rcaches, cfg)


def test_forward_matches_reference(lm):
    arch, cfg, rcfg, tree, rparams, params = lm
    toks = np.random.default_rng(6).integers(1, cfg.vocab, (2, 17))
    logits, aux = MDL.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    rlogits, raux = RMDL.forward(rcfg, rparams, {"tokens": jnp.asarray(toks)})
    assert logits.shape == (2, 17, cfg.vocab)
    _close(logits, rlogits)
    assert float(aux) == float(raux) == 0.0


def _uncounted(cfg) -> int:
    """Params that ``ArchConfig.param_count`` leaves out: the final norm,
    QKV biases, a Mamba layer's ``conv_b``/``dt_bias``/``D``, less the FFN
    norm it counts for a layer without an FFN."""
    d = cfg.d_model
    extra = d
    for li in range(cfg.n_layers):
        extra -= 0 if cfg.d_ff else d
        if cfg.mixer_of(li) == "m":
            extra += 3 * cfg.ssm.expand * d
        elif cfg.qkv_bias:
            extra += (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
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


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trip(arch):
    cfg, rcfg, tree, _, params = perturbed_params(arch, seed=3)
    assert len(params["layers"]) == cfg.n_layers
    for li, lp in enumerate(params["layers"]):
        want = jax.tree.map(lambda a: np.asarray(a)[li], tree["groups"]["slot_0"])
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(lp)[0],
                                jax.tree.leaves(want)):
            assert a.shape == b.shape, (li, path)
            np.testing.assert_array_equal(a.numpy(), b)
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


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b",
                                  "whisper-tiny", "chameleon-34b",
                                  "jamba-1.5-large-398b"])
def test_unported_configurations_raise(arch):
    cfg = reduced_config(get_arch(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MDL.init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                        "cpu")
    with pytest.raises((NotImplementedError, ValueError)):
        MDL.prefill_with_caches(cfg, {}, torch.zeros((1, 2), dtype=torch.int64), 8)


def test_int8_kv_cache_raises():
    cfg = dataclasses.replace(reduced_config(get_arch("qwen2-0.5b")),
                              perf=PerfFlags(kv_quant_int8=True))
    with pytest.raises(NotImplementedError, match="int8"):
        MDL.init_decode_caches(cfg, 1, 8, torch.float32, "cpu")


def test_cpu_model_path_runs_no_kernel(lm):
    arch, cfg, rcfg, tree, rparams, params = lm
    before = dict(build.LAUNCHES)
    MDL.prefill_with_caches(cfg, params, torch.ones((1, 5), dtype=torch.int64), 8)
    assert build.LAUNCHES == before
