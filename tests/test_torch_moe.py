"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the CPU, on the same weights (the reference's
``init_moe`` draws, carried across as numpy) and numpy-seeded inputs:
``out`` and the aux loss, which assignments capacity drops, and the
gradients of ``out.sum() + aux`` for the router, the experts, the shared
experts and the input.  Cases: capacity dropping assignments and not,
shared experts, top-k 1, 2 and 6, and a model whose FFN is MoE every other
layer.  float32; the tolerance is 1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import MoEConfig as RefMoE  # noqa: E402
from repro.config.base import reduced_config as ref_reduced  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import model as RMDL  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro_torch.config.base import MoEConfig, reduced_config  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import model as MDL  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = 1e-4

# (name, n_experts, top_k, n_shared, capacity_factor, tokens B x S)
CASES = [
    ("top2_drops", 4, 2, 0, 1.25, (2, 23)),
    ("top2_no_drops", 4, 2, 0, 8.0, (2, 23)),
    ("top1_drops", 8, 1, 0, 1.0, (1, 40)),
    ("top6_shared", 16, 6, 2, 1.25, (2, 17)),
    ("top6_shared_no_drops", 16, 6, 2, 8.0, (1, 9)),
    ("decode_tokens", 4, 2, 1, 1.25, (3, 1)),
]


def _cfgs(E, K, n_shared, cf):
    kw = dict(n_experts=E, top_k=K, d_expert=24, n_shared=n_shared,
              capacity_factor=cf)
    base, rbase = (reduced_config(get_arch("phi3.5-moe-42b-a6.6b")),
                   ref_reduced(ref_get_arch("phi3.5-moe-42b-a6.6b")))
    return (dataclasses.replace(base, d_model=32, moe=MoEConfig(**kw)),
            dataclasses.replace(rbase, d_model=32, moe=RefMoE(**kw)))


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    name, E, K, n_shared, cf, (B, S) = request.param
    cfg, rcfg = _cfgs(E, K, n_shared, cf)
    seed = sum(map(ord, name))
    tree = jax.tree.map(np.asarray, jax.jit(lambda k: RMOE.init_moe(
        rcfg, k, jnp.float32))(jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)
                                           ).astype(np.float32)
    params = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return name, cfg, rcfg, tree, params, x


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _reference_kept(rcfg, p, x):
    """The reference's routing (``moe.py:40-66``): whether each (t, k)
    assignment, in (t, k) order, is kept (``rank < C``)."""
    m = rcfg.moe
    T = x.shape[0] * x.shape[1]
    K, E = m.top_k, m.n_experts
    C = int(max(4, round(m.capacity_factor * T * K / E)))

    @jax.jit
    def routing(xx, router):
        probs = jax.nn.softmax(xx.reshape(T, -1) @ router, -1)
        _, gate_idx = jax.lax.top_k(probs, K)
        flat_e = gate_idx.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        se = flat_e[order]
        return order, jnp.arange(T * K) - jnp.searchsorted(se, se, side="left")

    order, rank = routing(jnp.asarray(x), jnp.asarray(p["router"]))
    kept = np.zeros(T * K, bool)
    kept[np.asarray(order)] = np.asarray(rank < C)
    return kept, C


def test_moe_ffn_matches_reference(case):
    name, cfg, rcfg, tree, params, x = case
    out, aux = MOE.moe_ffn(params, cfg, torch.from_numpy(x))
    rout, raux = jax.jit(lambda p, xx: RMOE.moe_ffn(p, rcfg, xx))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    assert out.shape == x.shape and aux.dtype == torch.float32
    _close(out, rout)
    _close(aux, raux)


def test_moe_drops_the_references_assignments(case):
    name, cfg, rcfg, tree, params, x = case
    kept, C = _reference_kept(rcfg, tree, x)
    T = x.shape[0] * x.shape[1]
    _, _, _, slot, c = MOE.route(params, cfg, torch.from_numpy(x).reshape(T, -1))
    assert c == C == MOE.capacity(cfg, T)
    E = cfg.moe.n_experts
    np.testing.assert_array_equal(slot.numpy() != E * C, kept)
    assert MOE.dropped(params, cfg, torch.from_numpy(x)) == int((~kept).sum())
    assert ("no_drops" in name or "decode" in name) == bool(kept.all())
    # kept slots are distinct and inside their expert's C rows
    s = slot[slot != E * C]
    assert len(set(s.tolist())) == len(s)


def test_moe_gradients_match_reference(case):
    """``out.sum() + aux`` differentiated for every param and the input."""
    name, cfg, rcfg, tree, params, x = case

    def rloss(p, xx):
        out, aux = RMOE.moe_ffn(p, rcfg, xx)
        return out.sum() + aux

    rgrads, rgx = jax.jit(jax.grad(rloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    live = {k: v.clone().requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = MOE.moe_ffn(live, cfg, xt)
    (out.sum() + aux).backward()
    assert set(live) == set(rgrads)
    for k, v in live.items():
        want = np.asarray(rgrads[k])
        tol = TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(v.grad.numpy(), want, rtol=tol, atol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rgx), rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(rgx).max())))


def test_moe_combine_is_deterministic(case):
    """Two calls on the same inputs give the same bits (no atomics in the
    combine)."""
    name, cfg, rcfg, tree, params, x = case
    a, _ = MOE.moe_ffn(params, cfg, torch.from_numpy(x))
    b, _ = MOE.moe_ffn(params, cfg, torch.from_numpy(x))
    assert torch.equal(a, b)


def test_capacity_rounds_half_to_even_on_the_host():
    cfg, _ = _cfgs(4, 2, 0, 1.25)
    # 1.25 * T * 2 / 4 = 0.625 T: T = 12 -> 7.5 -> 8, T = 20 -> 12.5 -> 12
    assert MOE.capacity(cfg, 12) == 8
    assert MOE.capacity(cfg, 20) == 12
    assert MOE.capacity(cfg, 1) == 4


def test_moe_every_other_layer_model_matches_reference():
    """A model whose FFN is MoE every other layer (``every=2``, dense FFNs
    ``d_ff_dense`` wide between): forward logits and aux, and the layer
    kinds, against the reference."""
    kw = dict(n_experts=4, top_k=2, d_expert=32, every=2, d_ff_dense=96)
    cfg = dataclasses.replace(reduced_config(get_arch("qwen2-0.5b")),
                              n_layers=4, moe=MoEConfig(**kw))
    rcfg = dataclasses.replace(ref_reduced(ref_get_arch("qwen2-0.5b")),
                               n_layers=4, moe=RefMoE(**kw))
    assert [MDL._layer_kinds(cfg, i)[1] for i in range(4)] == \
        ["dense", "moe", "dense", "moe"]
    tree = jax.tree.map(np.asarray, jax.jit(lambda k: RMDL.init_params(
        rcfg, k, jnp.float32))(jax.random.PRNGKey(3)))
    params = params_from_jax(cfg, tree, "cpu")
    assert params["layers"][0]["ffn"]["wi"].shape == (cfg.d_model, 96)
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (2, 19))
    logits, aux = MDL.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    rlogits, raux = jax.jit(lambda p, t: RMDL.forward(rcfg, p, {"tokens": t}))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks))
    _close(logits, rlogits)
    _close(aux, raux)
