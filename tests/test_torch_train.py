"""The port's training path (``repro_torch.train``, ``data.loader``, the
kernels' backward passes, ``models`` with ``remat``) against the reference
package on the CPU, on the same weights: the reference's params from one
seed with their 1-D leaves perturbed (``test_torch_lm.perturbed_params``),
carried across with ``params_from_jax``.  Everything is float32.

Tolerances: gradients within ``1e-4 * max|want|`` per leaf (the packages sum
in different orders); the kernels' backward passes (autograd through the
plain versions, and the autograd Functions' glue) within ``1e-5 *
max(1, max|want|)``; optimizer updates and states after two steps within
1e-5; ``compress_grads``' int8 values equal and its scales and residuals
within 1e-6; two train steps' params and metrics within 1e-4, and six
Adafactor steps' ``nll`` and ``grad_norm`` within 1e-4;
``TokenLoader`` bit for bit; ``remat`` on and off within 1e-6."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import PerfFlags as RefPerfFlags  # noqa: E402
from repro.data.loader import TokenLoader as RefLoader  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.train import grad_compress as RGC  # noqa: E402
from repro.train import optimizer as ROPT  # noqa: E402
from repro.train import train_step as RTS  # noqa: E402
from repro_torch.common.tree import (get_path, leaves, named_leaves,  # noqa: E402
                                     tree_map)
from repro_torch.config.base import PerfFlags  # noqa: E402
from repro_torch.data.loader import TokenLoader  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ssm_scan as SS  # noqa: E402
from repro_torch.models.convert import (opt_state_from_jax,  # noqa: E402
                                        params_to_jax, reference_leaves,
                                        tree_from_jax)
from repro_torch.train import grad_compress as GC  # noqa: E402
from repro_torch.train import optimizer as OPT  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from test_torch_lm import perturbed_params  # noqa: E402

ARCHS = ["qwen2-0.5b", "falcon-mamba-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return perturbed_params(request.param)


def _np(t):
    return t.detach().float().numpy()


def _leaf_close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = _np(got)
    assert got.shape == want.shape
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol


def _batch(cfg, batch=2, seq=24, seed=3, step=0):
    b = RefLoader(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed).batch_at(step)
    return b, {k: torch.from_numpy(v).long() for k, v in b.items()}


def _ref_jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _trees_close(cfg, got, ref_np_tree, tol):
    want = tree_from_jax(cfg, ref_np_tree, "cpu")
    for path, w in named_leaves(want):
        torch.testing.assert_close(get_path(got, path).float(), w.float(),
                                   rtol=tol, atol=tol, msg=str(path))


# --------------------------------------------------------------------------
# the kernels' backward passes
# --------------------------------------------------------------------------

def _ref_attention(q, k, v, causal, window):
    """The reference model's attention math on projected q, k, v
    (``models/layers.py::attention`` after ``_project_qkv``)."""
    S = q.shape[1]
    scores = RL.gqa_scores(q, k).astype(jnp.float32)
    i = jnp.arange(S)[:, None]
    j = jnp.arange(S)[None, :]
    mask = jnp.zeros((S, S), jnp.float32)
    if causal:
        mask = jnp.where(j > i, RL.NEG_INF, mask)
    if window:
        mask = jnp.where(i - j >= window, RL.NEG_INF, mask)
    w = jax.nn.softmax(scores + mask, axis=-1)
    return RL.gqa_output(w, v)


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 37, 2, 2, 16), (2, 40, 4, 2, 8),
                                         (1, 29, 7, 1, 16),
                                         # past the card kernel's tile
                                         # edges (64 keys, 128 queries)
                                         (1, 65, 4, 2, 64),
                                         (2, 129, 7, 1, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 9), (False, 0),
                                           (False, 11)])
def test_flash_attention_backward_matches_jax_grad(B, S, H, KV, hd, causal,
                                                   window):
    """``flash_attention_bwd`` (its plain version, autograd through the
    plain forward) and ``FlashAttentionFn`` (whose forward and backward call
    the wrappers, the kernels on the card) against ``jax.grad`` of the
    reference's attention math."""
    rng = np.random.default_rng(S + H)
    q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32)
               for h in (H, KV, KV))
    dout = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    want = jax.jit(lambda a, b, c, d: jax.vjp(
        lambda a, b, c: _ref_attention(a, b, c, causal, window), a, b, c)[1](d))(
        *map(jnp.asarray, (q, k, v, dout)))
    tq, tk, tv, td = (torch.from_numpy(a) for a in (q, k, v, dout))
    kw = dict(causal=causal, window=window)
    out, lse = FA.flash_attention_fwd(tq, tk, tv, **kw)
    got = FA.flash_attention_bwd(tq, tk, tv, out.contiguous(), td, lse, **kw)
    leaves_ = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fn_out = FA.FlashAttentionFn.apply(*leaves_, causal, window, hd ** -0.5)
    fn_got = torch.autograd.grad(fn_out, leaves_, td)
    np.testing.assert_allclose(_np(fn_out), _np(out), rtol=0, atol=0)
    for g, f, w in zip(got, fn_got, want):
        w = np.asarray(w)
        tol = 1e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=tol)
        np.testing.assert_allclose(_np(f), w, rtol=0, atol=tol)
    # the log-sum-exp the backward kernel reads
    s = np.asarray(RL.gqa_scores(jnp.asarray(q), jnp.asarray(k)))
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    m = np.zeros((S, S), bool)
    m |= (j > i) if causal else m
    m |= (i - j >= window) if window else m
    s = np.where(m, -np.inf, s.astype(np.float64))
    lse_want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(_np(lse), lse_want.reshape(B, H, S),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,D,N", [(1, 1, 3, 4), (2, 33, 5, 4),
                                     (1, 70, 6, 3), (2, 40, 4, 0),
                                     (1, 97, 6, 17)])   # a partial last chunk
@pytest.mark.parametrize("with_dh", [False, True])
def test_ssm_scan_backward_matches_jax_grad(B, S, D, N, with_dh):
    """``ssm_scan_bwd`` (its plain version) and ``SSMScanFn`` against
    ``jax.grad`` of the reference's scan oracle (``kernels/ref.py::
    ssm_scan_ref``), with the final state's gradient zero or given."""
    rng = np.random.default_rng(S + D + N)
    f32 = lambda a: np.asarray(a, np.float32)
    args = [f32(np.abs(rng.normal(0.3, 0.1, (B, S, D)))),
            f32(rng.normal(size=(B, S, N))), f32(rng.normal(size=(B, S, N))),
            f32(rng.normal(size=(B, S, D))),
            f32(-np.abs(rng.normal(1.0, 0.3, (D, N))))]
    dy = f32(rng.normal(size=(B, S, D)))
    dh = f32(rng.normal(size=(B, D, N))) if with_dh else None

    def ref(dt, bt, ct, x, a):
        y = ref_oracles.ssm_scan_ref(dt, bt, ct, x, a)
        loss = jnp.sum(y * dy)
        if with_dh:     # the final state, as the scan's recurrence gives it
            def step(h, t):
                return h * jnp.exp(dt[:, t, :, None] * a) + \
                    (dt[:, t] * x[:, t])[..., None] * bt[:, t, None, :], None

            h, _ = jax.lax.scan(step, jnp.zeros((B, D, N), jnp.float32),
                                jnp.arange(S))
            loss = loss + jnp.sum(h * dh)
        return loss

    want = jax.jit(jax.grad(ref, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    tdh = None if dh is None else torch.from_numpy(dh)
    y, h_last, hc = SS.ssm_scan_fwd(*targs)
    assert hc.shape == (B, -(-S // SS.CHUNK), D, N)
    if S:
        torch.testing.assert_close(hc[:, -1], h_last, rtol=0, atol=0)
    got = SS.ssm_scan_bwd(*targs, hc, torch.from_numpy(dy), tdh)
    live = [t.clone().requires_grad_() for t in targs]
    fy, fh = SS.SSMScanFn.apply(*live)
    outs, grads = [fy], [torch.from_numpy(dy)]
    if with_dh:
        outs.append(fh)
        grads.append(tdh)
    fn_got = torch.autograd.grad(outs, live, grads, allow_unused=True)
    for g, f, w, t in zip(got, fn_got, want, targs):
        w = np.asarray(w)
        assert g.shape == t.shape
        tol = 1e-5 * max(1.0, float(np.abs(w).max()) if w.size else 1.0)
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=tol)
        if f is not None:
            np.testing.assert_allclose(_np(f), w, rtol=0, atol=tol)


# --------------------------------------------------------------------------
# model gradients and the loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunked", [False, True])
def test_loss_gradients_match_jax_grad(lm, chunked):
    """Gradients of ``loss_fn`` for every leaf against ``jax.grad`` of the
    reference's; chunked with ``S % loss_chunk != 0`` (24 positions in
    chunks of 10: the last four dropped, as the reference drops them)."""
    cfg, rcfg, tree, rparams, params = lm
    if chunked:
        cfg = dataclasses.replace(cfg, perf=PerfFlags(chunked_loss=True,
                                                      loss_chunk=10))
        rcfg = dataclasses.replace(rcfg, perf=RefPerfFlags(chunked_loss=True,
                                                           loss_chunk=10))
    nb, tb = _batch(cfg)
    (rloss, (rnll, _)), rgrads = jax.value_and_grad(
        lambda p: RTS.loss_fn(rcfg, p, _ref_jnp(nb)), has_aux=True)(rparams)
    loss, nll, aux, grads = TS.loss_and_grads(cfg, params, tb)
    assert abs(float(loss) - float(rloss)) <= 1e-4 * abs(float(rloss))
    assert abs(float(nll) - float(rnll)) <= 1e-4 * abs(float(rnll))
    want = tree_from_jax(cfg, jax.tree.map(np.asarray, rgrads), "cpu")
    got_named = named_leaves(grads)
    assert [p for p, _ in got_named] == [p for p, _ in named_leaves(want)]
    for path, g in got_named:
        _leaf_close(g, _np(get_path(want, path)), 1e-4)


def test_chunked_loss_drops_the_tail(lm):
    """The chunked NLL is the plain NLL over the first ``nc * c``
    positions."""
    cfg, _, _, _, params = lm
    ccfg = dataclasses.replace(cfg, perf=PerfFlags(chunked_loss=True,
                                                   loss_chunk=10))
    _, tb = _batch(cfg)
    with torch.no_grad():
        _, (nll_c, _) = TS.loss_fn(ccfg, params, tb)
        _, (nll_p, _) = TS.loss_fn(cfg, params, {k: v[:, :20]
                                                 for k, v in tb.items()})
    assert abs(float(nll_c) - float(nll_p)) <= 1e-5 * abs(float(nll_p))


def test_remat_equals_no_remat(lm):
    cfg, _, _, _, params = lm
    _, tb = _batch(cfg, seed=5)
    a = TS.loss_and_grads(cfg, params, tb, remat=True)
    b = TS.loss_and_grads(cfg, params, tb, remat=False)
    torch.testing.assert_close(a[0], b[0], rtol=1e-6, atol=1e-6)
    for x, y in zip(leaves(a[3]), leaves(b[3])):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


def test_params_round_trip_to_the_reference_layout(lm):
    cfg, _, tree, _, params = lm
    back = params_to_jax(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# optimizers, compression, the train step
# --------------------------------------------------------------------------

def _grad_trees(tree, n, seed):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                         * 0.1, tree) for _ in range(n)]


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(lm, name):
    """Two updates on the same gradients: updates, params and states
    within 1e-5 (Adafactor's second moments per reference leaf, stacked
    over the groups as the reference keeps them)."""
    cfg, _, tree, rparams, params = lm
    params = tree_map(torch.clone, params)      # updated in place
    assert len(params["layers"]) > 1
    ropt = ROPT.make_optimizer(name, lr=1e-2)
    opt = OPT.make_optimizer(name, cfg=cfg, lr=1e-2)
    rstate, state = ropt.init(rparams), opt.init(params)
    for g in _grad_trees(tree, 2, 7):
        rup, rstate = ropt.update(_ref_jnp(g), rstate, rparams)
        rparams = ROPT.apply_updates(rparams, rup)
        up, state = opt.update(tree_from_jax(cfg, g, "cpu"), state, params)
        params = OPT.apply_updates(params, up)
        _trees_close(cfg, up, jax.tree.map(np.asarray, rup), 1e-5)
    _trees_close(cfg, params, jax.tree.map(np.asarray, rparams), 1e-5)
    want = opt_state_from_jax(cfg, jax.tree.map(np.asarray, rstate), "cpu")
    assert int(state["step"]) == int(want["step"]) == 2
    if name == "adamw":
        for k in ("m", "v"):
            for path, w in named_leaves(want[k]):
                torch.testing.assert_close(get_path(state[k], path), w,
                                           rtol=1e-5, atol=1e-5)
    else:
        assert state["v"].keys() == want["v"].keys()
        assert any(name.startswith("groups/") and "vr" in v and
                   v["vr"].dim() == 1 for name, v in want["v"].items())
        for leaf, w in want["v"].items():
            for k in w:
                torch.testing.assert_close(state["v"][leaf][k], w[k],
                                           rtol=1e-5, atol=1e-5)


def test_compress_grads_matches_reference(lm):
    """Two rounds of int8 compression with error feedback: int8 values
    equal, the per-reference-leaf scales and the residuals within 1e-6."""
    cfg, _, tree, _, params = lm
    g1, g2 = _grad_trees(tree, 2, 11)
    refb = RGC.init_error_feedback(_ref_jnp(tree))
    efb = GC.init_error_feedback(params)
    for g in (g1, g2):
        rq, refb = RGC.compress_grads(_ref_jnp(g), refb)
        q, efb = GC.compress_grads(tree_from_jax(cfg, g, "cpu"), efb, cfg)
        is_pair = lambda x: isinstance(x, tuple) and len(x) == 2
        rvals = jax.tree.map(lambda p: np.asarray(p[0]), rq, is_leaf=is_pair)
        rscales = jax.tree.map(lambda p: float(p[1]), rq, is_leaf=is_pair)
        want_q = tree_from_jax(cfg, rvals, "cpu")
        for path, w in named_leaves(want_q):
            assert torch.equal(get_path(q, path).q, w), path
        for name, paths in reference_leaves(cfg, params).items():
            want_s = get_path(rscales, name.split("/"))
            for path in paths:
                assert abs(float(get_path(q, path).scale) - want_s) <= \
                    1e-6 * want_s
        _trees_close(cfg, efb, jax.tree.map(np.asarray, refb), 1e-6)
        torch.testing.assert_close(
            get_path(GC.decompress_grads(q), ("embed",)),
            torch.from_numpy(np.asarray(RGC.decompress_grads(rq)["embed"])),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_reference(lm, microbatches, compress):
    """Two steps of ``make_train_step``: params and metrics within 1e-4.
    AdamW's ``eps`` is 1 so that its update is smooth in the gradient:
    with a tiny ``eps`` the first update is ``lr * sign(g)``, and an int8
    rounding that the two packages' float32 sums split (0 against one
    quantization step) would move an element by ``lr``."""
    cfg, rcfg, tree, rparams, params = lm
    params = tree_map(torch.clone, params)      # updated in place
    ropt, opt = ROPT.adamw(lr=1e-3, eps=1.0), OPT.adamw(lr=1e-3, eps=1.0)
    rstep = jax.jit(RTS.make_train_step(rcfg, ropt, microbatches, compress))
    step = TS.make_train_step(cfg, opt, microbatches, compress)
    rstate, state = ropt.init(rparams), opt.init(params)
    refb = RGC.init_error_feedback(rparams) if compress else None
    efb = GC.init_error_feedback(params) if compress else None
    for s in range(2):
        nb, tb = _batch(cfg, batch=4, seq=16, seed=9, step=s)
        if compress:
            rparams, rstate, rm, refb = rstep(rparams, rstate, _ref_jnp(nb),
                                              refb)
            params, state, m, efb = step(params, state, tb, efb)
        else:
            rparams, rstate, rm = rstep(rparams, rstate, _ref_jnp(nb))
            params, state, m = step(params, state, tb)
        for k in ("loss", "nll", "moe_aux", "grad_norm"):
            assert abs(float(m[k]) - float(rm[k])) <= \
                1e-4 * max(1.0, abs(float(rm[k]))), k
    _trees_close(cfg, params, jax.tree.map(np.asarray, rparams), 1e-4)


def test_adafactor_six_steps_match_reference(lm):
    """Training cell (b)'s recipe (``chip_smoke.py``'s ``TRAIN_CELLS``):
    Adafactor at rate 1e-4, two microbatches, int8 gradient compression
    with error feedback, six steps of ``make_train_step`` in both packages
    from the same params and batches.  Each step's ``nll`` and
    ``grad_norm`` are held to the reference's within ``1e-4 * max(1,
    |want|)``, the two-step test's tolerance.

    It holds after six steps because nothing compounds fast: Adafactor
    clips each leaf's update to RMS 1, so a step moves an element by about
    the rate, and the packages differ only in float32 summation order
    (about 1e-6 relative in the gradients) and, through it, in an int8
    value now and then that the two sums round apart; that moves one
    element by about the rate, which changes the loss at second order.
    On the CPU the worst gap over the six steps is 7.2e-6 relative
    (falcon-mamba's ``grad_norm`` at step 4).  For the same reason the
    params are not held element for element: after six steps the largest
    difference, in falcon-mamba, is 1.2e-4, about the rate.  The test
    prints these figures (``pytest -s``).
    The spike that cell (b) showed on the card at full width does not
    appear here in either package (fault F4 in ROADMAP)."""
    cfg, rcfg, tree, rparams, params = lm
    params = tree_map(torch.clone, params)      # updated in place
    ropt = ROPT.make_optimizer("adafactor", lr=1e-4)
    opt = OPT.make_optimizer("adafactor", cfg=cfg, lr=1e-4)
    rstep = jax.jit(RTS.make_train_step(rcfg, ropt, 2, True))
    step = TS.make_train_step(cfg, opt, 2, True)
    rstate, state = ropt.init(rparams), opt.init(params)
    refb = RGC.init_error_feedback(rparams)
    efb = GC.init_error_feedback(params)
    gaps, nlls = [], []
    for s in range(6):
        nb, tb = _batch(cfg, batch=4, seq=16, seed=9, step=s)
        rparams, rstate, rm, refb = rstep(rparams, rstate, _ref_jnp(nb), refb)
        params, state, m, efb = step(params, state, tb, efb)
        nlls.append(float(m["nll"]))
        for k in ("nll", "grad_norm"):
            want = float(rm[k])
            assert np.isfinite(float(m[k]))
            gap = abs(float(m[k]) - want) / max(1.0, abs(want))
            assert gap <= 1e-4, (s, k, float(m[k]), want)
            gaps.append((gap, s, k))
    assert int(state["step"]) == int(rstate["step"]) == 6
    want = tree_from_jax(cfg, jax.tree.map(np.asarray, rparams), "cpu")
    param_gap = max(float((get_path(params, p).float() - w.float()).abs().max())
                    for p, w in named_leaves(want))
    # the figures the docstring quotes (shown with ``pytest -s``)
    print(f"{cfg.name}: worst gap {max(gaps)}, nll {nlls}, "
          f"largest param difference {param_gap}")


@pytest.mark.parametrize("seed,step,dp_rank,dp_size", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 2, 1, 4), (11, 1000, 3, 4)])
def test_token_loader_equals_reference_bit_for_bit(seed, step, dp_rank,
                                                   dp_size):
    kw = dict(vocab=997, batch=3, seq=17, seed=seed, dp_rank=dp_rank,
              dp_size=dp_size)
    got, want = TokenLoader(**kw).batch_at(step), RefLoader(**kw).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    it = iter(TokenLoader(**kw))
    np.testing.assert_array_equal(next(it)["tokens"],
                                  RefLoader(**kw).batch_at(0)["tokens"])


ZOO = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "jamba-1.5-large-398b",
       "whisper-tiny", "chameleon-34b"]


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_gradients_and_train_step_match_reference(arch):
    """The rest of the zoo: ``loss_and_grads`` against ``jax.grad`` of the
    reference's loss (every leaf, the MoE aux loss included in the loss),
    then one AdamW step (``eps`` 1, as above) of ``make_train_step``
    against the reference's AdamW on its gradients (the reference compiled
    once per configuration): params and metrics within 1e-4.  Enc-dec takes
    ``frames``, the VLM ``patch_embeds``."""
    cfg, rcfg, tree, rparams, params = perturbed_params(arch)
    params = tree_map(torch.clone, params)      # updated in place
    nb, tb = _batch(cfg, batch=2, seq=16, seed=4)
    rng = np.random.default_rng(4)
    if cfg.encdec:
        nb["frames"] = rng.normal(size=(2, cfg.enc_seq, cfg.d_model)
                                  ).astype(np.float32)
    if cfg.vlm_prefix:
        nb["patch_embeds"] = rng.normal(size=(2, cfg.vlm_prefix, cfg.d_model)
                                        ).astype(np.float32)
    tb.update({k: torch.from_numpy(v) for k, v in nb.items()
               if v.dtype == np.float32})
    (rloss, (rnll, raux)), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RTS.loss_fn(rcfg, p, b), has_aux=True))(rparams,
                                                             _ref_jnp(nb))
    loss, nll, aux, grads = TS.loss_and_grads(cfg, params, tb)
    for a, b in ((loss, rloss), (nll, rnll), (aux, raux)):
        assert abs(float(a) - float(b)) <= 1e-4 * max(1.0, abs(float(b)))
    assert (float(aux) > 0) == (cfg.moe is not None)
    want = tree_from_jax(cfg, jax.tree.map(np.asarray, rgrads), "cpu")
    got_named = named_leaves(grads)
    assert [p for p, _ in got_named] == [p for p, _ in named_leaves(want)]
    for path, g in got_named:
        _leaf_close(g, _np(get_path(want, path)), 1e-4)
    ropt, opt = ROPT.adamw(lr=1e-3, eps=1.0), OPT.adamw(lr=1e-3, eps=1.0)
    rup, _ = ropt.update(rgrads, ropt.init(rparams), rparams)
    rparams = ROPT.apply_updates(rparams, rup)
    rm = {"loss": rloss, "nll": rnll, "moe_aux": raux, "grad_norm": np.sqrt(
        sum(float(np.sum(np.square(np.asarray(g))))
            for g in jax.tree.leaves(rgrads)))}
    params, _, m = TS.make_train_step(cfg, opt)(params, opt.init(params), tb)
    for k in ("loss", "nll", "moe_aux", "grad_norm"):
        assert abs(float(m[k]) - float(rm[k])) <= \
            1e-4 * max(1.0, abs(float(rm[k]))), k
    _trees_close(cfg, params, jax.tree.map(np.asarray, rparams), 1e-4)
