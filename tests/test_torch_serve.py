"""The port's ``ServeEngine`` (``repro_torch.serve``) against the reference's
on the CPU, on the same weights (``test_torch_lm.perturbed_params``):
greedy tokens equal and logits within ``TOL`` wherever the top-2 logit gap
exceeds it, for reduced ``qwen2-0.5b`` and ``falcon-mamba-7b``, with and
without prefill admission; the rest of the zoo (MoE, MLA, the int8 KV
cache, enc-dec) against the reference's engine; then the engine's contracts, mirroring
``tests/test_serve.py``: slot reuse and the ``pos`` reset on retire,
truncate/reject overflow, EDF admission, the ``poll``/``drain`` report-once
contract, the partial-drain error and the deprecated ``run_until_done``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_lm import perturbed_params  # noqa: E402

from repro.models import model as RMDL  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.serve import ServeBase, ServeStats  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

TOL = 1e-4          # float32 logits of the two packages
ARCHS = ["qwen2-0.5b", "falcon-mamba-7b"]
PROMPTS = [[5, 9, 23], [7, 2, 40, 11], [3], [1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]]


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    cfg, rcfg, _, rparams, params = perturbed_params(request.param, seed=7)
    return cfg, rcfg, rparams, params


def _reference_alone(rcfg, rparams, prompt, n_new, ctx):
    """One request decoded alone through the reference's ``decode_step``,
    token by token (``tests/test_serve.py::_reference_greedy``): its greedy
    tokens and the logits row each was drawn from."""
    step = jax.jit(lambda p, c, t, pos: RMDL.decode_step(rcfg, p, c, t, pos))
    caches = RMDL.init_decode_caches(rcfg, 1, ctx, jnp.float32)
    logits = None
    for t, tok in enumerate(prompt):
        logits, caches = step(rparams, caches, jnp.asarray([[tok]], jnp.int32),
                              jnp.int32(t))
    out, rows = [], []
    for i in range(n_new):
        rows.append(np.asarray(logits[0, -1]))
        out.append(int(np.argmax(rows[-1])))
        logits, caches = step(rparams, caches,
                              jnp.asarray([[out[-1]]], jnp.int32),
                              jnp.int32(len(prompt) + i))
    return out, rows


def _gap(row) -> float:
    top = np.sort(np.asarray(row, np.float64))[-2:]
    return float(top[1] - top[0])


def compare_runs(got_out, got_logits, want_out, want_logits, tol):
    """Walk the generated positions: equal tokens wherever either run's
    top-2 gap exceeds ``tol``, logits within ``tol`` up to the first
    near-tie that splits the runs.  Returns the near-tie count."""
    ties = 0
    for i, (a, b) in enumerate(zip(got_out, want_out)):
        ga, gb = _gap(got_logits[i]), _gap(want_logits[i])
        if max(ga, gb) <= tol:
            ties += 1
        if a != b:
            assert max(ga, gb) <= tol, f"token {i}: {a} vs {b}, gaps {ga}, {gb}"
            return ties           # a near-tie split the runs; stop here
        np.testing.assert_allclose(np.asarray(got_logits[i]),
                                   np.asarray(want_logits[i]), rtol=tol,
                                   atol=tol, err_msg=f"logits before token {i}")
    assert len(got_out) == len(want_out)
    return ties


@pytest.mark.parametrize("use_prefill", [False, True])
def test_engine_matches_reference(lm, use_prefill, record_property):
    """Each request's tokens and logits against the reference decoding it
    alone (its own contract: co-batched requests give the tokens they give
    alone), and its tokens against the reference's engine.  That engine
    leaves a reused slot's Mamba state as the slot's last occupant left it
    (the port clears it), so on the SSM arch a request admitted token by
    token into a reused slot may differ there; those requests are counted,
    and each must be one where the reference's engine differs from the
    reference alone."""
    cfg, rcfg, rparams, params = lm
    ref = RefEngine(rcfg, rparams, n_slots=2, ctx_len=64,
                    use_prefill=use_prefill)
    eng = ServeEngine(cfg, params, n_slots=2, ctx_len=64,
                      use_prefill=use_prefill, device="cpu", keep_logits=True)
    for i, p in enumerate(PROMPTS):
        ref.submit(RefRequest(rid=i, prompt=list(p), max_new=6))
        eng.submit(Request(rid=i, prompt=list(p), max_new=6))
    want = sorted(ref.drain(), key=lambda r: r.rid)
    got = sorted(eng.drain(), key=lambda r: r.rid)
    assert [r.rid for r in got] == [r.rid for r in want] == [0, 1, 2, 3]
    ties = stale = 0
    for g, w in zip(got, want):
        assert len(g.logits) == len(g.out) == 6
        alone, rows = _reference_alone(rcfg, rparams, w.prompt, 6, 64)
        ties += compare_runs(g.out, g.logits, alone, rows, TOL)
        if g.out != w.out:
            assert cfg.family == "ssm" and w.out != alone, g.rid
            stale += 1
    record_property("near_ties", ties)
    record_property("reference_engine_stale_ssm_slots", stale)
    assert eng.serve_stats.n_served == ref.serve_stats.n_served == 4
    assert eng.serve_stats.n_steps == ref.serve_stats.n_steps


def test_prefill_admission_matches_token_by_token(lm):
    """The reference contract ``test_serve_prefill_admission_matches_reference``
    on the port alone: prefill-seeded caches continue as token-by-token
    decode does, and the first logits row (prefill's last token) agrees."""
    cfg, _, _, params = lm
    runs = []
    for use_prefill in (False, True):
        eng = ServeEngine(cfg, params, n_slots=2, ctx_len=64,
                          use_prefill=use_prefill, device="cpu",
                          keep_logits=True)
        for i, p in enumerate(PROMPTS):
            eng.submit(Request(rid=i, prompt=list(p), max_new=5))
        runs.append(sorted(eng.drain(), key=lambda r: r.rid))
    for a, b in zip(*runs):
        compare_runs(b.out, b.logits, a.out, a.logits, TOL)


def _port_engine(lm, **kw):
    cfg, _, _, params = lm
    return ServeEngine(cfg, params, device="cpu", **kw)


def test_slot_reuse_and_pos_reset(lm):
    eng = _port_engine(lm, n_slots=1, ctx_len=64)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=[i + 1], max_new=3))
    done = eng.drain()
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    eng = _port_engine(lm, n_slots=2, ctx_len=64)
    eng.submit(Request(rid=0, prompt=[5, 9, 23], max_new=4))
    eng.submit(Request(rid=1, prompt=[7, 2], max_new=12))
    while eng.queue or eng.active:
        eng.step()
        for slot in range(eng.n_slots):
            if slot not in eng.active:
                assert int(eng.pos[slot]) == 0
    assert len(eng.finished) == 2 and (eng.pos == 0).all()


def test_overflow_reject_and_truncate_match_reference(lm):
    cfg, rcfg, rparams, params = lm
    eng = _port_engine(lm, n_slots=1, ctx_len=16)
    with pytest.raises(ValueError, match="exceeds the slot cache"):
        eng.submit(Request(rid=0, prompt=list(range(1, 21)), max_new=4))
    assert not eng.queue and not eng.active
    eng.submit(Request(rid=1, prompt=list(range(1, 16)), max_new=4))
    done = eng.drain()
    assert len(done) == 1 and done[0].done and len(done[0].out) >= 1
    assert int(eng.pos.max()) <= eng.ctx

    prompt = list(range(1, 25))                      # 24 tokens > ctx 16
    eng = _port_engine(lm, n_slots=2, ctx_len=16, overflow="truncate")
    ref = RefEngine(rcfg, rparams, n_slots=2, ctx_len=16, overflow="truncate")
    eng.submit(Request(rid=0, prompt=list(prompt), max_new=4))
    ref.submit(RefRequest(rid=0, prompt=list(prompt), max_new=4))
    (got,), (want,) = eng.drain(), ref.drain()
    assert got.truncated and got.done and got.prompt == prompt[-15:]
    assert got.out == want.out and 1 <= len(got.out) <= 4
    with pytest.raises(ValueError, match="overflow"):
        _port_engine(lm, overflow="drop")


def test_deadline_orders_admission(lm):
    eng = _port_engine(lm, n_slots=1, ctx_len=64)
    eng.submit(Request(rid=0, prompt=[5], max_new=2), deadline=1e6)
    eng.submit(Request(rid=1, prompt=[9], max_new=2), deadline=0.001)
    eng.submit(Request(rid=2, prompt=[7], max_new=2), deadline=1e6)
    assert [r.rid for r in eng.drain()] == [1, 0, 2]
    assert eng.serve_stats.n_served == 3 and eng.serve_stats.n_steps > 0


def test_poll_and_drain_report_exactly_once(lm):
    eng = _port_engine(lm, n_slots=2, ctx_len=64)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=[i + 1], max_new=2))
    seen: list[int] = []
    for _ in range(50):
        eng.step()
        seen.extend(r.rid for r in eng.poll())
        if not (eng.queue or eng.active):
            break
    assert sorted(seen) == [0, 1, 2]
    assert eng.poll() == [] and eng.drain() == []
    eng.submit(Request(rid=3, prompt=[4], max_new=2))
    with pytest.warns(DeprecationWarning, match="drain"):
        done = eng.run_until_done()
    assert [r.rid for r in done] == [3]
    assert [r.rid for r in eng.finished] == sorted(seen) + [3]
    assert eng.run_until_done.__doc__ and isinstance(eng, ServeBase)
    assert isinstance(eng.serve_stats, ServeStats)


def test_partial_drain_raises_and_keeps_work(lm):
    eng = _port_engine(lm, n_slots=1, ctx_len=64)
    eng.submit(Request(rid=0, prompt=[5, 9], max_new=8))
    with pytest.raises(RuntimeError, match="remaining"):
        eng.drain(max_steps=1)
    assert eng.queue or eng.active
    assert [r.rid for r in eng.drain()] == [0]


def test_eos_retires_early(lm):
    """A request whose first greedy token is the EOS id retires at once,
    with prefill admission (the slot frees inside ``_admit``) and without."""
    cfg, _, _, params = lm
    first = _port_engine(lm, n_slots=1, ctx_len=64, use_prefill=True)
    first.submit(Request(rid=0, prompt=[5, 9, 23], max_new=6))
    eos = first.drain()[0].out[0]
    for use_prefill in (True, False):
        eng = _port_engine(lm, n_slots=1, ctx_len=64, eos=eos,
                           use_prefill=use_prefill)
        eng.submit(Request(rid=0, prompt=[5, 9, 23], max_new=6))
        eng.submit(Request(rid=1, prompt=[5, 9, 23], max_new=6))
        done = eng.drain()
        assert [r.out for r in done] == [[eos], [eos]]


# (arch, int8 KV cache, use_prefill); enc-dec admits token by token only
ZOO = [("phi3.5-moe-42b-a6.6b", False, False),
       ("phi3.5-moe-42b-a6.6b", False, True),
       ("deepseek-v2-236b", False, False), ("deepseek-v2-236b", False, True),
       ("qwen2-0.5b", True, False), ("qwen2-0.5b", True, True),
       ("whisper-tiny", False, False)]


@pytest.mark.parametrize("arch,int8,use_prefill", ZOO)
def test_zoo_engine_matches_reference(arch, int8, use_prefill,
                                      record_property):
    """The port's engine against the reference's, same weights and
    requests: every request's greedy tokens equal up to a near-tie of the
    port's logits (top-2 gap within ``TOL``), where the runs may split.
    Prefill admission and token-by-token admission are different
    computations for MoE (the capacity depends on the tokens routed
    together), so each is held to the reference's same mode; enc-dec
    serving cross-attends to the zeroed ``enc_out`` in both packages."""
    import dataclasses

    from repro.config.base import PerfFlags as RefPerfFlags
    from repro_torch.config.base import PerfFlags

    cfg, rcfg, _, rparams, params = perturbed_params(arch, seed=7)
    if int8:
        cfg = dataclasses.replace(cfg, perf=PerfFlags(kv_quant_int8=True))
        rcfg = dataclasses.replace(rcfg, perf=RefPerfFlags(kv_quant_int8=True))
    ref = RefEngine(rcfg, rparams, n_slots=2, ctx_len=32,
                    use_prefill=use_prefill)
    eng = ServeEngine(cfg, params, n_slots=2, ctx_len=32,
                      use_prefill=use_prefill, device="cpu", keep_logits=True)
    assert eng.use_prefill == ref.use_prefill == (use_prefill and not cfg.encdec)
    for i, p in enumerate(PROMPTS):
        ref.submit(RefRequest(rid=i, prompt=list(p), max_new=5))
        eng.submit(Request(rid=i, prompt=list(p), max_new=5))
    want = sorted(ref.drain(), key=lambda r: r.rid)
    got = sorted(eng.drain(), key=lambda r: r.rid)
    assert [r.rid for r in got] == [r.rid for r in want] == [0, 1, 2, 3]
    splits = 0
    for g, w in zip(got, want):
        assert len(g.out) == len(g.logits) == 5
        for i, (a, b) in enumerate(zip(g.out, w.out)):
            if a != b:
                assert _gap(g.logits[i]) <= TOL, (g.rid, i, a, b)
                splits += 1
                break
        else:
            assert g.out == w.out
    record_property("near_tie_splits", splits)
    assert eng.serve_stats.n_steps == ref.serve_stats.n_steps
