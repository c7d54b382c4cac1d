"""The port's training launcher (``repro_torch.launch.train``) on the CPU
(``--device cpu``), in the reference's three ``test_train_restart.py``
recipes: 6 steps straight against 3 steps, a restart from the checkpoint and
3 more (losses within ``rtol=1e-5``); 30 steps with int8 gradient
compression improve the NLL; two microbatches against one batch of the
same data (NLL within ``rtol=1e-5``, params within ``rtol=1e-3,
atol=1e-5``).  Also: SIGTERM saves a checkpoint and ends the run, the
printed lines are the reference's, the entry point defaults to the card,
and the VLM and encoder-decoder configurations train on the zero patch
embeddings and frames the reference's launcher feeds them."""
import inspect
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402

COMMON = ["--arch", "qwen2-0.5b", "--reduced", "--d-model", "64",
          "--layers", "2", "--batch", "2", "--seq", "32", "--log-every", "100",
          "--device", "cpu"]


def test_train_restart_bit_exact(tmp_path):
    """Run 6 steps straight vs 3 steps + restart + 3 steps: identical loss
    trajectory (resumable loader + checkpointed params/optimizer)."""
    straight = train_main(COMMON + ["--steps", "6",
                                    "--ckpt-dir", str(tmp_path / "a"),
                                    "--ckpt-every", "100"])
    train_main(COMMON + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b"),
                         "--ckpt-every", "3"])
    resumed = train_main(COMMON + ["--steps", "6",
                                   "--ckpt-dir", str(tmp_path / "b"),
                                   "--ckpt-every", "100"])
    assert len(resumed["losses"]) == 3
    np.testing.assert_allclose(straight["losses"][3:], resumed["losses"],
                               rtol=1e-5)


def test_train_with_compression_improves():
    out = train_main(["--arch", "qwen2-0.5b", "--reduced", "--d-model", "64",
                      "--layers", "2", "--batch", "4", "--seq", "64",
                      "--steps", "30", "--compress-grads", "--log-every",
                      "100", "--device", "cpu"])
    assert out["last"] < out["first"]


def test_train_microbatched_matches_monolithic():
    """Gradient accumulation over microbatches == one big batch (same
    data)."""
    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.config.base import reduced_config
    from repro_torch.configs import get_arch
    from repro_torch.data.loader import TokenLoader
    from repro_torch.models import model as MDL
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import make_train_step

    cfg = reduced_config(get_arch("qwen2-0.5b"), n_layers=2)
    params = MDL.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    loader = TokenLoader(vocab=cfg.vocab, batch=4, seq=32, seed=1)
    batch = {k: torch.from_numpy(v).long()
             for k, v in loader.batch_at(0).items()}
    opt = adamw(lr=1e-3)
    out = []
    for mb in (1, 2):
        p = tree_map(torch.clone, params)
        p, _, m = make_train_step(cfg, opt, microbatches=mb)(p, opt.init(p),
                                                             batch)
        out.append((p, m))
    (p1, m1), (p2, m2) = out
    np.testing.assert_allclose(float(m1["nll"]), float(m2["nll"]), rtol=1e-5)
    for a, b in zip(leaves(p1), leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5)


def test_sigterm_saves_and_exits(tmp_path, monkeypatch):
    """A SIGTERM during step 1 ends the run after that step with a
    checkpoint at step 2, from which a second run resumes."""
    real = T.TokenLoader.batch_at

    def batch_at(self, step):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, step)

    monkeypatch.setattr(T.TokenLoader, "batch_at", batch_at)
    before = signal.getsignal(signal.SIGTERM)
    try:
        out = train_main(COMMON + ["--steps", "6", "--ckpt-dir",
                                   str(tmp_path), "--ckpt-every", "100"])
    finally:
        signal.signal(signal.SIGTERM, before)
    assert len(out["losses"]) == 2
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    monkeypatch.setattr(T.TokenLoader, "batch_at", real)
    resumed = train_main(COMMON + ["--steps", "3", "--ckpt-dir",
                                   str(tmp_path)])
    assert len(resumed["losses"]) == 1


def test_prints_the_reference_lines(capsys):
    train_main(COMMON + ["--steps", "2", "--chunked-loss", "--optimizer",
                         "adafactor", "--microbatches", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=qwen2-0.5b ~") and \
        lines[0].endswith("M params (family=dense)")
    assert lines[1].startswith("step     0 nll=") and "grad_norm=" in lines[1] \
        and "tok/s=" in lines[1]
    assert lines[2].startswith("step     1 nll=")
    assert lines[-1].startswith("nll: first5=") and "improved" in lines[-1]


def test_launcher_defaults_to_the_card_and_refuses_unported_extras():
    """The entry point defaults to the card.  The VLM and enc-dec extras
    are ported now: the launcher feeds zero ``patch_embeds`` and
    ``frames``, as the reference's (``launch/train.py:100-105``), so the
    first step's NLL is the loss of the step-0 batch with those zeros on
    the same initial params."""
    from repro_torch.config.base import reduced_config
    from repro_torch.configs import get_arch
    from repro_torch.data.loader import TokenLoader
    from repro_torch.models import model as MDL
    from repro_torch.train.train_step import loss_fn

    assert T.parse_args([]).device == "cuda"
    assert 'add_argument("--device", default="cuda")' in \
        inspect.getsource(T.parse_args)
    for arch in ("chameleon-34b", "whisper-tiny"):
        out = train_main(["--arch", arch, "--reduced", "--steps", "1",
                          "--batch", "2", "--seq", "16", "--device", "cpu"])
        cfg = reduced_config(get_arch(arch))
        params = MDL.init_params(cfg, T.param_generator(0, "cpu"),
                                 torch.float32, "cpu")
        batch = {k: torch.from_numpy(v).long() for k, v in TokenLoader(
            vocab=cfg.vocab, batch=2, seq=16, seed=0).batch_at(0).items()}
        key, shape = (("frames", (2, cfg.enc_seq, cfg.d_model)) if cfg.encdec
                      else ("patch_embeds", (2, cfg.vlm_prefix, cfg.d_model)))
        batch[key] = torch.zeros(shape)
        with torch.no_grad():
            _, (nll, _) = loss_fn(cfg, params, batch)
        assert abs(out["losses"][0] - float(nll)) <= 1e-5 * float(nll)
