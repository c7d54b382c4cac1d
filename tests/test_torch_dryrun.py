"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's: the federated query step's collectives by kind on both
production meshes against the reference dry-run's own output (run in a
subprocess: only the reference's dry-run may set its 512 fake XLA
devices); the activation policy applied in both packages moving
reduced-config logits equally, called after the reference's group layers
alone; ``lower_cell`` on ``qwen2-0.5b|decode_32k|single`` (its per-device
flops and model flops equal the reference dry-run's, run in a subprocess)
and its trace and pricing on a 2 x 2 mesh with a reduced config of each
family; ``benchmarks.roofline_bench`` reading the port's
output; and no import of the dry-run setting up a process group."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import roofline_bench  # noqa: E402
from repro.config.base import reduced_config as ref_reduced  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import model as RMDL  # noqa: E402
from repro_torch.config.base import SHAPES, reduced_config  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.models import model as MDL  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one architecture of each family
FAMILIES = {"dense": "qwen2-0.5b", "moe": "phi3.5-moe-42b-a6.6b",
            "mla": "deepseek-v2-236b", "ssm": "falcon-mamba-7b",
            "hybrid": "jamba-1.5-large-398b", "vlm": "chameleon-34b",
            "audio": "whisper-tiny"}


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep + str(ROOT),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference dry-run's fed cells on both meshes and its
    ``qwen2-0.5b|decode_32k|single`` cell, each run in a subprocess."""
    root = tmp_path_factory.mktemp("ref")
    cells = {}
    for name, flags in (("fed", ["--arch", "odyssey-fed", "--mesh", "both"]),
                        ("qwen", ["--arch", "qwen2-0.5b", "--shape",
                                  "decode_32k", "--mesh", "single"])):
        out = root / f"{name}.json"
        subprocess.run([sys.executable, "-m", "repro.launch.dryrun", *flags,
                        "--out", str(out)], cwd=root, env=_env(), check=True,
                       capture_output=True, timeout=600)
        cells.update(json.loads(out.read_text()))
    return cells


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_fed_cell_collectives_equal_reference(reference, mesh, tmp_path,
                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = D.lower_fed_cell(mesh == "multi")
    want = reference[f"odyssey-fed|fed_query|{mesh}"]
    assert set(want) <= set(got)                    # the reference's schema
    assert got["n_chips"] == want["n_chips"]
    assert got["by_collective"] == want["by_collective"] == {
        "all-gather": 5849088.0, "all-to-all": 139264.0, "all-reduce": 16.0}
    assert got["collective_bytes_per_dev"] == want["collective_bytes_per_dev"]
    for kind in ("all-gather", "all-to-all"):
        assert got["collective_counts"][kind] == want["collective_counts"][kind]
    # the reference's two psums over (model, data) are combined by XLA into
    # tuple all-reduces, one per axis: "%all-reduce = (s32[], s32[])
    # all-reduce(...)" and "%all-reduce.1"; the port books each psum's two
    # axes apart, four all-reduces of the same 16 bytes
    assert want["collective_counts"]["all-reduce"] == 2
    assert got["collective_counts"]["all-reduce"] == 4
    assert got["flops_per_dev"] == want["flops_per_dev"] == 0.0
    assert got["bottleneck"] in ("compute", "memory", "collective")


def _policy_logits(cfg, rcfg, tree, batch, policy, reference=True):
    MDL.set_activation_policy(policy)
    RMDL.set_activation_policy(policy)
    try:
        params = params_from_jax(cfg, tree, "cpu")
        with torch.no_grad():
            got, _ = MDL.forward(cfg, params, {k: torch.from_numpy(v)
                                               for k, v in batch.items()})
        want = None
        if reference:
            want, _ = RMDL.forward(rcfg, jax.tree.map(jnp.asarray, tree),
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        MDL.set_activation_policy(None)
        RMDL.set_activation_policy(None)
    return got.numpy(), None if want is None else np.asarray(want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_activation_policy_moves_both_packages_equally(family):
    arch = FAMILIES[family]
    cfg, rcfg = reduced_config(get_arch(arch)), ref_reduced(ref_get_arch(arch))
    tree = jax.tree.map(np.asarray, RMDL.init_params(
        rcfg, jax.random.PRNGKey(3), jnp.float32))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(1, cfg.vocab, (1, 8))}
    if cfg.encdec:
        batch["frames"] = rng.normal(size=(1, cfg.enc_seq, cfg.d_model)
                                     ).astype(np.float32)
    if cfg.vlm_prefix:
        batch["patch_embeds"] = rng.normal(
            size=(1, cfg.vlm_prefix, cfg.d_model)).astype(np.float32)
    calls = []

    def shift(x, kind):
        calls.append(kind)
        return x + 0.5 if kind == "residual" else x

    base, _ = _policy_logits(cfg, rcfg, tree, batch, None, reference=False)
    got, want = _policy_logits(cfg, rcfg, tree, batch, shift)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    prelude, n_groups, pat = MDL.group_structure(cfg)
    if cfg.encdec:                    # no policy on the enc-dec path
        assert not calls
        np.testing.assert_array_equal(got, base)
    else:
        # the port calls it after each group layer, never after a prelude
        # one; the reference's scan traces its group body once, a call per
        # slot
        assert calls.count("residual") == n_groups * pat + pat
        assert np.abs(got - base).max() > 1e-3


@pytest.fixture(scope="module")
def qwen_decode(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry") / "dryrun_torch.json"
    cwd = os.getcwd()
    os.chdir(out.parent)
    try:
        D.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--mesh",
                "single", "--out", str(out)])
    finally:
        os.chdir(cwd)
    return out


def test_qwen2_decode_cell(qwen_decode, reference):
    key = "qwen2-0.5b|decode_32k|single"
    r = json.loads(qwen_decode.read_text())[key]
    want = reference[key]
    assert r["status"] == want["status"] == "ok"
    assert r["n_chips"] == want["n_chips"] == 256
    # the reference's per-device flops count for this cell, to the flop
    assert r["flops_per_dev"] == want["flops_per_dev"]
    assert r["model_flops_total"] == want["model_flops_total"]
    assert r["fp32_flops_per_dev"] == 0.0           # no scan in qwen2
    assert r["max_while_trip"] == 24
    # the release it ran on, and which DTensor internals it let the
    # dry-run patch (the two it cannot do without among them)
    assert r["torch"] == torch.__version__
    assert r["dtensor_patches"]["ShardingPropagator.propagate_op_sharding"]
    assert r["dtensor_patches"][
        "ShardingPropagator.propagate_op_sharding_non_cached"]
    assert 0 < r["collective_bytes_per_dev"] and 0 < r["hbm_bytes_per_dev"]
    assert set(r["by_collective"]) <= {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all"}
    assert r["memory_analysis"]["peak_bytes"] >= r["memory_analysis"][
        "argument_bytes"] > 0


def test_roofline_bench_reads_the_port_output(qwen_decode):
    csv, text = roofline_bench.run(str(qwen_decode))
    assert [row[0] for row in csv] == ["roofline/qwen2-0.5b|decode_32k|single"]
    assert "qwen2-0.5b|decode_32k|single" in text


def test_reanalyze_reproduces_the_terms(qwen_decode):
    before = json.loads(qwen_decode.read_text())
    cwd = os.getcwd()
    os.chdir(qwen_decode.parent)
    try:
        D.main(["--reanalyze", "--out", str(qwen_decode)])
    finally:
        os.chdir(cwd)
    after = json.loads(qwen_decode.read_text())
    assert after == before


SMALL = ((2, 2), ("data", "model"))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_lower_cell_on_a_small_mesh(family):
    """``lower_cell``'s trace and pricing, on a 2 x 2 mesh with a reduced
    config of each family."""
    arch = FAMILIES[family]
    cfg = reduced_config(get_arch(arch))
    shape = SHAPES["decode_32k"]
    with D.fake_mesh(*SMALL) as mesh:
        trace, _, log = D.trace_cell(cfg, shape, mesh)
    r = D._row(arch, "decode_32k", "2x2", 4, trace, RL.model_flops(cfg, shape))
    assert r["n_chips"] == 4 and r["bottleneck"] in ("compute", "memory",
                                                     "collective")
    assert r["flops_per_dev"] > 0 and r["hbm_bytes_per_dev"] > 0
    assert r["max_while_trip"] == cfg.n_layers
    assert set(log.patches) >= {"ShardingPropagator.propagate_op_sharding",
                                "ShardingPropagator.propagate_op_sharding_non_cached"}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b"])
def test_train_cell_books_the_kernels(arch):
    """A train step on the small mesh: each layer's kernel forward and
    backward are booked, never their plain versions."""
    cfg = reduced_config(get_arch(arch))
    with D.fake_mesh(*SMALL) as mesh:
        trace, _, _ = D.trace_cell(cfg, SHAPES["train_4k"], mesh)
    kernels = [rec["kernel"] for rec in trace.records if rec["kind"] == "kernel"]
    names = (("ssm_scan_fwd", "ssm_scan_bwd") if cfg.ssm is not None else
             ("flash_attention_fwd", "flash_attention_bwd"))
    # remat: two forwards and one backward per layer
    assert sorted(kernels) == sorted([names[0]] * 2 * cfg.n_layers
                                     + [names[1]] * cfg.n_layers)
    assert not any(rec["op"] == "aten.bmm.default"
                   and rec["in"][0][0][-1] == rec["in"][1][0][-2] == 4096
                   for rec in trace.records)


def test_importing_the_dry_run_sets_up_no_process_group():
    code = ("import repro_torch.launch.dryrun, repro_torch.models.sharding, "
            "repro_torch.launch.roofline, repro_torch.launch.plan_shardings\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\nprint('clean')")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr
