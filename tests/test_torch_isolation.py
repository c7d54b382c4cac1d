"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``
(``repro_torch`` itself is allowed), and the planner's entry point runs on the
card unless the caller asks for the CPU."""
import ast
import inspect
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path) -> "list[tuple[int, str]]":
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                raise AssertionError(f"{path}:{node.lineno}: relative import")
            out.append((node.lineno, node.module or ""))
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.append((node.lineno, str(node.args[0].value)))
    return out


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_forbidden_detects_reference_imports():
    assert _forbidden("repro") and _forbidden("repro.core.cost")
    assert _forbidden("jax.numpy") and not _forbidden("repro_torch.core")
    assert not _forbidden("torch") and not _forbidden("numpy")


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [f"{path.relative_to(ROOT)}:{ln}: import {m}"
           for ln, m in _imported_modules(path) if _forbidden(m)]
    assert not bad, bad


def test_port_files_found():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES}
    assert {"core/join_order.py", "kernels/dp_layer.py",
            "core/planner.py", "engine/local.py"} <= names


def test_stats_kernel_modules_are_scanned():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES}
    assert {"kernels/build.py", "kernels/ops.py", "kernels/sorted_intersect.py",
            "kernels/join_count.py", "kernels/summary_probe.py",
            "kernels/seg_bitmap.py", "core/characteristic_sets.py"} <= names
    csrc = {p.name for p in (ROOT / "src" / "repro_torch" / "kernels"
                             / "csrc").glob("*.cu")}
    assert {"sorted_intersect.cu", "join_count.cu", "summary_probe.cu",
            "seg_bitmap.cu", "dp_sweep.cu", "dp_layer.cu"} <= csrc


def test_entry_points_default_to_the_card():
    from repro_torch.core import join_order as jo
    from repro_torch.core.planner import OdysseyOptimizer

    assert jo.DEFAULT_DEVICE == "cuda"
    assert jo.DP_BACKENDS == ("numpy", "torch")
    init = inspect.signature(OdysseyOptimizer.__init__).parameters
    assert init["device"].default == "cuda"
    assert init["dp_backend"].default == "torch"
    for fn in (jo.dp_join_order, jo.dp_join_order_batch):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda"
        assert params["dp_backend"].default == "torch"


def test_query_serving_entry_points_default_to_the_card():
    """``QueryServeEngine`` plans on the card unless asked otherwise,
    ``optimize_batch`` hands the optimizer's device to every stacked sweep
    (through ``plan_batch``), and ``LocalEngine`` executes through the
    operator pipeline by default."""
    from repro_torch.core import batch_planner as bp
    from repro_torch.core.planner import OdysseyOptimizer
    from repro_torch.engine.local import LocalEngine
    from repro_torch.serve.query import QueryServeEngine

    init = inspect.signature(QueryServeEngine).parameters
    assert init["device"].default == "cuda"
    assert init["dp_backend"].default == "torch"
    eng = inspect.signature(LocalEngine).parameters
    assert eng["use_pipeline"].default is True
    assert eng["scan_policy"].default == "static"
    assert eng["clock"].default is None
    assert LocalEngine.honor_faults is False
    assert "device=optimizer.device" in inspect.getsource(bp.plan_batch)
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES}
    assert {"core/batch_planner.py", "engine/pipeline.py",
            "stats/feedback.py", "serve/scheduler.py",
            "serve/query.py"} <= names
    assert hasattr(OdysseyOptimizer, "optimize_batch")


def test_stats_entry_points_default_to_the_card():
    from repro_torch.core.characteristic_sets import \
        compute_characteristic_sets_torch
    from repro_torch.core.federation import compute_federated_cps_ops
    from repro_torch.kernels import build, ops

    assert ops.DEFAULT_DEVICE == "cuda"
    for fn in (ops.intersect_count, ops.predicate_bitmaps, ops.match_counts,
               ops.signature_overlap, compute_characteristic_sets_torch,
               compute_federated_cps_ops):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert set(build.SOURCES) == {"dp_sweep", "dp_layer", "sorted_intersect",
                                  "join_count", "summary_probe", "seg_bitmap",
                                  "flash_attention", "ssm_scan",
                                  "flash_attention_bwd", "ssm_scan_bwd"}


def test_lm_entry_points_default_to_the_card():
    from repro_torch.kernels.build import SOURCES
    from repro_torch.models import model as MDL
    from repro_torch.serve.engine import ServeEngine

    for fn in (MDL.init_params, MDL.init_decode_caches):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(ServeEngine).parameters["device"].default == "cuda"
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES}
    assert {"models/model.py", "models/layers.py", "models/mamba.py",
            "models/convert.py", "serve/engine.py", "serve/base.py",
            "config/base.py", "configs/__init__.py",
            "kernels/flash_attention.py", "kernels/ssm_scan.py"} <= names
    for name in ("flash_attention", "ssm_scan"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
                / SOURCES[name]).is_file()


def test_failover_and_baseline_entry_points_default_to_the_card():
    """``FailoverSession`` and ``execute_with_failover`` plan (and replan
    after an exclusion or a ``restore``) on the card unless asked
    otherwise, and ``FedXOdyssey`` hands its backend and device to its DP."""
    from repro_torch.baselines import hybrids as H
    from repro_torch.ft import failover as F

    for fn in (F.FailoverSession, F.execute_with_failover, H.FedXOdyssey):
        params = inspect.signature(fn).parameters
        assert params["dp_backend"].default == "torch", fn
        assert params["device"].default == "cuda", fn
    assert "dp_backend=dp_backend" in inspect.getsource(F.FailoverSession)
    assert "device=device" in inspect.getsource(F.execute_with_failover)
    src = inspect.getsource(H.FedXOdyssey.optimize)
    assert "dp_backend=self.dp_backend" in src and "device=self.device" in src
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES}
    assert {"ft/resilience.py", "ft/failover.py", "stats/void.py",
            "query/sparql.py", "baselines/fedx.py", "baselines/hibiscus.py",
            "baselines/void_dp.py", "baselines/hybrids.py"} <= names


def test_spmd_entry_points_default_to_the_card():
    """The meshes, and so ``DistributedEngine`` (its tables and relations
    live on ``mesh.device``) and the self-test, run on the card unless the
    caller asks for the CPU."""
    from repro_torch.engine.distributed import DistributedEngine
    from repro_torch.launch import dist_selftest
    from repro_torch.launch import mesh as M

    for fn in (M.make_test_mesh, M.make_production_mesh, M.Mesh):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert "to(mesh.device)" in inspect.getsource(DistributedEngine.__init__)
    assert 'add_argument("--device", default="cuda")' in inspect.getsource(
        dist_selftest.main)
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES}
    assert {"engine/operators.py", "engine/distributed.py", "launch/__init__.py",
            "launch/mesh.py", "launch/dist_selftest.py"} <= names


def test_training_entry_points_default_to_the_card():
    """The launcher trains on the card and checkpoints restore onto it
    unless the caller asks for the CPU; the training modules and the two
    backward kernels' sources are where the port keeps them."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.kernels.build import SOURCES
    from repro_torch.launch import train as T

    assert T.parse_args([]).device == "cuda"
    assert inspect.signature(
        CheckpointManager.restore).parameters["device"].default == "cuda"
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES}
    assert {"train/optimizer.py", "train/grad_compress.py",
            "train/train_step.py", "data/loader.py", "ckpt/checkpoint.py",
            "launch/train.py", "common/tree.py"} <= names
    for name in ("flash_attention_bwd", "ssm_scan_bwd"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
                / SOURCES[name]).is_file()
