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
