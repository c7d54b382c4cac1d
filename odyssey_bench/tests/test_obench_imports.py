"""Nothing a run loads is JAX or the JAX package: top-level module names,
compared whole (the port's name begins with the JAX package's)."""
import os
import subprocess
import sys

from odyssey_bench.harness import FORBIDDEN, ROOT, forbidden_modules

PROBE = """
import sys
from odyssey_bench.tests.small import run_small
out = run_small("ls.queries.closed")
assert out["correct"], out
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_a_run_loads_no_jax_and_no_reference_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")])
    got = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    loaded = set(eval(got.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "odyssey_bench" in loaded
    assert not loaded & set(FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["repro_torch.serve.query", "odyssey_bench.run",
                              "jaxtyping", "benchmarks_extra"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "flax", "benchmarks.run",
                              "jaxlib.xla"]) == ["benchmarks", "flax", "jax", "jaxlib", "repro"]
