"""The port's data generator and statistics against the reference package:
for the same seed the generated federation, its ground truth, the workload
and every array of ``build_federated_stats`` are equal."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.federation import build_federated_stats as ref_build  # noqa: E402
from repro.rdf.generator import fedbench_like_spec as ref_spec  # noqa: E402
from repro.rdf.generator import generate_federation as ref_gen  # noqa: E402
from repro.rdf.generator import generate_workload as ref_workload  # noqa: E402
from repro.rdf.shapes import shaped_planning_inputs as ref_shaped  # noqa: E402
from repro_torch.core.federation import build_federated_stats  # noqa: E402
from repro_torch.rdf.generator import (  # noqa: E402
    fedbench_like_spec,
    generate_federation,
    generate_workload,
)
from repro_torch.rdf.shapes import shaped_planning_inputs  # noqa: E402


def assert_same(a, b, path="root"):
    """Structural equality across the two packages: dataclasses field by
    field (same class name; memo fields starting with ``_`` skipped), numpy
    arrays by dtype and value, containers element by element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            if f.name.startswith("_"):
                continue
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        assert_same(vars(a), vars(b), path)
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def feds():
    return (ref_gen(ref_spec(scale=0.06, seed=3)),
            generate_federation(fedbench_like_spec(scale=0.06, seed=3)))


def test_generated_federation_equal(feds):
    (rfed, rgt), (fed, gt) = feds
    assert fed.total_triples() == rfed.total_triples() > 0
    assert [s.name for s in fed.sources] == [s.name for s in rfed.sources]
    for src, rsrc in zip(fed.sources, rfed.sources):
        for col in ("s", "p", "o"):
            a, b = getattr(src.table, col), getattr(rsrc.table, col)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert fed.dictionary.terms == rfed.dictionary.terms
    assert_same(gt, rgt, "ground_truth")


def test_build_federated_stats_equal(feds):
    (rfed, _), (fed, _) = feds
    got, want = build_federated_stats(fed), ref_build(rfed)
    assert got.fed_cp and got.pruning_possible > 0
    for f in ("cs", "intra_cp", "fed_cp", "fed_cs", "exports", "summaries",
              "pruning_checked", "pruning_possible", "epoch", "use_summaries",
              "n_bits", "max_cs"):
        assert_same(getattr(got, f), getattr(want, f), f)


def test_workload_equal(feds):
    (rfed, rgt), (fed, gt) = feds
    got = generate_workload(fed, gt, n_star=4, n_hybrid=4, n_path=2, seed=9)
    want = ref_workload(rfed, rgt, n_star=4, n_hybrid=4, n_path=2, seed=9)
    assert len(got) == len(want) > 0
    for q, r in zip(got, want):
        assert q.name == r.name and q.distinct == r.distinct
        assert repr(q.patterns) == repr(r.patterns)
        assert q.effective_projection() == r.effective_projection()


@pytest.mark.parametrize("shape,n", [("chain", 6), ("tree", 9), ("clique", 5)])
def test_shaped_planning_inputs_equal(shape, n):
    g, stats, sel, q = shaped_planning_inputs(shape, n, seed=n)
    rg, rstats, rsel, rq = ref_shaped(shape, n, seed=n)
    assert repr(q.patterns) == repr(rq.patterns)
    assert [(e.src, e.dst, e.pred, e.generic) for e in g.edges] == \
        [(e.src, e.dst, e.pred, e.generic) for e in rg.edges]
    assert_same(stats.cs, rstats.cs, "cs")
    assert_same(stats.intra_cp, rstats.intra_cp, "intra_cp")
    assert sel.star_sources == rsel.star_sources
