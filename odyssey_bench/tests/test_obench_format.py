"""BENCHMARK.json keeps to its format's rules, and every name it gives
is found as a file: configurations, traffic mixes, generators, readers."""
import importlib
import json
import re

import pytest

from odyssey_bench.harness import BENCH, ROOT, load_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|width|_dim$|_rank$)")


@pytest.fixture(scope="module")
def bench():
    return load_benchmark()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert all(not w.startswith("/") and ".." not in w for w in bench["command"])


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names += [e["name"] for e in bench[group]]
    for c in bench["configs"]:
        names += c["reduced"]
    for w in bench["workloads"]:
        names += [w["config"], w["traffic"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in bench[group]]
        assert len(got) == len(set(got))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configurations(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert 1 <= len(bench["configs"]) <= 24
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])
        assert cfg["executor"] in ("spmd", "local")


def test_cells(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        importlib.import_module(f"odyssey_bench.gen.{mix['generator']}")
        assert mix["loop"]["kind"] == "closed"
        assert _line(mix["source"]) and "FedBench" in mix["source"]


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells

    def reports(cell):
        return {n for n, m in e2e.items() if cell in m.get("workloads", cells)}

    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and m["moves"] in reports(cell)
    for cell in cells:
        assert "setup_s" in reports(cell) and len(reports(cell)) >= 2
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


PUBLISHED = ("triples", "subjects", "predicates", "objects", "types", "links")


def test_sources_carry_fedbench_statistics_and_one_scale(bench):
    """Every source gives its dataset's published statistics; only ``scale``
    is cut, and a dataset in two configurations gives the same numbers."""
    seen = {}
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == ["scale"] and 0 < cfg["scale"] < 1
        for ss in cfg["sources"]:
            assert set(ss["published"]) == set(PUBLISHED)
            assert all(isinstance(ss["published"][k], int) for k in PUBLISHED)
            assert seen.setdefault(ss["name"], ss["published"]) == ss["published"]
            names = {s["name"] for s in cfg["sources"]}
            for x in ss["properties"]:
                target = x["objects"]
                assert (target.split(":", 1)[1] in cfg["value_pools"]
                        if target.startswith("values:") else target in names)
