"""The yardstick's own parts: the reference evaluator against a brute-force
one, the digest, the request stream's fixed work per seed, and the
generators against FedBench's statistics and query shapes."""
import itertools

import numpy as np
import pytest

from odyssey_bench.gen import stream
from odyssey_bench.reference import bgp


def _brute(triples, patterns, projection, distinct):
    """Every assignment of the patterns to triples, kept where consistent."""
    rows = []
    for combo in itertools.product(sorted(set(triples)), repeat=len(patterns)):
        bind = {}
        ok = True
        for tp, t in zip(patterns, combo):
            for term, val in zip(tp, t):
                if isinstance(term, str):
                    ok &= bind.setdefault(term, val) == val
                else:
                    ok &= term == val
        if ok:
            rows.append(tuple(bind[v] for v in projection))
    return sorted(set(rows)) if distinct else sorted(rows)


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_evaluate_matches_brute_force(seed, distinct):
    rng = np.random.default_rng(seed)
    n = 40
    s, p, o = (rng.integers(0, k, n) for k in (6, 3, 6))
    triples = list(zip(s.tolist(), p.tolist(), o.tolist())) * 2     # duplicates count once
    graph = bgp.Graph(np.asarray([t[0] for t in triples]), np.asarray([t[1] for t in triples]),
                      np.asarray([t[2] for t in triples]))
    queries = [((("x", 0, "a"), ("x", 1, "b")), ("x",)),
               ((("x", 0, "y"), ("y", 1, "z")), ("x", "z")),
               ((("x", 2, 3), ("x", 0, "y"), ("y", 1, "z")), ("x", "y")),
               ((("x", 0, "y"), ("x", 1, "y")), ("x", "y"))]
    for pats, proj in queries:
        got = bgp.evaluate(graph, pats, proj, distinct)
        want = _brute(triples, pats, proj, distinct)
        assert sorted(zip(*[c.tolist() for c in got])) == want


def test_digest_is_order_free_and_tells_rows_apart():
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 1000, 500), rng.integers(0, 1000, 500)
    perm = rng.permutation(500)
    assert bgp.digest([a, b]) == bgp.digest([a[perm], b[perm]])
    assert bgp.digest([a, b]) != bgp.digest([b, a])
    assert bgp.digest([a, b]) != bgp.digest([a[1:], b[1:]])
    c = a.copy()
    c[7] += 1
    assert bgp.digest([c, b]) != bgp.digest([a, b])
    assert bgp.digest([a.astype(np.int32), b]) == bgp.digest([a, b])


def test_popularity_is_zipf_in_every_prefix_and_seed_only_reorders():
    seqs = [stream.popularity_sequence(100, 1.0, 2000, 25, np.random.default_rng(s))
            for s in (1, 2)]
    assert len(seqs[0]) == 2000
    w = stream.zipf_weights(100, 1.0)
    for seq in seqs:
        for n in (200, 1000, 2000):
            counts = np.bincount(seq[:n], minlength=100)
            assert np.abs(counts - w * n).max() <= 26
    for k in range(0, 2000, 25):
        assert sorted(seqs[0][k:k + 25]) == sorted(seqs[1][k:k + 25])
    assert not np.array_equal(seqs[0], seqs[1])


def _small(config, scale):
    import json

    from odyssey_bench.harness import BENCH

    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg["scale"] = scale
    return cfg


@pytest.mark.parametrize("config,scale", [("fedbench-cdls", 0.005), ("fedbench-ls", 0.005)])
def test_federation_keeps_the_published_statistics(config, scale):
    """Triples, subjects, predicates and distinct objects per source come
    out as FedBench publishes them, times the one scale."""
    from odyssey_bench.gen import federation

    cfg = _small(config, scale)
    fd = federation.generate(cfg, cfg["data_seed"])
    for sd, ss in zip(fd.sources, cfg["sources"]):
        pub = ss["published"]
        assert len(np.unique(sd.s)) == max(16, round(pub["subjects"] * scale))
        assert abs(len(sd.s) / (pub["triples"] * scale) - 1) < 0.1, sd.name
        if pub["subjects"] * scale > 1000:
            assert abs(len(np.unique(sd.o)) / (pub["objects"] * scale) - 1) < 0.1, sd.name
            assert len(np.unique(sd.p)) >= 0.9 * pub["predicates"], sd.name
        assert sd.s.min() >= sd.first and sd.s.max() < sd.first + sd.n


@pytest.mark.parametrize("traffic,config,scale", [("cdls-queries.closed", "fedbench-cdls", 0.005),
                                                  ("ls-queries.closed", "fedbench-ls", 0.005)])
def test_every_pool_query_has_an_answer_and_its_shape(traffic, config, scale):
    """Each instance has the pattern count of the FedBench query it
    transcribes, and a non-empty answer."""
    import json

    from odyssey_bench.gen import federation, fedbench_queries
    from odyssey_bench.harness import BENCH

    cfg = _small(config, scale)
    mix = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    fd = federation.generate(cfg, cfg["data_seed"])
    spec = {**mix["pool"], "queries": [{**q, "count": 2} for q in mix["pool"]["queries"]]}
    pool = fedbench_queries.make_pool(fd, spec)
    graph = bgp.Graph(*(np.concatenate([getattr(sd, c) for sd in fd.sources]) for c in "spo"))
    shapes = {q["name"]: q for q in mix["pool"]["queries"]}
    assert len(pool) == 2 * len(shapes) and len({q.patterns for q in pool}) == len(pool)
    for q in pool:
        shape = shapes[q.name.split(".")[0]]
        n_pat = sum(n.get("typed", False) + n.get("bound", 0) + len(n.get("free", []))
                    + len(n.get("edges", [])) for n in shape["nodes"])
        assert len(q.patterns) == n_pat == shape["text"].count(" . ") + 1, q.name
        assert len(bgp.evaluate(graph, q.patterns, q.projection, q.distinct)[0]) > 0, q.name
