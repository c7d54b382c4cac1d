"""The port's SPARQL entry (``repro_torch.query.sparql``: ``parse_sparql``,
``serialize_sparql``) against the reference package's, on the CPU.  The same
text parses to equal algebra in both packages (the reference's query
rebuilt from the port's classes), ``serialize_sparql`` gives identical
strings, and the round trip reconstructs the group tree, on the FedBench
workload, the OPTIONAL/UNION/FILTER families, the reference tests' hand-made
group trees and seeded random ones.  Malformed and unsupported text raises
the same error, with the same message, in both."""
import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_batch_planner import to_port  # noqa: E402

from repro.query import algebra as RA  # noqa: E402
from repro.query.sparql import parse_sparql as ref_parse  # noqa: E402
from repro.query.sparql import serialize_sparql as ref_serialize  # noqa: E402
from repro.rdf.generator import fedbench_like_spec as ref_spec  # noqa: E402
from repro.rdf.generator import generate_extended_workload as ref_ext  # noqa: E402
from repro.rdf.generator import generate_federation as ref_gen  # noqa: E402
from repro.rdf.generator import generate_workload as ref_workload  # noqa: E402
from repro_torch.query import parse_sparql  # noqa: E402
from repro_torch.query.sparql import serialize_sparql  # noqa: E402
from repro_torch.rdf.generator import (  # noqa: E402
    fedbench_like_spec,
    generate_extended_workload,
    generate_federation,
    generate_workload,
)


@pytest.fixture(scope="module")
def both():
    """``(port, reference)``, each ``(fed, gt, queries)`` from the same
    seeds: the BGP workload and the algebra families."""
    out = []
    for spec, gen, wl, ext in (
            (fedbench_like_spec, generate_federation, generate_workload,
             generate_extended_workload),
            (ref_spec, ref_gen, ref_workload, ref_ext)):
        fed, gt = gen(spec(scale=0.06, seed=3))
        out.append((fed, gt, wl(fed, gt, seed=5) + ext(fed, gt, seed=17)))
    return out


def round_trip(q, rq, d, rd, exact=True):
    """Serialize both, hold the strings equal, parse both, and hold the
    parsed queries equal to each other and the group tree to ``q``'s.  With
    ``exact=False`` the parser may regroup the tree (a UNION nested in a
    UNION comes back flat, in both packages), so the parsed tree is held to
    be a fixed point of the round trip instead."""
    text, rtext = serialize_sparql(q, d), ref_serialize(rq, rd)
    assert text == rtext
    q2, rq2 = parse_sparql(text, d), ref_parse(rtext, rd)
    assert to_port(rq2) == q2
    if exact:
        assert q2.algebra() == q.algebra()
    else:
        text2 = serialize_sparql(q2, d)
        assert text2 == ref_serialize(rq2, rd)
        assert parse_sparql(text2, d).algebra() == q2.algebra()
    assert (q2.distinct, q2.projection) == (q.distinct, q.projection)
    assert len(d) == len(rd)
    return text


def test_workload_round_trips_as_the_reference(both):
    (fed, _, queries), (rfed, _, rqueries) = both
    assert {q.name[:2] for q in queries} >= {"ST", "OS", "UN", "FC"}
    for q, rq in zip(queries, rqueries):
        assert to_port(rq) == q
        text = round_trip(q, rq, fed.dictionary, rfed.dictionary)
        q2 = parse_sparql(text, fed.dictionary)
        assert q2.patterns == q.patterns, q.name


def _cases(A, d):
    """``tests/test_algebra.py``'s hand-made group trees, built from module
    ``A``'s classes."""
    p1, p2, p3 = 0, 1, 2
    tp, V, C = A.TriplePattern, A.Var, A.Const
    star = A.Bgp((tp(V("x"), C(p1), V("y")), tp(V("x"), C(p2), V("z"))))
    arm = A.Bgp((tp(V("x"), C(p3), V("o")),))
    return [
        A.from_algebra(star, projection=["x", "y"]),
        A.from_algebra(A.LeftJoin(star, arm), projection=["x", "o"]),
        A.from_algebra(A.LeftJoin(star, A.LeftJoin(
            arm, A.Bgp((tp(V("o"), C(p1), V("w")),)))),
            distinct=True, projection=["x"]),
        A.from_algebra(A.Union((star, A.Bgp((tp(V("x"), C(p3), V("y")),)))),
                       projection=["x"]),
        A.from_algebra(A.Filter(A.And((
            A.Comparison("!=", V("y"), V("z")),
            A.Or((A.Comparison("<", V("y"), C(4)),
                  A.Not(A.Comparison("=", V("z"), C(2))))))), star),
            projection=["x"]),
        A.from_algebra(A.LeftJoin(A.Filter(A.Comparison(">=", V("y"), C(1)),
                                           star), arm),
                       projection=["x", "o"]),
    ]


def test_group_trees_round_trip_as_the_reference(both):
    from repro_torch.query import algebra as A

    (fed, _, _), (rfed, _, _) = both
    for q, rq in zip(_cases(A, fed.dictionary), _cases(RA, rfed.dictionary)):
        assert to_port(rq) == q
        round_trip(q, rq, fed.dictionary, rfed.dictionary)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_group_trees_round_trip_as_the_reference(both, seed):
    """Seeded random group trees (``tests/test_algebra.py``'s generator,
    reference classes), rebuilt from the port's classes."""
    from test_algebra import _random_tree, _star_leaves

    (fed, _, _), (rfed, rgt, _) = both
    rng = np.random.default_rng(500 + seed)
    leaves = _star_leaves(rfed, rgt, rng)
    for _ in range(8):
        root = _random_tree(rng, leaves, depth=int(rng.integers(1, 4)))
        rq = RA.from_algebra(root, distinct=bool(rng.random() < 0.5),
                             projection=sorted(RA.certain_variables(root)))
        round_trip(to_port(rq), rq, fed.dictionary, rfed.dictionary,
                   exact=False)


BAD = {
    "GRAPH": "SELECT * WHERE { GRAPH ?g { ?x ?p ?y } }",
    "SERVICE": "SELECT * WHERE { SERVICE <http://ex.org/sparql> { ?x ?p ?y } }",
    "MINUS": "SELECT * WHERE { ?x ?p ?y MINUS { ?x ?q ?y } }",
    "BIND": "SELECT * WHERE { BIND (?x = ?y) }",
    "VALUES": "SELECT * WHERE { VALUES ?x { 1 } }",
    "ASK": "ASK WHERE { ?x ?p ?y }",
    "end": "SELECT * WHERE { ?x ?p",
    "unterminated": "SELECT ?x WHERE { ?x ?p ?y .",
    "dangling": "SELECT * WHERE { ?x ?p { ?a ?b ?c } }",
    "operator": "SELECT * WHERE { ?x ?p ?y FILTER (?x ?y) }",
    "term": "SELECT * WHERE { ?x ?p ?y FILTER (( ?x = ?y ) = ?y) }",
    "WHERE": "SELECT ?x { ?x ?p ?y }",
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_text_raises_as_the_reference(both, case):
    (fed, _, _), (rfed, _, _) = both
    with pytest.raises(Exception) as want:
        ref_parse(BAD[case], rfed.dictionary)
    with pytest.raises(Exception) as got:
        parse_sparql(BAD[case], fed.dictionary)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    if case.isupper():
        assert case in str(got.value)


def test_quickstart_query_parses_as_the_reference(both):
    """``examples/quickstart.py``'s hybrid query (prefixed names, DISTINCT,
    a projection), the port's entry point."""
    (fed, _, _), (rfed, _, _) = both
    text = """
    SELECT DISTINCT ?x ?y WHERE {
      ?x owl:sameAs ?y .
      ?x lmdb:sequel ?s .
      ?y rdf:type ?t .
    }"""
    n = len(fed.dictionary)
    q, rq = parse_sparql(text, fed.dictionary), ref_parse(text, rfed.dictionary)
    assert to_port(rq) == q and len(q.patterns) == 3
    assert q.distinct and q.projection == ["x", "y"]
    assert len(fed.dictionary) == len(rfed.dictionary) >= n
    round_trip(q, rq, fed.dictionary, rfed.dictionary)
