"""Synthetic RDF federation generator (FedBench stand-in, DESIGN.md §6).

The real FedBench datasets are not available offline, so we synthesize a
federation with the same *structure*: each source has a population of
characteristic-set templates (Zipf-distributed entity counts), predicates drawn
from shared + source-local pools, per-(entity, predicate) triple multiplicities
> 1 (so DISTINCT vs non-DISTINCT estimation differs), and *link predicates*
whose objects are entities of another source — the federated joins Odyssey's
federated CPs capture.

The generator also emits LD/CD/LS-style query workloads (star + hybrid shapes,
2–7 triple patterns) that are guaranteed to have non-empty answers, plus ground
truth needed by tests (entity -> template assignment, cross-source link lists).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.query.algebra import BGPQuery, Const, TriplePattern, Var
from repro_torch.rdf.dataset import Federation, Source, TripleTable
from repro_torch.rdf.dictionary import TermDict, TermKind

SHARED_PREDS = ["rdf:type", "rdfs:label", "foaf:name", "owl:sameAs", "skos:subject"]


@dataclass
class LinkSpec:
    pred: str            # predicate IRI (prefixed)
    target: str          # target source name
    density: float = 0.3  # fraction of templates that carry this link


@dataclass
class SourceSpec:
    name: str
    n_entities: int = 1000
    n_templates: int = 12
    n_local_preds: int = 20
    template_size: tuple[int, int] = (3, 7)
    multiplicity_p: float = 0.35   # P(extra triple per (e, pred)), geometric
    zipf_a: float = 1.4
    links: list[LinkSpec] = field(default_factory=list)
    n_classes: int = 6             # rdf:type object pool
    literal_pool: int = 64         # distinct literals per (source, pred)
    authority: str | None = None   # shared namespaces weaken authority-only
                                   # pruning (HiBISCuS), as in real FedBench


@dataclass
class FederationSpec:
    sources: list[SourceSpec]
    seed: int = 0


@dataclass
class GroundTruth:
    """Ground truth for tests: per-source entity/template structure."""

    entity_template: dict[str, dict[int, int]]           # source -> entity id -> template idx
    template_preds: dict[str, list[list[int]]]           # source -> template idx -> pred ids
    template_entities: dict[str, list[np.ndarray]]       # source -> template idx -> entity ids
    cross_links: list[tuple[str, str, int, int, int]]    # (src, dst, s_ent, pred, o_ent)
    link_specs: dict[str, list[LinkSpec]]


def fedbench_like_spec(scale: float = 1.0, seed: int = 7) -> FederationSpec:
    """Nine sources with relative sizes/CS-counts shaped like FedBench Table 2."""

    def n(x: int) -> int:
        return max(16, int(x * scale))

    bio = "http://bio2rdf.org"  # shared namespace across the life-science trio
    chebi = SourceSpec("ChEBI", n_entities=n(1200), n_templates=14, n_local_preds=16,
                       authority=bio)
    kegg = SourceSpec("KEGG", n_entities=n(500), n_templates=6, n_local_preds=12,
                      authority=bio, links=[LinkSpec("kegg:compound", "ChEBI", 0.4)])
    drugbank = SourceSpec("Drugbank", n_entities=n(700), n_templates=20, n_local_preds=30,
                          authority=bio,
                          links=[LinkSpec("drugbank:target", "KEGG", 0.3),
                                 LinkSpec("owl:sameAs", "DBpedia", 0.25)])
    dbpedia = SourceSpec("DBpedia", n_entities=n(4000), n_templates=40, n_local_preds=60,
                         links=[LinkSpec("dbo:director", "DBpedia", 0.25),
                                LinkSpec("dbo:producer", "DBpedia", 0.2)])
    geonames = SourceSpec("Geonames", n_entities=n(3000), n_templates=8, n_local_preds=14,
                          links=[LinkSpec("gn:parentFeature", "Geonames", 0.5)])
    jamendo = SourceSpec("Jamendo", n_entities=n(600), n_templates=5, n_local_preds=12,
                         links=[LinkSpec("foaf:based_near", "Geonames", 0.4)])
    swdf = SourceSpec("SWDF", n_entities=n(300), n_templates=16, n_local_preds=26,
                      links=[LinkSpec("owl:sameAs", "DBpedia", 0.3)])
    lmdb = SourceSpec("LMDB", n_entities=n(1500), n_templates=18, n_local_preds=24,
                      links=[LinkSpec("owl:sameAs", "DBpedia", 0.35),
                             LinkSpec("lmdb:sequel", "LMDB", 0.15)])
    nytimes = SourceSpec("NYTimes", n_entities=n(400), n_templates=6, n_local_preds=12,
                         links=[LinkSpec("owl:sameAs", "DBpedia", 0.5),
                                LinkSpec("nyt:mentions", "Geonames", 0.3)])
    return FederationSpec(
        sources=[chebi, kegg, drugbank, dbpedia, geonames, jamendo, swdf, lmdb, nytimes],
        seed=seed,
    )


def generate_federation(spec: FederationSpec) -> tuple[Federation, GroundTruth]:
    rng = np.random.default_rng(spec.seed)
    d = TermDict()
    shared_pred_ids = [d.add(p, TermKind.IRI) for p in SHARED_PREDS]

    # --- allocate entity id pools per source (IRIs with per-source authority)
    entity_ids: dict[str, np.ndarray] = {}
    for ss in spec.sources:
        auth = ss.authority or f"http://{ss.name.lower()}.org"
        ids = np.array(
            [d.add(f"{auth}/{ss.name.lower()}/e{i}", TermKind.IRI, authority=auth)
             for i in range(ss.n_entities)],
            dtype=np.int32,
        )
        entity_ids[ss.name] = ids

    gt = GroundTruth({}, {}, {}, [], {ss.name: list(ss.links) for ss in spec.sources})
    sources: list[Source] = []

    for ss in spec.sources:
        local_preds = [d.add(f"{ss.name.lower()}:p{i}", TermKind.IRI) for i in range(ss.n_local_preds)]
        link_pred_ids = {lk.pred: d.add(lk.pred, TermKind.IRI) for lk in ss.links}
        class_ids = [d.add(f"{ss.name.lower()}:Class{i}", TermKind.IRI) for i in range(ss.n_classes)]
        rdf_type = shared_pred_ids[0]

        # --- build templates -------------------------------------------------
        templates: list[list[int]] = []
        template_link: list[list[tuple[int, str]]] = []  # per template: (pred id, target source)
        for t in range(ss.n_templates):
            size = int(rng.integers(ss.template_size[0], ss.template_size[1] + 1))
            pool = local_preds + shared_pred_ids[:3]  # type/label/name always possible
            preds = list(rng.choice(pool, size=min(size, len(pool)), replace=False))
            if rdf_type not in preds:
                preds.append(rdf_type)
            links_here: list[tuple[int, str]] = []
            for lk in ss.links:
                if rng.random() < lk.density:
                    pid = link_pred_ids[lk.pred]
                    if pid not in preds:
                        preds.append(pid)
                    links_here.append((pid, lk.target))
            templates.append(sorted(set(int(p) for p in preds)))
            template_link.append(links_here)

        # --- assign entities to templates (Zipf weights) ----------------------
        w = 1.0 / np.arange(1, ss.n_templates + 1) ** ss.zipf_a
        w /= w.sum()
        assign = rng.choice(ss.n_templates, size=ss.n_entities, p=w)
        ents = entity_ids[ss.name]
        tmpl_entities = [ents[assign == t] for t in range(ss.n_templates)]

        # --- literal pools ---------------------------------------------------
        lit_pool: dict[int, np.ndarray] = {}

        def literals_for(pred: int) -> np.ndarray:
            if pred not in lit_pool:
                lit_pool[pred] = np.array(
                    [d.add(f"lit:{ss.name}:{pred}:{i}", TermKind.LITERAL) for i in range(ss.literal_pool)],
                    dtype=np.int32,
                )
            return lit_pool[pred]

        # --- emit triples ----------------------------------------------------
        S: list[np.ndarray] = []
        P: list[np.ndarray] = []
        O: list[np.ndarray] = []
        for t, preds in enumerate(templates):
            es = tmpl_entities[t]
            if len(es) == 0:
                continue
            link_map = dict(template_link[t])
            for pred in preds:
                # multiplicity per entity: 1 + Geometric(p)
                mult = 1 + rng.geometric(1.0 - ss.multiplicity_p, size=len(es)) - 1
                mult = np.clip(mult, 1, 4)
                subs = np.repeat(es, mult)
                k = len(subs)
                if pred == rdf_type:
                    objs = rng.choice(class_ids, size=k)
                elif pred in link_map:
                    target = link_map[pred]
                    objs = rng.choice(entity_ids[target], size=k)
                    if target != ss.name:
                        for s_e, o_e in zip(subs.tolist(), objs.tolist()):
                            gt.cross_links.append((ss.name, target, s_e, pred, o_e))
                else:
                    objs = rng.choice(literals_for(pred), size=k)
                S.append(subs)
                P.append(np.full(k, pred, dtype=np.int32))
                O.append(np.asarray(objs, dtype=np.int32))

        table = TripleTable.from_triples(np.concatenate(S), np.concatenate(P), np.concatenate(O))
        sources.append(Source(name=ss.name, table=table))
        gt.entity_template[ss.name] = {int(e): int(t) for e, t in zip(ents.tolist(), assign.tolist())}
        gt.template_preds[ss.name] = templates
        gt.template_entities[ss.name] = tmpl_entities

    return Federation(sources=sources, dictionary=d), gt


# --------------------------------------------------------------------------
# Query workload generation (LD/CD/LS-style)
# --------------------------------------------------------------------------

def _star_patterns(rng: np.random.Generator, fed: Federation, gt: GroundTruth,
                   src: str, tmpl: int, var: str, k: int,
                   bind_obj: bool) -> "list[TriplePattern] | None":
    """A k-pattern star over one template's predicates (subject ``?var``),
    optionally grounding one object so the star has a bound constant.
    Non-empty by construction: every template entity matches."""
    preds = gt.template_preds[src][tmpl]
    ents = gt.template_entities[src][tmpl]
    if len(ents) == 0 or len(preds) < k:
        return None
    chosen = rng.choice(preds, size=k, replace=False)
    table = fed.by_name(src).table
    pats = []
    for j, pred in enumerate(chosen.tolist()):
        if bind_obj and j == 0:
            e = int(rng.choice(ents))
            rows = table.scan(e, int(pred), None)
            if len(rows) == 0:
                return None
            obj = int(table.o[rows[0]])
            pats.append(TriplePattern(Var(var), Const(int(pred)), Const(obj)))
        else:
            pats.append(TriplePattern(Var(var), Const(int(pred)), Var(f"{var}_v{j}")))
    return pats


def generate_workload(
    fed: Federation,
    gt: GroundTruth,
    n_star: int = 10,
    n_hybrid: int = 10,
    n_path: int = 5,
    seed: int = 13,
) -> list[BGPQuery]:
    """Star, hybrid (two linked stars) and path-ish queries with non-empty answers."""
    rng = np.random.default_rng(seed)
    queries: list[BGPQuery] = []

    def star_patterns(src: str, tmpl: int, var: str, k: int, bind_obj: bool) -> list[TriplePattern] | None:
        return _star_patterns(rng, fed, gt, src, tmpl, var, k, bind_obj)

    src_names = [s.name for s in fed.sources]

    made = 0
    attempts = 0
    while made < n_star and attempts < 200:
        attempts += 1
        src = str(rng.choice(src_names))
        tmpl = int(rng.integers(len(gt.template_preds[src])))
        k = int(rng.integers(2, 5))
        pats = star_patterns(src, tmpl, "x", k, bind_obj=bool(rng.random() < 0.4))
        if pats is None:
            continue
        queries.append(BGPQuery(pats, distinct=bool(rng.random() < 0.5), projection=["x"], name=f"ST{made + 1}"))
        made += 1

    # hybrid: star(x) -- link pred --> star(y)
    links = gt.cross_links
    made = 0
    attempts = 0
    while made < n_hybrid and attempts < 400 and links:
        attempts += 1
        (src, dst, s_e, pred, o_e) = links[int(rng.integers(len(links)))]
        t1 = gt.entity_template[src][s_e]
        t2 = gt.entity_template[dst][o_e]
        k1 = int(rng.integers(1, 4))
        k2 = int(rng.integers(1, 4))
        p1 = star_patterns(src, t1, "x", k1, bind_obj=False)
        p2 = star_patterns(dst, t2, "y", k2, bind_obj=False)
        if p1 is None or p2 is None:
            continue
        bridge = TriplePattern(Var("x"), Const(int(pred)), Var("y"))
        queries.append(
            BGPQuery(p1 + [bridge] + p2, distinct=bool(rng.random() < 0.5), projection=["x", "y"],
                     name=f"HY{made + 1}")
        )
        made += 1

    # path: x --p--> y --q--> z (chains through intra-source links)
    made = 0
    attempts = 0
    while made < n_path and attempts < 400 and links:
        attempts += 1
        (src, dst, s_e, pred, o_e) = links[int(rng.integers(len(links)))]
        t2 = gt.entity_template[dst][o_e]
        preds2 = gt.template_preds[dst][t2]
        if not preds2:
            continue
        q = int(rng.choice(preds2))
        pats = [
            TriplePattern(Var("x"), Const(int(pred)), Var("y")),
            TriplePattern(Var("y"), Const(q), Var("z")),
        ]
        queries.append(BGPQuery(pats, distinct=True, projection=["x", "z"], name=f"PA{made + 1}"))
        made += 1

    return queries


# --------------------------------------------------------------------------
# Extended (group-algebra) workload: OPTIONAL / UNION / FILTER families
# --------------------------------------------------------------------------

def generate_extended_workload(
    fed: Federation,
    gt: GroundTruth,
    n_optional: int = 6,
    n_union: int = 6,
    n_filtered: int = 4,
    seed: int = 17,
) -> list[BGPQuery]:
    """Seeded group-tree queries over the synthetic federation, three families:

    * **OS** (optional-star): a template star plus 1–2 OPTIONAL arms whose
      predicates come from *other* templates of the same source, so some
      answers carry UNDEF — the arms are genuinely partial.
    * **UN** (union-of-templates): one star shape instantiated over two
      different (source, template) pairs, branches sharing variable names.
    * **FC** (filtered-chain): a cross-source chain or a star with a
      ``!=`` FILTER over distinct object variables (always satisfiable —
      distinct literal pools — so answers stay non-empty).

    Every query carries a non-degenerate group tree (``query.root`` is set);
    the conjunctive parts reuse the template machinery of
    ``generate_workload`` so answers are non-empty by construction."""
    from repro_torch.query.algebra import (
        Bgp,
        Comparison,
        Filter,
        LeftJoin,
        Union,
        from_algebra,
    )

    rng = np.random.default_rng(seed)
    queries: list[BGPQuery] = []
    src_names = [s.name for s in fed.sources]

    # -- OS: star + 1-2 OPTIONAL arms ---------------------------------------
    made = 0
    attempts = 0
    while made < n_optional and attempts < 400:
        attempts += 1
        src = str(rng.choice(src_names))
        tmpl = int(rng.integers(len(gt.template_preds[src])))
        base = _star_patterns(rng, fed, gt, src, tmpl, "x",
                              int(rng.integers(2, 4)), bind_obj=False)
        if base is None:
            continue
        here = set(gt.template_preds[src][tmpl])
        elsewhere = sorted({p for t in gt.template_preds[src] for p in t} - here)
        if not elsewhere:
            continue
        n_arms = int(rng.integers(1, 3))
        arm_preds = rng.choice(elsewhere, size=min(n_arms, len(elsewhere)),
                               replace=False)
        node = Bgp(tuple(base))
        opt_vars = []
        for a, pred in enumerate(arm_preds.tolist()):
            ov = f"o{a}"
            node = LeftJoin(node, Bgp((TriplePattern(Var("x"), Const(int(pred)),
                                                     Var(ov)),)))
            opt_vars.append(ov)
        queries.append(from_algebra(node, distinct=bool(rng.random() < 0.5),
                                    projection=["x", *opt_vars],
                                    name=f"OS{made + 1}"))
        made += 1

    # -- UN: the same star shape over two templates -------------------------
    made = 0
    attempts = 0
    while made < n_union and attempts < 400:
        attempts += 1
        src_a = str(rng.choice(src_names))
        src_b = str(rng.choice(src_names))
        t_a = int(rng.integers(len(gt.template_preds[src_a])))
        t_b = int(rng.integers(len(gt.template_preds[src_b])))
        if (src_a, t_a) == (src_b, t_b):
            continue
        k = int(rng.integers(2, 4))
        b_a = _star_patterns(rng, fed, gt, src_a, t_a, "x", k, bind_obj=False)
        b_b = _star_patterns(rng, fed, gt, src_b, t_b, "x", k, bind_obj=False)
        if b_a is None or b_b is None:
            continue
        node = Union((Bgp(tuple(b_a)), Bgp(tuple(b_b))))
        queries.append(from_algebra(node, distinct=bool(rng.random() < 0.5),
                                    projection=["x"], name=f"UN{made + 1}"))
        made += 1

    # -- FC: chain/star with a != filter over distinct object variables -----
    links = gt.cross_links
    made = 0
    attempts = 0
    while made < n_filtered and attempts < 400:
        attempts += 1
        if links and rng.random() < 0.5:
            (src, dst, s_e, pred, o_e) = links[int(rng.integers(len(links)))]
            t2 = gt.entity_template[dst][o_e]
            preds2 = gt.template_preds[dst][t2]
            if not preds2:
                continue
            q = int(rng.choice(preds2))
            pats = [TriplePattern(Var("x"), Const(int(pred)), Var("y")),
                    TriplePattern(Var("y"), Const(q), Var("z"))]
            expr = Comparison("!=", Var("x"), Var("z"))
            proj = ["x", "z"]
        else:
            src = str(rng.choice(src_names))
            tmpl = int(rng.integers(len(gt.template_preds[src])))
            pats = _star_patterns(rng, fed, gt, src, tmpl, "x", 3,
                                  bind_obj=False)
            if pats is None:
                continue
            # distinct per-predicate literal pools: != always satisfiable
            expr = Comparison("!=", Var("x_v1"), Var("x_v2"))
            proj = ["x"]
        node = Filter(expr, Bgp(tuple(pats)))
        queries.append(from_algebra(node, distinct=bool(rng.random() < 0.5),
                                    projection=proj, name=f"FC{made + 1}"))
        made += 1

    return queries
