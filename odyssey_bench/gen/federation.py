"""FedBench federations made from the published dataset statistics.

Each source of a configuration gives FedBench's own numbers for its
dataset (Schmidt et al., ISWC 2011, Table 1: triples, subjects, predicates,
objects, types and links to other datasets).  ``generate`` multiplies the
counts of triples, subjects, objects and links by the configuration's one
``scale`` and keeps the predicates and types as published.  What the table
does not give is named in the configuration as assumed: how subjects group
into characteristic sets (templates, Zipf-distributed), which predicates
link to which source, the predicates the FedBench queries follow inside a
source or through shared values, and how concentrated their objects are.

Every subject has one ``rdf:type`` triple; its template's other predicates
each get a geometric number of objects, so that triples per subject come
out as published.  Literal objects are spread over the predicates so that
distinct objects come out as published.  An object property's or link's
objects are drawn from the first ``max(16, n / object_hub)`` members of its
target, ``n`` its triple count: links land on a hub of popular entities, as
``owl:sameAs`` links do, so two sources' links meet.

The structure comes from the configuration's ``data_seed``; ``relabel``
then renumbers every term by a permutation drawn from the run's seed, so
each seed sees the same amount of work under other ids (and another split
of subjects over the model shards).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

RDF_TYPE = "rdf:type"
IRI, LITERAL = 0, 1


def authority_of(term: str, kind: int) -> str:
    """scheme://host for an IRI, the prefix for a prefixed name, one
    authority for every plain literal."""
    if kind == LITERAL:
        return "literal:plain"
    if "://" in term:
        scheme, rest = term.split("://", 1)
        return scheme + "://" + rest.split("/", 1)[0]
    if ":" in term:
        return term.split(":", 1)[0] + ":"
    return "urn:"


class _Terms:
    """Term strings in id order, with their kinds and authorities."""

    def __init__(self) -> None:
        self.terms: list[str] = []
        self.kinds: list[int] = []
        self.auth: list[str] = []
        self._index: dict[str, int] = {}

    def add(self, term: str, kind: int = IRI) -> int:
        tid = self._index.get(term)
        if tid is None:
            tid = len(self.terms)
            self.terms.append(term)
            self.kinds.append(kind)
            self.auth.append(authority_of(term, kind))
            self._index[term] = tid
        return tid

    def add_block(self, terms: list[str], kind: int, authority: str) -> int:
        """Terms known to be new, one authority; returns the first id."""
        first = len(self.terms)
        self.terms.extend(terms)
        self.kinds.extend([kind] * len(terms))
        self.auth.extend([authority] * len(terms))
        return first


@dataclass
class SourceData:
    name: str
    s: np.ndarray                     # int64 triples, duplicates possible
    p: np.ndarray
    o: np.ndarray
    first: int                        # this source's subjects: ids first..first+n-1
    n: int


@dataclass
class FederationData:
    sources: list
    terms: list                       # term string per id
    kinds: np.ndarray                 # IRI or LITERAL per id
    authorities: list                 # authority string per id
    preds: dict                       # named predicate -> id

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    def n_triples(self) -> int:
        return sum(len(s.s) for s in self.sources)


def _spread(rng, count: int, size: int) -> np.ndarray:
    """``count`` draws from ``range(size)`` that use every value once
    before any repeats (all of them where ``count >= size``)."""
    if count <= size:
        return rng.choice(size, count, replace=False)
    out = np.concatenate([np.arange(size), rng.integers(0, size, count - size)])
    return rng.permutation(out)


def _hub(n: int, size: int, ratio: float) -> int:
    return int(min(size, max(16, np.ceil(n / ratio))))


def generate(cfg: dict, seed: int) -> FederationData:
    """The federation of ``cfg['sources']`` at ``cfg['scale']``, its
    structure drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    scale = float(cfg["scale"])
    ratio = float(cfg.get("object_hub", 4))
    zipf_a = float(cfg.get("template_zipf", 1.4))
    specs = cfg["sources"]
    names = [ss["name"] for ss in specs]
    tb = _Terms()
    rdf_type = tb.add(RDF_TYPE)

    first: dict[str, int] = {}
    size: dict[str, int] = {}
    for ss in specs:
        n = max(16, int(round(ss["published"]["subjects"] * scale)))
        auth = ss["authority"]
        low = ss["name"].lower()
        first[ss["name"]] = tb.add_block([f"{auth}/{low}/e{i}" for i in range(n)], IRI, auth)
        size[ss["name"]] = n

    pools = cfg.get("value_pools", {})
    pool_first: dict[str, int] = {}
    pool_need: dict[str, int] = {}

    def targets(kind: str, n: int) -> tuple:
        """(first id or pool name, hub size) of ``n`` objects drawn from
        ``kind``: a source's subjects or ``values:<pool>``."""
        if kind.startswith("values:"):
            name = kind.split(":", 1)[1]
            hub = _hub(n, 1 << 62, ratio)
            pool_need[name] = max(pool_need.get(name, 0), hub)
            return name, hub
        return first[kind], _hub(n, size[kind], ratio)

    out: list = []
    pending: list = []                 # (source index, objects into a value pool)
    for si, ss in enumerate(specs):
        pub = ss["published"]
        low, n_subj = ss["name"].lower(), size[ss["name"]]
        ents = np.arange(first[ss["name"]], first[ss["name"]] + n_subj, dtype=np.int64)
        links = [lk for lk in ss.get("links", []) if lk["target"] in names]
        props = ss.get("properties", [])
        named = {x["pred"]: tb.add(x["pred"]) for x in links + props}
        n_types = int(pub["types"])
        classes = np.array([tb.add(f"{low}:Class{i}") for i in range(n_types)], np.int64)
        n_local = max(1, int(pub["predicates"]) - (n_types > 0) - len(named))
        local = np.array([tb.add(f"{low}:p{i}") for i in range(n_local)], np.int64)

        # characteristic sets: template sizes around the local triples a
        # subject needs, every local predicate in some template
        tps = max(1.0, pub["triples"] / pub["subjects"] - (n_types > 0))
        mean_k = max(1.0, min(tps, n_local / 2))
        lo_k, hi_k = max(1, int(mean_k / 2)), min(n_local, max(1, int(np.ceil(1.5 * mean_k))))
        n_t = max(int(ss.get("templates", 1)), int(np.ceil(1.5 * n_local / mean_k)))
        tmpl = [rng.choice(n_local, int(rng.integers(lo_k, hi_k + 1)), replace=False)
                for _ in range(n_t)]
        w = 1.0 / np.arange(1, n_t + 1) ** zipf_a
        assign = rng.choice(n_t, size=n_subj, p=w / w.sum())
        members = [ents[assign == t] for t in range(n_t)]
        # predicates no template with subjects drew go to the templates with
        # the fewest subjects, so that triples per subject stay near the
        # published
        held = [t for t in range(n_t) if len(members[t])]
        missing = rng.permutation(np.setdiff1d(
            np.arange(n_local), np.concatenate([tmpl[t] for t in held])))
        few = sorted(held, key=lambda t: len(members[t]))
        for k, pid in enumerate(missing):
            t = few[k % len(few)]
            tmpl[t] = np.append(tmpl[t], pid)
        # a property is on whole templates, drawn until they hold its share
        # of the subjects, or on the templates of the property it goes ``with``
        has_prop = []
        for x in props:
            if "with" in x:                 # on the same subjects as another
                has_prop.append(has_prop[[y["pred"] for y in props].index(x["with"])])
                continue
            h = np.zeros(n_t, bool)
            held = 0
            for t in rng.permutation(n_t):
                if held >= x["subjects"] * n_subj and h.any():
                    break
                h[t] = True
                held += len(members[t])
            has_prop.append(h)
        S, P, O = [], [], []
        ref_distinct = 0
        if n_types:
            S.append(ents)
            P.append(np.full(n_subj, rdf_type, np.int64))
            O.append(classes[_spread(rng, n_subj, n_types)])
        # object properties inside the source or into a shared value pool:
        # one object each for the subjects of the templates that have them
        for x, h in zip(props, has_prop):
            subs = np.concatenate([members[t] for t in np.flatnonzero(h)])
            base, hub = targets(x["objects"], len(subs))
            idx = rng.integers(0, hub, len(subs))
            ref_distinct += len(np.unique(idx))
            S.append(subs)
            P.append(np.full(len(subs), named[x["pred"]], np.int64))
            if isinstance(base, str):
                pending.append((si, len(O), base))
                O.append(idx.astype(np.int64))
            else:
                O.append(base + idx)
        # links to other sources: the published count at this scale, on
        # random subjects
        for lk in links:
            n = int(round(pub["links"] * lk["share"] * scale))
            if n == 0:
                continue
            subs = ents[_spread(rng, n, n_subj)]
            base, hub = targets(lk["target"], n)
            idx = rng.integers(0, hub, n)
            ref_distinct += len(np.unique(idx))
            S.append(subs)
            P.append(np.full(n, named[lk["pred"]], np.int64))
            O.append(base + idx)
        fixed = sum(len(x) for x in S)

        # the local predicates: multiplicities that bring the triples to the
        # published count, objects spread over literal pools that bring the
        # distinct objects to it
        # (a share of the slots is left empty where one object each is
        # already too many)
        slots = sum(len(members[t]) * len(tmpl[t]) for t in range(n_t))
        want = max(0.0, pub["triples"] * scale - fixed)
        mult_mean = want / max(slots, 1)
        blocks = []
        for t in range(n_t):
            es = members[t]
            if len(es) == 0:
                continue
            for j in tmpl[t]:
                if mult_mean <= 1.0:
                    mult = (rng.random(len(es)) < mult_mean).astype(np.int64)
                else:
                    mult = rng.geometric(1.0 / mult_mean, size=len(es))
                if mult.any():
                    blocks.append((int(j), np.repeat(es, mult)))
        per_pred = np.zeros(n_local, np.int64)
        for j, subs in blocks:
            per_pred[j] += len(subs)
        budget = max(n_local, int(pub["objects"] * scale) - n_types - ref_distinct)
        pool = np.maximum(1, np.minimum(
            per_pred, np.round(budget * per_pred / max(per_pred.sum(), 1)))).astype(np.int64)
        lit_first = np.zeros(n_local, np.int64)
        for j in range(n_local):
            if per_pred[j]:
                lit_first[j] = tb.add_block(
                    [f'"{low} {j} {i}"' for i in range(pool[j])], LITERAL, "literal:plain")
        drawn: dict[int, np.ndarray] = {
            j: _spread(rng, int(per_pred[j]), int(pool[j])) for j in range(n_local)
            if per_pred[j]}
        used = np.zeros(n_local, np.int64)
        for j, subs in blocks:
            k = len(subs)
            S.append(subs)
            P.append(np.full(k, local[j], np.int64))
            O.append(lit_first[j] + drawn[j][used[j]:used[j] + k])
            used[j] += k
        out.append(SourceData(name=ss["name"], s=S, p=P, o=O,
                              first=first[ss["name"]], n=n_subj))

    for name, need in pool_need.items():
        spec = pools[name]
        if spec.get("kind", "literal") == "literal":
            pool_first[name] = tb.add_block([f'"{name} {i}"' for i in range(need)],
                                            LITERAL, "literal:plain")
        else:
            pool_first[name] = tb.add_block([f"{spec['authority']}/{name}:{i}"
                                             for i in range(need)], IRI, spec["authority"])
    for si, k, name in pending:
        out[si].o[k] = out[si].o[k] + pool_first[name]
    for sd in out:
        sd.s, sd.p, sd.o = (np.concatenate(x) for x in (sd.s, sd.p, sd.o))
    preds = {RDF_TYPE: rdf_type}
    for ss in specs:
        for x in ss.get("links", []) + ss.get("properties", []):
            if x["pred"] in tb._index:
                preds[x["pred"]] = tb._index[x["pred"]]
    return FederationData(sources=out, terms=tb.terms, kinds=np.asarray(tb.kinds, np.int8),
                          authorities=tb.auth, preds=preds)


def relabel(fd: FederationData, perm: np.ndarray) -> FederationData:
    """The triples and terms of ``fd`` with term ``i`` renamed ``perm[i]``.
    Subject ranges and named predicates are left out: queries are drawn
    from ``fd`` and renamed with the same permutation."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    srcs = [SourceData(name=sd.name, s=perm[sd.s], p=perm[sd.p], o=perm[sd.o],
                       first=-1, n=0) for sd in fd.sources]
    order = inv.tolist()
    return FederationData(
        sources=srcs, terms=[fd.terms[i] for i in order], kinds=fd.kinds[inv],
        authorities=[fd.authorities[i] for i in order], preds={})


def permutation(n_terms: int, seed: int) -> np.ndarray:
    """The run's renaming of terms: a permutation of ``n_terms`` ids."""
    return np.random.default_rng([seed % 2**64, 1]).permutation(n_terms)
