"""Term dictionary: RDF terms (IRIs / literals) <-> dense int32 ids.

The federation shares one dictionary — equivalent to identifying entities by a
collision-free hash of their IRI, which is what Odyssey's summaries rely on.
Each term records its *authority* (scheme+host for IRIs, datatype for
literals); the entity summaries of §3.3 partition by authority instead of a
radix tree over full IRIs (DESIGN.md deviation D2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np


class TermKind(IntEnum):
    IRI = 0
    LITERAL = 1


@dataclass
class TermDict:
    terms: list[str] = field(default_factory=list)
    kinds: list[int] = field(default_factory=list)
    authorities: list[int] = field(default_factory=list)  # authority id per term
    _index: dict[str, int] = field(default_factory=dict)
    _auth_index: dict[str, int] = field(default_factory=dict)
    _auth_names: list[str] = field(default_factory=list)

    def authority_id(self, authority: str) -> int:
        aid = self._auth_index.get(authority)
        if aid is None:
            aid = len(self._auth_names)
            self._auth_index[authority] = aid
            self._auth_names.append(authority)
        return aid

    def add(self, term: str, kind: TermKind = TermKind.IRI, authority: str | None = None) -> int:
        tid = self._index.get(term)
        if tid is not None:
            return tid
        if authority is None:
            authority = _authority_of(term, kind)
        tid = len(self.terms)
        self.terms.append(term)
        self.kinds.append(int(kind))
        self.authorities.append(self.authority_id(authority))
        self._index[term] = tid
        return tid

    def id_of(self, term: str) -> int:
        return self._index[term]

    def term_of(self, tid: int) -> str:
        return self.terms[tid]

    def __len__(self) -> int:
        return len(self.terms)

    def authority_array(self) -> np.ndarray:
        return np.asarray(self.authorities, dtype=np.int32)

    @property
    def n_authorities(self) -> int:
        return len(self._auth_names)


def _authority_of(term: str, kind: TermKind) -> str:
    if kind == TermKind.LITERAL:
        return "literal:plain"
    # IRI: scheme://host
    if "://" in term:
        scheme, rest = term.split("://", 1)
        return scheme + "://" + rest.split("/", 1)[0]
    if ":" in term:  # prefixed form like dbr:Gary_Goetzman
        return term.split(":", 1)[0] + ":"
    return "urn:"
