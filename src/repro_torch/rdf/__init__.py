from repro_torch.rdf.dictionary import TermDict, TermKind
from repro_torch.rdf.dataset import TripleTable, Source, Federation
from repro_torch.rdf.generator import FederationSpec, SourceSpec, generate_federation, fedbench_like_spec

__all__ = [
    "TermDict",
    "TermKind",
    "TripleTable",
    "Source",
    "Federation",
    "FederationSpec",
    "SourceSpec",
    "generate_federation",
    "fedbench_like_spec",
]
