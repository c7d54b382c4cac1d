from repro_torch.query.algebra import Term, Var, Const, TriplePattern, BGPQuery
from repro_torch.query.sparql import parse_sparql

__all__ = ["Term", "Var", "Const", "TriplePattern", "BGPQuery", "parse_sparql"]
