from repro_torch.query.algebra import Term, Var, Const, TriplePattern, BGPQuery

__all__ = ["Term", "Var", "Const", "TriplePattern", "BGPQuery"]
