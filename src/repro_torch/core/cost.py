"""Cost model (paper §3.4): intermediate-result cardinalities + transfer.

"In our current implementation, the cost function is solely defined on the
cardinalities of intermediate results and how many results need to be
transferred between endpoints during execution." — we implement exactly that,
with the endpoint-characteristics extension point the paper mentions
(per-source weight multipliers).

Each formula exists in three forms: the scalar form used when costing a
single plan node, a vectorized form (``*_v``) over numpy arrays used by the
bitmask DP to cost every candidate partition of a subset at once, and the
float64 torch form ``join_candidates_params_torch`` — the plain version of
the pricing the CUDA kernels in ``repro_torch.kernels.dp_layer`` perform
(``dp_backend='torch'``).  The vectorized and torch forms keep the exact
operation order of the scalar ones — the same additions and
multiplications, associated the same way, no fused multiply-add — so all
paths produce bit-identical float64 costs for the same inputs.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# cross-*block* join selectivity: blocks (conjunctive cores of the group
# tree) join on shared variables the CS/CP statistics do not describe, so
# each shared variable contributes this generic factor — the same fallback
# ``repro_torch.core.join_order`` uses for non object->subject edges inside a BGP
CROSS_BLOCK_SELECTIVITY = 1e-3

# filter selectivity priors (System-R style): equality is selective,
# inequality keeps about a third, disequality drops almost nothing
FILTER_EQ_SELECTIVITY = 0.1
FILTER_NEQ_SELECTIVITY = 0.9
FILTER_RANGE_SELECTIVITY = 1.0 / 3.0


@dataclass
class CostModel:
    intermediate_weight: float = 1.0
    transfer_weight: float = 1.0
    request_cost: float = 5.0           # per subquery dispatched
    bind_batch: int = 20                # bindings shipped per bind-join request
    source_weight: dict[int, float] = field(default_factory=dict)  # endpoint tuning

    def src_w(self, sources: "list[int]") -> float:
        # empty `sources` (a star pruned to zero endpoints) weighs 1.0, like
        # an unknown id — leaf costing must not crash on an unsatisfiable
        # star just because per-endpoint weights are configured
        if not self.source_weight or not sources:
            return 1.0
        return max(self.source_weight.get(s, 1.0) for s in sources)

    def leaf_cost(self, card: float, sources: "list[int]") -> float:
        """Evaluate a (possibly merged/exclusive) subquery at its endpoints and
        ship the result rows to the engine."""
        return (self.transfer_weight * card * self.src_w(sources)
                + self.request_cost * max(1, len(sources)))

    def hash_join_cost(self, card_out: float) -> float:
        """Both inputs are already at the engine (their own costs cover the
        shipping); the join itself only materializes intermediates."""
        return self.intermediate_weight * card_out

    def bind_join_cost(self, card_left: float, card_out: float,
                       right_sources: "list[int]") -> float:
        """Ship the left bindings to the right subquery's endpoints in batches
        and receive only the matching rows — replaces the right leaf's cost."""
        n_req = max(1.0, card_left / self.bind_batch) * max(1, len(right_sources))
        return (self.request_cost * n_req
                + self.transfer_weight * card_out * self.src_w(right_sources)
                + self.intermediate_weight * card_out)

    # -- group-tree composition (OPTIONAL / UNION / FILTER plan nodes) -------
    # Blocks (conjunctive cores) are priced by the DP above; these forms
    # compose block estimates through the non-conjunctive operators so the
    # extended plans stay measurable end to end (docs/algebra.md).

    def cross_join_card(self, card_a: float, card_b: float,
                        n_shared_vars: int) -> float:
        """Cardinality of joining two planned blocks: independence times a
        generic per-shared-variable selectivity (cartesian when disjoint)."""
        sel = CROSS_BLOCK_SELECTIVITY ** n_shared_vars
        return card_a * card_b * sel

    def left_join_card(self, card_left: float, card_join: float) -> float:
        """OPTIONAL output estimate: the join estimate plus the unmatched-left
        surplus — every left row survives, matched or not."""
        return card_join + max(0.0, card_left - card_join)

    def union_card(self, cards: "list[float]") -> float:
        """UNION output estimate: branches are disjoint alternatives."""
        return float(sum(cards))

    def filter_selectivity(self, expr) -> float:
        """Selectivity prior of a filter expression (recursive over the
        ``repro_torch.query.algebra`` Expr tree; conjunction multiplies, disjunction
        is inclusion-exclusion under independence, negation complements)."""
        from repro_torch.query.algebra import And, Comparison, Not, Or

        if isinstance(expr, Comparison):
            if expr.op == "=":
                return FILTER_EQ_SELECTIVITY
            if expr.op == "!=":
                return FILTER_NEQ_SELECTIVITY
            return FILTER_RANGE_SELECTIVITY
        if isinstance(expr, And):
            s = 1.0
            for p in expr.parts:
                s *= self.filter_selectivity(p)
            return s
        if isinstance(expr, Or):
            s = 1.0
            for p in expr.parts:
                s *= 1.0 - self.filter_selectivity(p)
            return 1.0 - s
        if not isinstance(expr, Not):
            raise TypeError(f"not a filter expression: {expr!r}")
        return 1.0 - self.filter_selectivity(expr.part)

    def left_join_cost(self, card_out: float) -> float:
        """Both inputs already costed; the outer join materializes the
        matched-plus-surplus output like a hash join does."""
        return self.intermediate_weight * card_out

    def union_cost(self, card_out: float) -> float:
        return self.intermediate_weight * card_out

    def filter_cost(self, card_out: float) -> float:
        return self.intermediate_weight * card_out

    # -- vectorized forms (arrays of candidates at once) ---------------------

    def leaf_cost_v(self, card: np.ndarray, n_src: np.ndarray,
                    src_w: np.ndarray | float) -> np.ndarray:
        """``leaf_cost`` over arrays: ``card``/``n_src``/``src_w`` aligned."""
        return (self.transfer_weight * card * src_w
                + self.request_cost * np.maximum(1, n_src))

    def hash_join_cost_v(self, card_out: np.ndarray) -> np.ndarray:
        return self.intermediate_weight * card_out

    def bind_join_cost_v(self, card_left: np.ndarray, card_out: np.ndarray,
                         n_src: np.ndarray, src_w: np.ndarray | float) -> np.ndarray:
        """``bind_join_cost`` over candidate arrays; ``n_src`` must already be
        >= 1 (callers mask out source-less right sides)."""
        n_req = np.maximum(1.0, card_left / self.bind_batch) * n_src
        return (self.request_cost * n_req
                + self.transfer_weight * card_out * src_w
                + self.intermediate_weight * card_out)

    def join_candidates_v(self, cost_a: np.ndarray, cost_b: np.ndarray,
                          card_out: np.ndarray, hash_out: np.ndarray,
                          card_a: np.ndarray, n_src_b: np.ndarray,
                          src_w_b: np.ndarray,
                          bindable_b: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
        """Blockwise candidate costing for one flat tile of (A, B) partition
        pairs: the hash-join cost of every pair, replaced by the bind-join
        alternative where the right side is dispatchable as one subquery and
        strictly cheaper.  Returns ``(cost, is_bind)``; hash wins ties
        because the reference enumerates hash before bind.  ``hash_out`` is
        ``hash_join_cost_v(card_out)``, precomputed once per subset so tiles
        share it; operation order matches the scalar forms exactly."""
        hc = cost_a + cost_b
        hc = hc + hash_out
        bc = cost_a + self.bind_join_cost_v(card_a, card_out, n_src_b, src_w_b)
        is_bind = bindable_b & (bc < hc)
        return np.where(is_bind, bc, hc), is_bind

    # -- torch twin (plain version of the kernels' pricing) -----------------
    # torch is imported lazily so the numpy planning path never pays for it.

    @staticmethod
    def join_candidates_params_torch(params, cost_a, cost_b, card_out,
                                     card_a, n_src_b, src_w_b, bindable_b):
        """``join_candidates_v`` over float64 torch tensors, with the cost-
        model parameters as a ``(iw, tw, rc, bb)`` tuple of python floats
        ``(intermediate_weight, transfer_weight, request_cost, bind_batch)``
        — the form the CUDA kernels take as scalar arguments.  The hash-join
        term is derived from ``card_out`` in place (``iw * card_out``, the
        same single multiply as ``hash_join_cost_v``), and every
        addition/multiplication associates exactly as in the scalar/``*_v``
        forms (no ``addcmul`` or other fused op), so costs stay bit-identical
        to the numpy path.  Operands may broadcast."""
        import torch

        iw, tw, rc, bb = (float(v) for v in params)
        hc = cost_a + cost_b
        hc = hc + iw * card_out
        n_req = torch.clamp_min(card_a / bb, 1.0) * n_src_b
        bc = cost_a + ((rc * n_req + tw * card_out * src_w_b)
                       + iw * card_out)
        is_bind = bindable_b & (bc < hc)
        return torch.where(is_bind, bc, hc), is_bind


def estimation_error(est: float, obs: float) -> float:
    """Symmetric log-scale q-error between an estimated and an observed
    cardinality: ``|log2((obs + 1) / (est + 1))|``.  The ``+1`` keeps zero
    cardinalities finite, and the log makes over- and under-estimation by the
    same factor score identically — an error of 1.0 means "off by 2x", 2.0
    means "off by 4x".  This is the score the reference's ``repro.stats.feedback`` averages
    per source to decide when observed executions have drifted far enough
    from the statistics to warrant a ``refresh_source``."""
    return abs(float(np.log2((float(obs) + 1.0) / (float(est) + 1.0))))
