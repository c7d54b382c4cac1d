# The paper's primary contribution: Odyssey's federated statistics
# (characteristic sets/pairs, entity summaries, Algorithm 1) and the
# cost-based federated query optimizer built on them.
from repro_torch.core.characteristic_sets import CSStats, compute_characteristic_sets
from repro_torch.core.characteristic_pairs import CPStats, compute_characteristic_pairs

__all__ = [
    "CSStats",
    "compute_characteristic_sets",
    "CPStats",
    "compute_characteristic_pairs",
]
