from repro_torch.baselines.fedx import FedXOptimizer
from repro_torch.baselines.void_dp import VoidDPOptimizer
from repro_torch.baselines.hibiscus import HibiscusOptimizer
from repro_torch.baselines.hybrids import FedXOdyssey, OdysseyFedX

__all__ = ["FedXOptimizer", "VoidDPOptimizer", "HibiscusOptimizer",
           "FedXOdyssey", "OdysseyFedX"]
