"""Launch helpers of the port: the meshes of the SPMD federation executor
(``mesh``) and its self-test (``python -m repro_torch.launch.dist_selftest``)."""
from repro_torch.launch.mesh import Mesh, make_production_mesh, make_test_mesh

__all__ = ["Mesh", "make_production_mesh", "make_test_mesh"]
