"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version (``dp_layer.py``; sources under ``csrc/``):

  * ``dp_sweep`` -- the join-order DP sweep with the state resident on the
    card, one launch per popcount layer (replaces the reference's
    ``dp_sweep_resident``);
  * ``dp_layer`` -- one dense layer tile priced and reduced per column, the
    tiled fallback (replaces the reference's Pallas ``dp_layer``).
"""
