"""PyTorch/CUDA port of the Odyssey federated SPARQL optimizer.

Mirrors the subpackage layout of the JAX reference package ``repro``; it
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Host
code (statistics, source selection, cardinality estimation, the numpy DP
backend, execution) is numpy exactly as in the reference; the join-order
DP sweep runs on the card through the CUDA kernels in
``repro_torch.kernels`` (``dp_backend='torch'``, ``device='cuda'`` by
default).
"""
