"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version (sources under ``csrc/``; built and launched through
``build.py``):

  * ``dp_sweep`` (``dp_layer.py``) -- the join-order DP sweep with the state
    resident on the card, one launch per popcount layer (replaces the
    reference's ``dp_sweep_resident``);
  * ``dp_layer`` (``dp_layer.py``) -- one dense layer tile priced and reduced
    per column, the tiled fallback (replaces the reference's Pallas
    ``dp_layer``);
  * ``sorted_intersect`` -- Algorithm 1's weighted intersection count
    (replaces ``sorted_intersect_weighted``);
  * ``join_count`` -- per-probe weighted match counts against a sorted build
    side (replaces ``join_count``);
  * ``summary_probe`` -- popcount of the pairwise AND of entity-summary
    signatures (replaces ``summary_probe``);
  * ``seg_bitmap`` -- (segment, predicate bucket) counts for per-subject
    predicate bitmaps (replaces ``seg_bitmap``);
  * ``flash_attention`` -- online-softmax attention with grouped KV heads,
    the LM prefill's and training's attention (replaces
    ``flash_attention``), and ``flash_attention_bwd``, its backward
    (``FlashAttentionFn``; the reference differentiates plain attention);
  * ``ssm_scan`` -- the Mamba-1 selective scan with its final state, the
    Mamba prefill's and training's scan (replaces ``ssm_scan``), and
    ``ssm_scan_bwd``, its backward from the forward's chunk states
    (``SSMScanFn``).

``ops.py`` holds the host entry points (``intersect_count``,
``predicate_bitmaps``, ``match_counts``, ``signature_overlap``,
``flash_attention_gqa``, ``selective_scan``); ``work.py`` counts the LM
kernels' operations and bytes (their bounds, and the dry-run's booking of
each as one ``torch.library`` operator).  Importing this package
registers every kernel, so ``build.build_kernels()`` builds all ten.
"""
from repro_torch.kernels import (dp_layer, flash_attention,  # noqa: F401
                                 join_count, seg_bitmap, sorted_intersect,
                                 ssm_scan, summary_probe)
