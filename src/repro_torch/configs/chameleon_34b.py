"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion VQ image tokens, qk-norm.
Modality frontend is a stub: input_specs() provides patch embeddings for the
leading ``vlm_prefix`` positions. [arXiv:2405.09818; unverified]"""
from repro_torch.config.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65_536,
    qk_norm=True,
    rope_theta=10_000.0,
    layer_pattern="g",
    vlm_prefix=1024,           # leading image-token positions (stubbed embeds)
    notes="early fusion: VQ image tokens share the text vocab; frontend stubbed",
)
