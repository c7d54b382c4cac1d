"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family; unverified]"""
from repro_torch.config.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab=262_144,
    head_dim=256,
    qk_norm=True,
    rope_theta=1_000_000.0,
    local_window=1024,
    layer_pattern="lllllg",    # 5 local : 1 global
    tie_embeddings=True,
    sub_quadratic=False,       # global layers are full attention -> no 500k
    notes="5:1 local:global interleave; local layers use a 1024 sliding window",
)
