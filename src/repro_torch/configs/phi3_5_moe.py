"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400,
vocab=32064, 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.config.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32_064,
    rope_theta=10_000.0,
    layer_pattern="g",
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=6400),
    notes="every FFN is MoE; EP puts exactly 1 expert per model shard on 16-way TP",
)
