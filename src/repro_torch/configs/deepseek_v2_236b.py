"""deepseek-v2-236b [moe]: 60L d_model=5120 128H MLA (kv_lora=512)
moe_d_ff=1536, vocab=102400, 2 shared + 160 routed top-6, first layer dense.
[arXiv:2405.04434; hf]"""
from repro_torch.config.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,            # MLA: per-head keys derived from the latent
    d_ff=1536,
    vocab=102_400,
    head_dim=192,              # nope 128 + rope 64
    rope_theta=10_000.0,
    layer_pattern="g",
    mla=MLAConfig(q_lora=1536, kv_lora=512, nope_dim=128, rope_dim=64, v_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  first_k_dense=1, d_ff_dense=12288),
    notes="MLA caches the 512-d latent + 64-d rope key per token (decode memory win)",
)
