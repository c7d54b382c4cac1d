"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, vocab=65536, Mamba:attn 7:1 interleave, MoE 16e top-2 every other
layer. [arXiv:2403.19887; hf]"""
from repro_torch.config.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65_536,
    rope_theta=10_000.0,
    layer_pattern="mmmmammm",  # 1 attention layer per 8 (1:7)
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, every=2, d_ff_dense=24576),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    sub_quadratic=True,        # only 9/72 layers attend -> runs long_500k
)
