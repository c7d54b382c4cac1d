"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40, MHA) d_ff=27392
vocab=152064 — QKV bias. [hf:Qwen/Qwen1.5 family; hf]"""
from repro_torch.config.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    layer_pattern="g",
    notes="MHA (kv=40); 40 heads on 16-way TP uses GSPMD padding to 48",
)
