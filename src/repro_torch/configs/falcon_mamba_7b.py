"""falcon-mamba-7b [ssm]: 64L d_model=4096 attention-free mamba1,
ssm_state=16, vocab=65024. [arXiv:2410.05355; unverified]"""
from repro_torch.config.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,                 # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,                    # mamba block subsumes the FFN
    vocab=65_024,
    layer_pattern="m",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    sub_quadratic=True,        # O(1) state per token -> runs long_500k
)
