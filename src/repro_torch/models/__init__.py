from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.models.model import (
    decode_step,
    forward,
    init_decode_caches,
    init_params,
    prefill_with_caches,
)

__all__ = [
    "caches_from_jax",
    "decode_step",
    "forward",
    "init_decode_caches",
    "init_params",
    "params_from_jax",
    "prefill_with_caches",
]
