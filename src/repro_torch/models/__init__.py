from repro_torch.models.convert import (caches_from_jax, opt_state_from_jax,
                                        params_from_jax, params_to_jax,
                                        reference_leaves, tree_from_jax)
from repro_torch.models.model import (
    decode_step,
    forward,
    forward_hidden,
    init_decode_caches,
    init_params,
    prefill_with_caches,
)

__all__ = [
    "caches_from_jax",
    "decode_step",
    "forward",
    "forward_hidden",
    "init_decode_caches",
    "init_params",
    "opt_state_from_jax",
    "params_from_jax",
    "params_to_jax",
    "prefill_with_caches",
    "reference_leaves",
    "tree_from_jax",
]
