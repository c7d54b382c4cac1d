"""Registry of assigned architectures (+ the paper's own federated-engine
"architecture"). ``get_arch(id)`` returns the exact published config."""
from __future__ import annotations

from repro_torch.config.base import ArchConfig

_REGISTRY: dict[str, str] = {
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

ARCH_IDS = list(_REGISTRY)


def get_arch(arch_id: str) -> ArchConfig:
    import importlib

    mod = importlib.import_module(_REGISTRY[arch_id])
    return mod.CONFIG
