"""Architecture registry: the 10 architectures, a copy of ``repro.configs``.
``get(name)`` returns the full config; ``get(name, reduced=True)`` the CPU
smoke-test variant."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduced_config  # noqa: F401

# canonical assignment ids -> module names
ALIASES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mixtral-8x22b": "mixtral_8x22b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "internlm2-1.8b": "internlm2_1_8b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "hubert-xlarge": "hubert_xlarge",
    "llava-next-34b": "llava_next_34b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "mamba2-780m": "mamba2_780m",
    "gemma2-9b": "gemma2_9b",
}


def get(name: str, reduced: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return reduced_config(cfg) if reduced else cfg
