"""Architecture config registry: ``get_config(name, reduced=False)``."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "command-r-35b": "command_r_35b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen3-4b": "qwen3_4b",
    "stablelm-1.6b": "stablelm_1_6b",
    "whisper-base": "whisper_base",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "xlstm-350m": "xlstm_350m",
    "internvl2-76b": "internvl2_76b",
    "zamba2-7b": "zamba2_7b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.REDUCED if reduced else mod.CONFIG
