"""Assigned-architecture registry: --arch <id> selects one of these."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "mamba2_130m",
    "internlm2_20b",
    "deepseek_7b",
    "gemma2_9b",
    "qwen2_72b",
    "internvl2_76b",
    "arctic_480b",
    "kimi_k2_1t_a32b",
    "hymba_1_5b",
    "seamless_m4t_medium",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIAS.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
