"""Architecture registry — ``--arch <id>`` resolution.

Lists the configs that the port serves so far (dense, ssm and hybrid); the
other families arrive with their models.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

_ARCH_MODULES = {
    "llama3-8b": "llama3_8b",
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen3-4b": "qwen3_4b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    mod = _ARCH_MODULES.get(arch)
    if mod is None:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


__all__ = ["ARCH_IDS", "ModelConfig", "get_config"]
