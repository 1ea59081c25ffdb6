"""Architecture registry — ``--arch <id>`` resolution.

Lists the configs that the port builds: dense (llama3-8b, qwen3-4b,
phi3-medium-14b, command-r-plus-104b), vlm (internvl2-76b), moe
(granite-moe-1b-a400m, qwen2-moe-a2.7b), ssm (mamba2-1.3b), hybrid
(recurrentgemma-9b) and audio (whisper-small).
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeCell

_ARCH_MODULES = {
    "command-r-plus-104b": "command_r_plus_104b",
    "phi3-medium-14b": "phi3_medium_14b",
    "llama3-8b": "llama3_8b",
    "qwen3-4b": "qwen3_4b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "internvl2-76b": "internvl2_76b",
    "mamba2-1.3b": "mamba2_1_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-small": "whisper_small",
}

ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    mod = _ARCH_MODULES.get(arch)
    if mod is None:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeCell", "get_config"]
