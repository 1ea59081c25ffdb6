"""Model registry: config → model instance."""
from __future__ import annotations

import torch

from .mamba2 import Mamba2LM
from .rglru import GriffinLM
from .transformer import TransformerLM
from .whisper import WhisperModel


def build_model(cfg, device=None, param_dtype: torch.dtype = torch.float32):
    """dense | moe | vlm → :class:`TransformerLM`, ssm → :class:`Mamba2LM`,
    hybrid → :class:`GriffinLM`, audio → :class:`WhisperModel`, on
    ``device`` (``cuda`` by default)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg, device=device, param_dtype=param_dtype)
    if cfg.family == "ssm":
        return Mamba2LM(cfg, device=device, param_dtype=param_dtype)
    if cfg.family == "hybrid":
        return GriffinLM(cfg, device=device, param_dtype=param_dtype)
    if cfg.family == "audio":
        return WhisperModel(cfg, device=device, param_dtype=param_dtype)
    raise NotImplementedError(f"unknown family {cfg.family!r}")
