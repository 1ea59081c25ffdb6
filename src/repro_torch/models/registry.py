"""Model registry: config → model instance."""
from __future__ import annotations

import torch

from .transformer import TransformerLM


def build_model(cfg, device=None, param_dtype: torch.dtype = torch.float32):
    """dense | vlm → :class:`TransformerLM` on ``device`` (``cuda`` by default)."""
    if cfg.family in ("dense", "vlm"):
        return TransformerLM(cfg, device=device, param_dtype=param_dtype)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet: moe, ssm, hybrid and audio are "
        "ROADMAP Queue A items 13-16"
    )
