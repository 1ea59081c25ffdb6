"""Parameter trees between the reference layout and the port.

The port keeps the reference's parameter layout: a nested dict whose leaves
are layer-stacked ``(L, …)`` arrays, with the same key paths. The nested key
``['attn']['wq']`` is the flat ``state_dict`` key ``attn.wq`` of
:class:`repro_torch.models.transformer.TransformerLM`, so a tree exported by
either package loads into the other.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(arr: np.ndarray, device=None, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) → torch. ``torch.from_numpy`` refuses
    bfloat16, so those arrays cross as their ``uint16`` bit pattern."""
    arr = np.require(np.asarray(arr), requirements=["C", "W"])  # copies only a read-only array
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_jax(tree: dict, device=None, dtype: torch.dtype | None = None) -> dict:
    """Nested dict of numpy arrays (``jax.tree.map(np.asarray, params)``) →
    the same nested dict of torch tensors on ``device`` (cast to ``dtype``
    when given)."""
    return {
        k: params_from_jax(v, device, dtype) if isinstance(v, dict) else tensor_from_numpy(v, device, dtype)
        for k, v in tree.items()
    }


def flatten(tree: dict, prefix: str = "") -> dict:
    """``{'attn': {'wq': x}}`` → ``{'attn.wq': x}`` (``state_dict`` keys)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out
