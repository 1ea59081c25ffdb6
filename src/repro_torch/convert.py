"""Parameter trees between the reference layout and the port.

The port keeps the reference's parameter layout: nested dicts (and, for the
hybrid family, lists of per-slot dicts) whose leaves are layer-stacked
``(L, …)`` arrays, with the same key paths. The nested key ``['attn']['wq']``
is the flat ``state_dict`` key ``attn.wq`` of
:class:`repro_torch.models.transformer.TransformerLM`, and
``['slots'][0]['mix']['w_in']`` is ``slots.0.mix.w_in`` of
:class:`repro_torch.models.rglru.GriffinLM`, so a tree exported by either
package loads into the other.
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


def params_from_jax(tree, device=None, dtype: torch.dtype | None = None):
    """Nested dicts and lists of numpy arrays (``jax.tree.map(np.asarray,
    params)``) → the same tree of torch tensors on ``device`` (cast to
    ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    return tensor_from_numpy(tree, device, dtype)


def flatten(tree, prefix: str = "") -> dict:
    """``{'attn': {'wq': x}}`` → ``{'attn.wq': x}`` and ``{'slots': [{'ln1':
    x}]}`` → ``{'slots.0.ln1': x}`` (``state_dict`` keys: a list index is a
    ``ModuleList`` index)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out
