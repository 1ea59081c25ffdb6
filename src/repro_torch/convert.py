"""Parameter trees between the reference layout and the port.

The port keeps the reference's parameter layout: nested dicts (and, for the
hybrid family, lists of per-slot dicts) whose leaves are layer-stacked
``(L, …)`` arrays, with the same key paths. The nested key ``['attn']['wq']``
is the flat ``state_dict`` key ``attn.wq`` of
:class:`repro_torch.models.transformer.TransformerLM`, and
``['slots'][0]['mix']['w_in']`` is ``slots.0.mix.w_in`` of
:class:`repro_torch.models.rglru.GriffinLM`, so a tree exported by either
package loads into the other. :func:`state_from_jax` and :func:`state_to_jax`
carry a whole train state (``{"params", "opt", "step"}``) across.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


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


def unflatten(flat: dict) -> dict:
    """The inverse of :func:`flatten`: ``{'slots.0.ln1': x}`` → ``{'slots':
    [{'ln1': x}]}`` (a level whose keys are all numbers is a list)."""
    tree: dict = {}
    for key, v in flat.items():
        node, parts = tree, key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return [lists(t[str(i)]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}

    return lists(tree)


def param_tree(model) -> dict:
    """The model's parameters (the ``nn.Parameter`` objects themselves) as
    the reference's parameter tree."""
    return unflatten(dict(model.named_parameters()))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's host copy as numpy; bf16 comes back as its ``uint16`` bits
    (``.view(ml_dtypes.bfloat16)`` makes it the reference's array)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def state_from_jax(tree: dict, model) -> dict:
    """The reference's train state as numpy (``{"params", "opt", "step"}``,
    ``jax.tree.map(np.asarray, state)``) → the port's: the parameters are
    loaded into ``model`` (which must require grad to train), ``opt`` leaves
    go to the model's device, and the counters (``step``, ``opt['count']``)
    stay 0-d int32 tensors on the CPU."""
    model.load_state_dict(flatten(params_from_jax(tree["params"])))
    opt = {k: (tensor_from_numpy(v) if k == "count" else params_from_jax(v, model.device))
           for k, v in tree["opt"].items()}
    return {"params": param_tree(model), "opt": opt, "step": tensor_from_numpy(tree["step"])}


def state_to_jax(state: dict) -> dict:
    """The port's train state → the same tree of numpy arrays."""
    return tree_map(tensor_to_numpy, state)
