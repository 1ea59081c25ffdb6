"""Per-(arch × shape-cell) input specs and step recipes, over meta tensors.

``input_specs(cfg, cell)`` returns meta-device stand-ins for every model
input (shapes and dtypes, no memory); ``build_cell`` packages (step
function, meta arguments, their placements on the mesh, donation) for the
dry run (:mod:`.dryrun`). The port's own copy of the reference's
``launch/specs.py``: the same cells, the same accumulation rule, placements
by :func:`repro_torch.dist.tree_shardings` where the reference has
``NamedSharding`` trees. Tokens are ``torch.long``, the port's convention
(the reference's are int32).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.convert import param_tree
from repro_torch.dist import Axes, mesh_shape, tree_shardings
from repro_torch.models import build_model
from repro_torch.training.train_step import (
    TrainConfig,
    init_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    state_axes,
)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, cell: ShapeCell, batch: int | None = None) -> tuple[dict, dict]:
    """(meta tensors, logical Axes) for the data batch of a cell; ``batch``
    rows instead of the cell's global batch where given."""
    B, S = batch or cell.global_batch, cell.seq_len
    specs = {"tokens": _meta((B, S), torch.long), "labels": _meta((B, S), torch.long)}
    axes = {"tokens": Axes("batch", "seq"), "labels": Axes("batch", "seq")}
    if cfg.family == "vlm":
        specs["vision_embeds"] = _meta((B, cfg.n_vision_patches, cfg.d_model), torch.bfloat16)
        axes["vision_embeds"] = Axes("batch", None, "embed")
    if cfg.family == "audio":
        specs["enc_embeds"] = _meta((B, cfg.enc_len, cfg.d_model), torch.bfloat16)
        axes["enc_embeds"] = Axes("batch", None, "embed")
    return specs, axes


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """All meta inputs of this cell (the dry run's contract)."""
    specs, _ = batch_specs(cfg, cell)
    if cell.kind == "decode":
        specs = {"tokens": _meta((cell.global_batch, 1), torch.long)}
    return specs


@dataclass
class CellRecipe:
    fn: Callable
    args: tuple
    placements: tuple
    donate_argnums: tuple
    kind: str
    static_info: dict = field(default_factory=dict)


def _batch_shards(mesh, B: int) -> int:
    """How many ways the batch dim will actually shard under the rules."""
    shape = mesh_shape(mesh)
    for axes in (("pod", "data"), ("data",), ("pod",)):
        if all(a in shape for a in axes):
            n = 1
            for a in axes:
                n *= shape[a]
            if B % n == 0:
                return n
    return 1


def auto_accum_steps(mesh, B: int, S: int, target_tokens: int = 8192, cfg=None) -> int:
    """Pick gradient-accumulation steps so each microstep's per-rank token
    count stays ≈ target (bounds the L×(b,T,d) remat carry stack). With a
    model config, the target shrinks so the bf16 carry stack stays ≤ ~3 GiB
    (104B-scale models need 1-seq microsteps)."""
    if cfg is not None and cfg.n_layers and cfg.d_model:
        carry_budget = 3 << 30
        by_bytes = carry_budget // (cfg.n_layers * cfg.d_model * 2)
        target_tokens = max(min(target_tokens, by_bytes), 1024)
    local = B // _batch_shards(mesh, B)
    for cand in range(1, local + 1):  # smallest accumulation that fits
        if local % cand == 0 and (local // cand) * S <= target_tokens:
            return cand
    return local


def local_rows(mesh, B: int, placements) -> int:
    """One rank's rows of a batch of ``B`` placed by ``placements``."""
    from torch.distributed.tensor import Shard

    for size, p in zip(mesh_shape(mesh).values(), placements):
        if isinstance(p, Shard) and p.dim == 0:
            B //= size
    return B


def decode_cache(model, batch: int, seq_len: int) -> dict:
    """The decode cell's cache: ``seq_len`` slots, full but for the one the
    new token takes (``length = seq_len − 1``), as a step at the end of a
    ``seq_len`` context decodes."""
    cache = model.init_cache(batch, seq_len)
    cache["length"] = seq_len - 1
    return cache


def build_cell(
    cfg: ModelConfig,
    cell: ShapeCell,
    mesh,
    train_cfg: TrainConfig | None = None,
    rules=None,
) -> CellRecipe:
    """``mesh``: a ``MeshLayout`` or a ``DeviceMesh`` (only its dim names
    and sizes are read). The model is built on the meta device and stays in
    ``static_info["model"]``, whose parameters the train state holds;
    ``static_info["local_batch"]`` is one rank's rows of the batch, by the
    tokens' placements."""
    model = build_model(cfg, "meta")
    train_cfg = train_cfg or TrainConfig()
    B, S = cell.global_batch, cell.seq_len
    q_chunk = 2048 if S > 8192 else max(S, 128)
    info = {"model": model}

    if cell.kind == "train":
        if train_cfg.accum_steps == 0:  # auto
            train_cfg = replace(train_cfg, accum_steps=auto_accum_steps(mesh, B, S, cfg=cfg))
        step = make_train_step(model, train_cfg)
        state = init_state(model, None, train_cfg.opt)
        st_ax = state_axes(model, train_cfg.opt, state)
        b, b_ax = batch_specs(cfg, cell)
        placements = (tree_shardings(mesh, state, st_ax, rules), tree_shardings(mesh, b, b_ax, rules))
        info.update(train_cfg=train_cfg, local_batch=local_rows(mesh, B, placements[1]["tokens"]))
        return CellRecipe(step, (state, b), placements, (0,), "train", info)

    params, p_ax = param_tree(model), model.param_axes()
    if cell.kind == "prefill":
        step = make_prefill_step(model, q_chunk=q_chunk)
        b, b_ax = batch_specs(cfg, cell)
        b.pop("labels")
        b_ax.pop("labels")
        placements = (tree_shardings(mesh, params, p_ax, rules), tree_shardings(mesh, b, b_ax, rules))
        info.update(local_batch=local_rows(mesh, B, placements[1]["tokens"]))
        return CellRecipe(step, (params, b), placements, (), "prefill", info)

    # decode: one new token against a cache of seq_len
    step = make_decode_step(model)
    cache = decode_cache(model, B, S)
    tokens = _meta((B, 1), torch.long)
    placements = (
        tree_shardings(mesh, params, p_ax, rules),
        tree_shardings(mesh, cache, model.cache_axes(), rules),
        tree_shardings(mesh, {"t": tokens}, {"t": Axes("batch", None)}, rules)["t"],
    )
    info.update(local_batch=local_rows(mesh, B, placements[2]))
    return CellRecipe(step, (params, cache, tokens), placements, (1,), "decode", info)
