"""Train and serve step builders, and abstract (meta-device) state.

``make_train_step`` returns an eager ``(state, batch) -> (state, metrics)``
that updates ``state`` in place (the reference's ``jit`` with donation).
The state is ``{"params", "opt", "step"}``: ``params`` is the model's
parameter tree (:func:`repro_torch.convert.param_tree`, the ``nn.Parameter``
objects, fp32 masters), the model casts to ``cfg.dtype`` inside. Gradient
accumulation sums fp32 gradients over microbatches in the parameters'
``.grad`` and divides by their number, then the step clips and updates.
Under a mesh the state is placed on it (:func:`place_state`) and each rank
runs its rows of the batch (:func:`accumulate_grads`).

``abstract_params``/``abstract_state``/``abstract_cache`` build the same
trees of meta-device tensors: shapes and dtypes, no memory.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch import dist as rdist
from repro_torch import trace
from repro_torch.convert import flatten, param_tree
from repro_torch.dist import Axes
from repro_torch.models import build_model
from repro_torch.tree import leaves
from .optimizer import OptimizerConfig, clip_by_global_norm, opt_init, opt_state_axes, opt_update


@dataclass(frozen=True)
class TrainConfig:
    opt: OptimizerConfig = field(default_factory=OptimizerConfig)
    accum_steps: int = 1
    remat: bool = True
    q_chunk: int = 2048


def init_state(model, generator: torch.Generator | None, opt_cfg: OptimizerConfig) -> dict:
    """Makes ``model`` trainable and returns its train state. ``generator``
    draws the parameters (:meth:`init`); None keeps the ones it has (loaded,
    or about to be restored)."""
    if generator is not None:
        model.init(generator)
    model.requires_grad_(True)
    params = param_tree(model)
    return {"params": params, "opt": opt_init(opt_cfg, params), "step": torch.zeros((), dtype=torch.int32)}


def state_axes(model, opt_cfg: OptimizerConfig, params_shape):
    """Logical axes of the train state ``{"params", "opt", "step"}``;
    ``params_shape`` is the parameter tree or a whole state."""
    pax = model.param_axes()
    shapes = params_shape["params"] if "params" in params_shape else params_shape
    return {"params": pax, "opt": opt_state_axes(opt_cfg, pax, shapes), "step": Axes()}


def place_state(model, state: dict, opt_cfg: OptimizerConfig, mesh) -> dict:
    """``state`` (plain tensors, every rank the same values) placed on
    ``mesh`` by :func:`state_axes`, as the reference places its state by
    ``tree_shardings``: each parameter becomes a DTensor ``nn.Parameter`` of
    ``model`` (the model computes on them through
    :func:`repro_torch.dist.gather_param`), each optimizer moment a DTensor.
    The counters (``step``, ``opt['count']``) stay plain 0-d tensors on the
    CPU, the same on every rank (the reference's replicated scalars)."""
    from torch import nn

    axes = state_axes(model, opt_cfg, state)
    placed = rdist.distribute_tree(state["params"], mesh, axes["params"])
    for name, t in flatten(placed).items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        param = nn.Parameter(t, requires_grad=True)
        if isinstance(mod, nn.ParameterDict):
            mod[leaf] = param
        else:
            setattr(mod, leaf, param)
    opt = {k: (v if k == "count" else rdist.distribute_tree(v, mesh, axes["opt"][k])) for k, v in state["opt"].items()}
    return {"params": param_tree(model), "opt": opt, "step": state["step"]}


def accumulate_grads(model, params: list, batch: dict, train_cfg: TrainConfig) -> dict:
    """The gradients of the loss over ``batch`` (the global batch), fp32
    and summed over ``train_cfg.accum_steps`` microbatches then divided by
    their number, left in the parameters' ``.grad``; returns the metrics.

    Under a mesh (:func:`repro_torch.dist.active_mesh`) the parameters must
    be placed on it (:func:`place_state`). Each rank then runs its shard of
    each global microbatch (microbatch i is the global rows [i·B/A,
    (i+1)·B/A), split over the ``batch`` rule's mesh dims) under
    :func:`repro_torch.dist.batch_split`; the gradients come back averaged
    over those ranks and cut to each rank's shard, and the metrics are
    averaged over them, so every rank returns the global values."""
    mesh = rdist.active_mesh()
    if mesh is not None:
        stray = [i for i, p in enumerate(params) if not (rdist.is_dtensor(p) and p.device_mesh == mesh)]
        if stray:
            raise ValueError(f"train step under a mesh: {len(stray)} parameters are not placed on it (place_state)")
    for p in params:
        if p.grad is not None:
            p.grad.zero_()
    A = train_cfg.accum_steps

    def backward(mb) -> dict:
        with trace.span("forward"):
            loss, metrics = model.loss(mb, remat=train_cfg.remat, q_chunk=train_cfg.q_chunk)
        with trace.span("backward"):
            loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    n = batch["tokens"].shape[0] // max(A, 1)
    if mesh is None:
        run = trace.spanned("microbatch")(backward)
    else:
        bspec = rdist.logical_to_spec(("batch",), (n,), mesh)[0]
        rows = rdist.shard_slice(mesh, bspec, n)

        @trace.spanned("microbatch")
        def run(mb) -> dict:
            with rdist.batch_split(bspec):
                return backward({k: v[rows] for k, v in mb.items()})

    if A <= 1:
        metrics = run(batch)
    else:
        loss_sum = 0.0
        for i in range(A):
            loss_sum = loss_sum + run({k: v[i * n:(i + 1) * n] for k, v in batch.items()})["loss"]
        for p in params:
            if p.grad is not None:
                rdist.local(p.grad).div_(A)
        metrics = {"loss": loss_sum / A}
    if mesh is not None and rdist.entry_axes(bspec):  # each rank's estimate → their mean, the global value
        import torch.distributed as dist

        keys = sorted(metrics)
        v = rdist.all_reduce_axes(torch.stack([metrics[k].float() for k in keys]), mesh, bspec, dist.ReduceOp.SUM)
        v = v / rdist.axes_size(mesh, rdist.entry_axes(bspec))
        metrics = dict(zip(keys, v.unbind()))
    return metrics


def make_train_step(model, train_cfg: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)``: gradients
    (:func:`accumulate_grads`), clipping by the global norm, the optimizer,
    the step counter. Under a mesh (the ambient one, the state placed on it
    by :func:`place_state`) ``batch`` is the global batch on every rank."""
    opt_cfg = train_cfg.opt

    @trace.spanned("train_step")
    def train_step(state: dict, batch: dict):
        trace.count("train_step", 1)
        params = leaves(state["params"])
        metrics = accumulate_grads(model, params, batch, train_cfg)
        for p in params:  # a parameter that no loss reaches has a zero gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        with trace.span("clip"):
            gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        with trace.span("optimizer"):
            _, _, lr = opt_update(opt_cfg, grads, state["opt"], params)
        metrics.update(grad_norm=gnorm, lr=lr)
        state["step"] = state["step"] + 1
        return state, metrics

    return train_step


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(model, q_chunk: int = 2048):
    """``prefill_step(batch) -> (last-token logits, cache)``; the attention
    models take ``q_chunk`` and ``vision_embeds``, the audio model
    ``enc_embeds``."""
    attends = hasattr(model, "hidden_states")

    @torch.no_grad()
    def prefill_step(batch: dict):
        if "enc_embeds" in batch:
            return model.prefill(batch["tokens"], batch["enc_embeds"], q_chunk=q_chunk)
        if not attends:
            return model.prefill(batch["tokens"])
        return model.prefill(batch["tokens"], batch.get("vision_embeds"), q_chunk=q_chunk)

    return prefill_step


def make_decode_step(model):
    @torch.no_grad()
    def decode_step(cache: dict, tokens: torch.Tensor):
        return model.decode_step(cache, tokens)

    return decode_step


# ---------------------------------------------------------------------------
# abstract state (meta device: no allocation)
# ---------------------------------------------------------------------------

def abstract_params(cfg, dtype: torch.dtype | None = None) -> dict:
    return param_tree(build_model(cfg, "meta", param_dtype=dtype or torch.float32))


def abstract_state(cfg, opt_cfg: OptimizerConfig) -> dict:
    return init_state(build_model(cfg, "meta"), None, opt_cfg)


def abstract_cache(cfg, batch: int, max_len: int) -> dict:
    return build_model(cfg, "meta").init_cache(batch, max_len)
