"""Optimizers written from scratch, as the reference's: AdamW and Adafactor,
the LR schedule and global-norm clipping.

The state trees keep the reference's keys (AdamW ``{"m", "v", "count"}``,
Adafactor ``{"f", "count"}`` with ``{"vr", "vc"}`` or ``{"v"}`` per leaf) and
mirror the parameter tree, so a checkpoint's leaf paths are the reference's.
``count`` is a 0-d int32 tensor on the CPU; the LR and bias corrections are
computed from it in fp32, as the reference does, and enter the updates as
numbers.

Updates happen in place: parameters, moments and gradients are modified,
and no temporary the size of the whole model is made. AdamW works on one
leading slice of a stacked ``(L, …)`` leaf at a time, so its temporaries
are the size of one layer's tensor.

A state placed on a mesh (the trainer under a mesh: parameters, gradients
and moments DTensors of one placement per leaf) is updated shard by shard
on each rank's local tensors. What reduces over a whole leaf reduces over
its shards: the global norm sums each shard's squares once (a replica is
not counted again), and Adafactor's row, column and RMS means all-reduce
over the mesh dims that shard the reduced dims. Whether a leaf decays or is
factored is decided on its global shape.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import dist as rdist
from repro_torch.dist import Axes
from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    epsilon1: float = 1e-30


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``: a 0-d fp32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def global_norm(tensors) -> torch.Tensor:
    """√(Σ‖t‖²) over the leaves in order, in fp32, with no copy of a leaf; a
    DTensor leaf's ‖t‖² summed over its shards."""
    ts = leaves(tensors)
    squares = [torch.linalg.vector_norm(rdist.local(t), dtype=torch.float32).square() for t in ts]
    total = 0
    for sq in rdist.sum_over_shards(squares, ts):
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scales every gradient in place by ``min(1, max_norm / (‖g‖ + 1e-9))``;
    returns the norm before clipping."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    for g in leaves(grads):
        rdist.local(g).mul_(scale.to(g.dtype))
    return gnorm


def _fp32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _count() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params) -> dict:
    return {"m": tree_map(_fp32_zeros, params), "v": tree_map(_fp32_zeros, params), "count": _count()}


def _adamw_slice(p, g, m, v, lr, bc1, bc2, cfg: OptimizerConfig, decay: bool) -> None:
    g = g.float()
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    step = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    pf = p.float()
    if decay:  # decoupled weight decay on matrices only
        step.add_(pf, alpha=cfg.weight_decay)
    step.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_(pf - step)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, opt_state: dict, params):
    """One AdamW step in place; returns ``(params, opt_state, lr)``."""
    count = opt_state["count"] + 1
    lr = lr_schedule(cfg, count)
    c = count.to(torch.float32)
    bc1 = float(1 - torch.pow(torch.tensor(cfg.b1), c))
    bc2 = float(1 - torch.pow(torch.tensor(cfg.b2), c))
    lr_f = float(lr)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt_state["m"]), leaves(opt_state["v"])):
        decay = p.ndim >= 2  # of the whole leaf: a stacked (L, d) norm decays, as in the reference
        p, g, m, v = _locals(p, g, m, v)
        parts = zip(p, g, m, v) if p.ndim >= 3 else [(p, g, m, v)]
        for ps, gs, ms, vs in parts:
            _adamw_slice(ps, gs, ms, vs, lr_f, bc1, bc2, cfg, decay)
    opt_state["count"] = count
    return params, opt_state, lr


# ---------------------------------------------------------------------------
# Adafactor (factored second moment for matrices of at least 128 × 128)
# ---------------------------------------------------------------------------

def _factored(p) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128


def adafactor_init(params) -> dict:
    def init_leaf(p):
        if _factored(p):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device)}
        return {"v": _fp32_zeros(p)}

    return {"f": tree_map(init_leaf, params), "count": _count()}


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, grads, opt_state: dict, params):
    """One Adafactor step in place, the update clipped to RMS ≤ 1; returns
    ``(params, opt_state, lr)``."""
    count = opt_state["count"] + 1
    lr = lr_schedule(cfg, count)
    beta2 = float(1.0 - count.to(torch.float32) ** (-cfg.decay_rate))
    lr_f, eps1 = float(lr), cfg.epsilon1
    states: list = []
    _collect_states(opt_state["f"], states)
    for p_, g, st in zip(leaves(params), leaves(grads), states):
        mean = _whole_mean(p_)
        decay, numel = p_.ndim >= 2, p_.numel()
        p, g = _locals(p_, g)
        g = g.float()
        g2 = g.square().add_(eps1)
        if "vr" in st:
            _check_factors(p_, st)
            vr, vc = _locals(st["vr"], st["vc"])
            vr.mul_(beta2).add_(mean(g2, -1), alpha=1 - beta2)
            vc.mul_(beta2).add_(mean(g2, -2), alpha=1 - beta2)
            denom = torch.sqrt(vr[..., None] * vc[..., None, :]
                               / torch.clamp(mean(vr, -1, keepdim=True, leaf_dim=-2)[..., None], min=eps1))
            step = g / torch.clamp(denom, min=eps1)
        else:
            v = rdist.local(st["v"])
            v.mul_(beta2).add_(g2, alpha=1 - beta2)
            step = g / (torch.sqrt(v) + 1e-12)
        del g2
        sq = step.square()
        rms = torch.sqrt(sq.mean() + 1e-12) if not rdist.is_dtensor(p_) else \
            torch.sqrt(rdist.sum_over_shards([sq.sum()], [p_])[0] / numel + 1e-12)
        del sq
        step.div_(torch.clamp(rms, min=1.0))
        pf = p.float()
        if decay:
            step.add_(pf, alpha=cfg.weight_decay)
        step.mul_(lr_f)
        if p.dtype == torch.float32:
            p.sub_(step)
        else:
            p.copy_(pf - step)
    opt_state["count"] = count
    return params, opt_state, lr


def _locals(*ts):
    return tuple(rdist.local(t) for t in ts)


def _whole_mean(p):
    """``mean(x, dim)`` of a tensor x on ``p``'s local shard over the whole
    leaf: the local mean averaged over the ranks of the mesh dims that shard
    dim ``leaf_dim`` of ``p`` (by default ``dim``; equal shards)."""
    spec = rdist.placement_spec(p) if rdist.is_dtensor(p) else None

    def mean(x, dim, keepdim=False, leaf_dim=None):
        m = x.mean(dim=dim, keepdim=keepdim)
        axes = spec[dim if leaf_dim is None else leaf_dim] if spec else ()
        if axes:
            import torch.distributed as dist

            mesh = p.device_mesh
            m = rdist.all_reduce_axes(m, mesh, axes, dist.ReduceOp.SUM) / rdist.axes_size(mesh, axes)
        return m

    return mean


def _check_factors(p, st) -> None:
    """A placed leaf's factors must be placed as its dims (``vr`` as all but
    the last, ``vc`` as all but the second last), so that a rank's local
    factors are those of its local block."""
    if not rdist.is_dtensor(p):
        return
    spec = rdist.placement_spec(p)
    got = (rdist.placement_spec(st["vr"]), rdist.placement_spec(st["vc"]))
    if got != (spec[:-1], spec[:-2] + spec[-1:]):
        raise ValueError(f"Adafactor: factors placed {got}, the leaf {spec}")


def _collect_states(tree, out: list) -> None:
    """The per-leaf state dicts of an Adafactor ``f`` tree, in leaf order."""
    if isinstance(tree, dict) and ("v" in tree or "vr" in tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _collect_states(tree[k], out)
    else:
        for v in tree:
            _collect_states(v, out)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def opt_init(cfg: OptimizerConfig, params) -> dict:
    return adamw_init(params) if cfg.name == "adamw" else adafactor_init(params)


def opt_update(cfg: OptimizerConfig, grads, opt_state: dict, params):
    if cfg.name == "adamw":
        return adamw_update(cfg, grads, opt_state, params)
    return adafactor_update(cfg, grads, opt_state, params)


def opt_state_axes(cfg: OptimizerConfig, param_axes, params_shape):
    """Logical axes of the optimizer state, mirroring the parameters' (the
    reference's tree: AdamW's ``m``/``v``, Adafactor's factored ``vr``/``vc``
    or ``v`` per leaf). ``params_shape``: any tree of tensors with the
    parameters' shapes (meta tensors do)."""
    if cfg.name == "adamw":
        return {"m": param_axes, "v": param_axes, "count": Axes()}

    def leaf_axes(ax, p):
        if _factored(p):
            return {"vr": Axes(*ax.t[:-1]), "vc": Axes(*(ax.t[:-2] + ax.t[-1:]))}
        return {"v": ax}

    return {"f": tree_map(leaf_axes, param_axes, params_shape), "count": Axes()}
