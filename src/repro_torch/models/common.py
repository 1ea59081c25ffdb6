"""Shared model components: norms, RoPE, activations, embeddings, logits.

Plain functions on tensors, with the reference's numerics: norms scale by
``1 + scale`` and compute in fp32; RoPE is split-half and computed in fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import dist as rdist
from repro_torch import trace
from repro_torch.dist import Axes
from repro_torch.dist.perf import under_current_flags


def init_truncated_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """``std · truncated_normal(-2, 2)`` in place. Drawn in fp32 one leading
    slice at a time, so a low-precision parameter never needs a full fp32 copy."""
    for sl in (t if t.ndim >= 3 else [t]):
        tmp = torch.empty(sl.shape, dtype=torch.float32, device=t.device)
        torch.nn.init.trunc_normal_(tmp, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
        sl.copy_(tmp)
    return t


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def norm(x: torch.Tensor, scale: torch.Tensor, eps: float, kind: str) -> torch.Tensor:
    return rmsnorm(x, scale, eps) if kind == "rmsnorm" else layernorm(x, scale, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@trace.spanned("rope")
def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int — returns (sin, cos) of shape (..., head_dim//2)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., T, H, D); sin/cos: (..., T, D//2) broadcast over heads."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + eˣ)`` without a threshold, as ``jax.nn.softplus``
    (``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU written op by op as ``jax.nn.gelu(x,
    approximate=True)`` writes it, with its constants in x's dtype, so that
    a bf16 input is rounded at the same points as in the reference
    (``F.gelu`` computes in fp32 and rounds once, a few bf16 ulps away)."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + e⁻ˣ)`` op by op, as XLA expands ``jax.nn.sigmoid``, so
    that a bf16 input is rounded at the same points as in the reference."""
    return 1.0 / (1.0 + torch.exp(-x))


def glu_activation(gate: torch.Tensor, up: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return gelu_tanh(gate) * up
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# embeddings + logits
# ---------------------------------------------------------------------------

def embed_axes() -> Axes:
    return Axes("vocab", "param_embed")


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return emb[tokens].to(dtype)


def logits_from_hidden(x: torch.Tensor, out_emb: torch.Tensor, vocab: int) -> torch.Tensor:
    """x: (B, T, d), out_emb: (V, d) → fp32 logits with the padded vocab masked."""
    logits = torch.matmul(x, out_emb.to(x.dtype).t()).float()
    V = out_emb.shape[0]
    if V != vocab:
        logits[..., vocab:] = -1e30
    return logits


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None):
    """logits (B,T,V) fp32; labels (B,T) int. Returns (loss, metrics) with
    metrics ``{loss, accuracy, tokens}``, as the reference: the max is held
    out of the gradient, and the label logit is taken by a masked reduction
    over the vocabulary. Inside :func:`repro_torch.dist.batch_split` the rows
    are this rank's of a batch split over n data ranks: ``tokens`` is the
    global count, and the sums are divided by 1/n of it, so that the mean
    over the data ranks is the global loss."""
    V = logits.shape[-1]
    mx = logits.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.exp(logits - mx).sum(dim=-1)) + mx[..., 0]
    onehot = labels[..., None] == torch.arange(V, device=logits.device)
    label_logit = torch.where(onehot, logits, 0.0).sum(dim=-1)
    nll = lse - label_logit
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    denom = torch.clamp(mask.sum(), min=1.0)
    share = denom
    over = rdist.batch_axes()
    if over:  # this rank's rows of a batch split over the data ranks: the global count, and this rank's share of it
        import torch.distributed as dist

        count = rdist.all_reduce_axes(mask.sum().detach().clone(), rdist.active_mesh(), over, dist.ReduceOp.SUM)
        denom = torch.clamp(count, min=1.0)
        share = denom / rdist.axes_size(rdist.active_mesh(), over)
    loss = (nll * mask).sum() / share
    acc = ((logits.argmax(dim=-1) == labels) * mask).sum() / share
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


# ---------------------------------------------------------------------------
# per-layer views of stacked parameters
# ---------------------------------------------------------------------------

class _LayerSlice(torch.autograd.Function):
    """``p[l]`` whose gradient is added into ``p.grad[l]`` in place (the
    buffer is made zero on first use); autograd itself carries no gradient
    to ``p``."""

    @staticmethod
    def forward(ctx, p, l):
        ctx.p, ctx.l = p, l
        return p[l]

    @staticmethod
    def backward(ctx, g):
        p = ctx.p
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        p.grad[ctx.l] += g
        return None, None


def layer_view(p: torch.Tensor, l: int) -> torch.Tensor:
    """``p[l]``: layer ``l`` of a stacked ``(L, …)`` parameter. When autograd
    records it, its gradient is added into ``p.grad[l]`` in place, and the
    caller takes the view just before running layer ``l``: autograd runs the
    newest ready node first, so the view's node then runs right after that
    layer's backward. Plain ``p[l]`` writes a zero tensor of p's full shape
    per layer (O(L²) in the backward), and ``p.unbind(0)`` (or views taken
    before the first layer) holds every layer's gradient until layer 0's
    backward is done: a second copy of the stacked gradients, 14.5 GB of
    fp32 for qwen3-4b.

    So a stacked parameter is trained through ``.backward()`` only:
    autograd carries no gradient to ``p`` itself, and
    ``torch.autograd.grad(loss, p)``, tensor hooks on ``p`` and its
    post-accumulate-grad hooks see none. The memory gain rests on the
    engine's order of ready nodes; ``test_stacked_gradients_land_layer_by_layer``
    pins it on the CPU and its ``_on_card`` twin in ``tests/test_torch_gpu.py``
    on CUDA.

    A parameter placed on a mesh (a DTensor, the trainer under a mesh) is
    gathered to the plain full layer here instead, and its gradient, reduced
    to this rank's shard, is added into its ``.grad`` the same way
    (:func:`repro_torch.dist.gather_param`)."""
    if rdist.is_dtensor(p):
        return rdist.gather_param(p, l)
    if torch.is_grad_enabled() and p.requires_grad:
        return _LayerSlice.apply(p, l)
    return p[l]


def run_layer(fn, remat: bool, *args, **checkpoint_kw):
    """One layer, ``fn(*args)``, where ``fn`` takes the layer's parameters
    itself (:func:`layer_view`) from an index among ``args``. With ``remat``
    nothing inside is saved and ``fn`` runs again in the backward, under the
    flags and the mesh in effect now: a placed parameter is gathered again
    there, so a rank holds one layer's gathered parameters at a time.
    ``checkpoint_kw`` go to ``torch.utils.checkpoint.checkpoint`` (§Perf
    V1's ``context_fn``). Each run of ``fn``, the recompute too, is the
    span ``layer`` (:mod:`repro_torch.trace`)."""
    if remat:
        return checkpoint(under_current_flags(_in_layer_span), fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **checkpoint_kw)
    return _in_layer_span(fn, *args)


def _in_layer_span(fn, *args):
    """``fn(*args)`` inside the span ``layer``: a plain function, so that a
    layer makes no new function object for the garbage collector."""
    with trace.span("layer"):
        return fn(*args)


# ---------------------------------------------------------------------------
# named tensors for remat (§Perf V1)
# ---------------------------------------------------------------------------

_name_op = None


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` marked by ``name`` for :func:`save_only_these_names`, the
    counterpart of ``jax.ad_checkpoint.checkpoint_name``: a copy made by an
    op of its own, which a selective-checkpoint policy can recognise (its
    gradient passes through)."""
    global _name_op
    if _name_op is None:
        @torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
        def op(x: torch.Tensor, name: str) -> torch.Tensor:
            return x.clone()

        op.register_fake(lambda x, name: torch.empty_like(x))
        op.register_autograd(lambda ctx, grad: (grad, None), setup_context=lambda ctx, inputs, output: None)
        _name_op = op
    return _name_op(x, name)


def save_only_these_names(*names: str):
    """A ``context_fn`` for ``torch.utils.checkpoint.checkpoint`` that saves
    the tensors marked by :func:`checkpoint_name` with one of ``names`` and
    recomputes everything else in the backward."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    def policy(ctx, op, *args, **kwargs):
        named = _name_op is not None and op is torch.ops.repro_torch.checkpoint_name.default and args[1] in names
        return CheckpointPolicy.MUST_SAVE if named else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)
