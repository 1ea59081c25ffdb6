"""Plain PyTorch reference of the MoE decoder LM that the training cells run,
in float32 (TF32 off), with no kernel, cache or batching of the port's.

It follows the published architecture (pre-norm decoder, GQA attention with
split-half RoPE, a routed top-k SwiGLU expert layer, qwen2-moe's gated
shared experts and qkv biases, cross-entropy over the real vocabulary) with
the departures the program declares, each written where it applies:

- routing is capacity-bound: :func:`capacity` slots per expert; a slot past
  an expert's capacity is dropped, and an expert routed more slots than its
  capacity also loses its position 0 (the port's declared overflow rule);
- the top-k routing weights are renormalised to sum to one;
- norms scale by ``1 + scale``;
- the loss adds ``router_aux_coef`` × the Switch load-balance loss, summed
  over layers.

Parameters are dicts of name → tensor; a stacked ``(L, …)`` leaf is a list
of per-layer tensors (:func:`portbench.reference.train.pieces`), so that each
layer's gradient lands in a tensor of its own.

``precision="fp8"`` is the control, the step below the configuration's
bf16 that would tempt a later change: the activations in bf16 as the
program keeps them (norms, RoPE, softmax, the router and the loss in fp32),
and every projection (attention's q, k, v and output, the experts, the
shared experts, the LM head) an fp8 product as fp8 training makes it: both
operands rounded to e4m3 under a per-tensor scale (per expert for a stack
of experts) in the forward, the incoming gradient to e5m2 in the
backward's two products.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

HEAD_ROWS = 512  # the LM head's logits are made for this many rows at a time (0.31 GB of fp32 at 152k ids)


def capacity(N: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots per expert: ⌊N·k/E · factor⌋ + 1, rounded up to a multiple of
    64 (at least 64), at most N."""
    C = int((N * k / E) * capacity_factor) + 1
    return min(max(64, -(-C // 64) * 64), N)


def _fp8(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """t rounded to ``dtype`` (an fp8 type) under a scale per tensor (per
    expert, for a stack of experts' tensors), back in fp32."""
    t = t.float()
    dims = tuple(range(1, t.ndim)) if t.ndim == 3 else tuple(range(t.ndim))
    scale = t.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).float().mul_(scale)


class _Fp8Matmul(torch.autograd.Function):
    """a @ b as an fp8 product, out in a's dtype: q(a)·q(b) with both rounded
    to e4m3; backward dA = q5(dY)·q(b)ᵀ, dB = q(a)ᵀ·q5(dY), dY rounded to e5m2,
    accumulated in fp32. It saves a and b, not their rounded copies, which it
    makes again in the backward: the control's state then fits beside the
    reference's."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return (_fp8(a) @ _fp8(b)).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        qa, qb, qg = _fp8(a), _fp8(b), _fp8(g, torch.float8_e5m2)
        if b.ndim == 2:  # one matrix for every row of a
            k, n = b.shape
            da, db = (qg @ qb.t()).view(a.shape), qa.reshape(-1, k).t() @ qg.reshape(-1, n)
        else:
            da, db = qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg
        return da.to(a.dtype), db.to(b.dtype)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b) if precision == "fp8" else a @ b


def act(precision: str) -> torch.dtype:
    """The activations' dtype: fp32 in the reference, bf16 in the control."""
    return torch.bfloat16 if precision == "fp8" else torch.float32


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + scale)).to(x.dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, heads, hd): split-half rotary embedding at positions 0..T-1."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def attention(x: torch.Tensor, p: dict, l: int, m: dict, precision: str) -> torch.Tensor:
    B, T, d = x.shape
    H, K, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q, k, v = (mm(x, p[f"attn.w{n}"][l], precision) for n in "qkv")
    if m["attention_bias"]:
        q, k, v = (t + p[f"attn.b{n}"][l].to(t.dtype) for t, n in zip((q, k, v), "qkv"))
    q = rope(q.view(B, T, H, hd), m["rope_theta"]).transpose(1, 2)  # (B, H, T, hd)
    k = rope(k.view(B, T, K, hd), m["rope_theta"]).transpose(1, 2)
    v = v.view(B, T, K, hd).transpose(1, 2)
    k, v = k.repeat_interleave(H // K, dim=1), v.repeat_interleave(H // K, dim=1)  # query head h reads kv head h // G
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    o = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1).to(v.dtype) @ v
    return mm(o.transpose(1, 2).reshape(B, T, H * hd), p["attn.wo"][l], precision)


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor, precision: str) -> torch.Tensor:
    return mm(F.silu(mm(x, gate, precision)) * mm(x, up, precision), down, precision)


def moe(x: torch.Tensor, p: dict, l: int, m: dict, precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, d) → (y (N, d), the layer's aux loss)."""
    N, _ = x.shape
    E, k = m["n_experts"], m["top_k"]
    probs = torch.softmax(x.float() @ p["moe.router"][l], dim=-1)  # the router is fp32 in the control too
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)  # declared departure: renormalised
    f = torch.bincount(top_i.reshape(-1), minlength=E).float() / (N * k)
    aux = E * (f * probs.mean(dim=0)).sum()

    # each expert's queue: its (token, choice) slots in token order; a slot is
    # kept at its place in the queue while the place is under the capacity C
    C = capacity(N, k, E, m["capacity_factor"])
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    expert = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    place = torch.arange(N * k, device=x.device) - (torch.cumsum(counts, 0) - counts)[expert]
    kept = (place < C) & ~((place == 0) & (counts[expert] > C))  # declared departure: an overflowing expert loses place 0
    slot = expert[kept] * C + place[kept]
    token = torch.full((E * C,), N, dtype=torch.long, device=x.device).index_put((slot,), order[kept] // k)
    gate = torch.zeros(E * C, device=x.device).index_put((slot,), top_p.reshape(-1)[order[kept]])
    xe = torch.cat([x, x.new_zeros(1, x.shape[1])])[token].view(E, C, -1)  # an empty slot reads a zero row
    out = swiglu(xe, p["moe.we_gate"][l], p["moe.we_up"][l], p["moe.we_down"][l], precision)  # (E, C, d)
    y = x.new_zeros(N + 1, x.shape[1]).index_add(0, token, (out * gate.view(E, C, 1).to(out.dtype)).view(E * C, -1))[:N]
    if m["n_shared_experts"]:
        shared = swiglu(x, p["moe.ws_gate"][l], p["moe.ws_up"][l], p["moe.ws_down"][l], precision)
        y = y + shared * torch.sigmoid(x.float() @ p["moe.ws_gate_scalar"][l])[:, None].to(shared.dtype)
    return y, aux


def layer(x: torch.Tensor, p: dict, l: int, m: dict, precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    B, T, d = x.shape
    x = x + attention(rmsnorm(x, p["ln1"][l], m["rms_eps"]), p, l, m, precision)
    y, aux = moe(rmsnorm(x, p["ln2"][l], m["rms_eps"]).reshape(B * T, d), p, l, m, precision)
    return x + y.view(B, T, d), aux


def loss(p: dict, tokens: torch.Tensor, labels: torch.Tensor, m: dict, precision: str = "fp32") -> torch.Tensor:
    """Mean next-token cross-entropy over the real vocabulary plus
    ``router_aux_coef`` × the layers' aux losses. Each layer, and the LM
    head's logits for each ``HEAD_ROWS`` rows, is recomputed in the backward
    (``checkpoint``), which changes no value."""
    V = m["vocab"]
    x = p["embed"][tokens].to(act(precision))
    aux = torch.zeros((), device=x.device)
    for l in range(m["n_layers"]):
        x, a = checkpoint(layer, x, p, l, m, precision, use_reentrant=False)
        aux = aux + a
    x = rmsnorm(x, p["ln_f"], m["rms_eps"]).reshape(-1, x.shape[-1])
    head = (p["embed"] if m["tie_embeddings"] else p["out_embed"])[:V]
    labels = labels.reshape(-1)
    N = labels.shape[0]
    ce = sum(checkpoint(head_loss, x[i:i + HEAD_ROWS], head, labels[i:i + HEAD_ROWS], precision, use_reentrant=False)
             for i in range(0, N, HEAD_ROWS)) / N
    return ce + m["router_aux_coef"] * aux


def head_loss(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, precision: str) -> torch.Tensor:
    """The summed cross-entropy of rows x against the LM head."""
    return F.cross_entropy(mm(x, head.t(), precision).float(), labels, reduction="sum")
