"""Plain PyTorch reference of the Mamba-2 language model that the SSD training
cells run, in float32 (TF32 off), with no kernel, cache or batching of the
port's.

It follows arXiv:2405.21060 and the published block (mamba_ssm's
``Mamba2`` in ``MambaLMHeadModel``). Each layer is a pre-norm residual
block:

- ``in_proj`` splits into z, xBC and dt;
- a causal depthwise conv of width ``conv_kernel`` with bias runs over xBC,
  then SiLU; xBC splits into x (heads of ``ssm_head_dim``), B and C
  (``ssm_groups`` groups of ``ssm_state``);
- dt = softplus(dt + dt_bias), A = −exp(A_log);
- the SSD of x·dt with the log-decays A·dt, computed as the paper's Listing
  1 (``ssd_minimal_discrete``: segsum, the diagonal blocks inside each
  chunk, the chunk states, the recurrence across chunks, states to outputs)
  at the configuration's chunk;
- the skip D·x; the gated RMSNorm rmsnorm(y · silu(z)) (norm_before_gate
  False); ``out_proj``.

Then the final norm, the LM head tied to the embedding over the real
vocabulary, and the mean next-token cross-entropy. The departures the
program declares (the configuration file lists them), each written where it
applies: norms scale by ``1 + scale``, with the model block's ``rms_eps``
(mamba_ssm: 1e-5); the softmax runs over the ids of the model block's
``vocab``.

``precision="fp8"`` is the control, as :mod:`.model`'s: the activations in
bf16 as the program keeps them (dt, the decays, the SSD's sums, the norms and
the loss in fp32, as the program's kernels and norms keep them), and
``in_proj``, ``out_proj`` and the LM head fp8 products: both operands
rounded to e4m3 under a per-tensor scale in the forward, the incoming
gradient to e5m2 in the backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .model import HEAD_ROWS, act, head_loss, mm, rmsnorm


def dims(m: dict) -> tuple[int, int]:
    """(d_in, heads): d_in = expand·d, in heads of ``ssm_head_dim``."""
    d_in = m["ssm_expand"] * m["d_model"]
    return d_in, d_in // m["ssm_head_dim"]


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) → (..., T, T): [i, j] = Σ x_k over j < k ≤ i where j ≤ i,
    −inf above the diagonal (Listing 1's stable segment sum)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(-1)
    s = torch.cumsum(x.masked_fill(~below, 0), dim=-2)
    return s.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=x.device).tril(), float("-inf"))


def ssd(X: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, chunk: int):
    """Listing 1's ``ssd_minimal_discrete`` over groups: X (b, t, h, p), A
    (b, t, h) log-decays, B and C (b, t, g, n), head i reading group
    i // (h / g) → (Y (b, t, h, p), the final state (b, h, p, n)), in X's
    dtype. Chunks of ``min(chunk, t)``; a ragged last chunk is padded with
    identity steps (A = 0, B = 0) and cut off again."""
    b, t, h, p = X.shape
    g, n = B.shape[2], B.shape[3]
    ln = min(chunk, t)
    pad = -t % ln
    if pad:
        X, B, C = (F.pad(z, (0, 0, 0, 0, 0, pad)) for z in (X, B, C))
        A = F.pad(A, (0, 0, 0, pad))
    c = X.shape[1] // ln
    X = X.reshape(b, c, ln, h, p)
    B, C = B.reshape(b, c, ln, g, n), C.reshape(b, c, ln, g, n)
    A = A.reshape(b, c, ln, h).permute(0, 3, 1, 2)  # (b, h, c, l)
    A_cumsum = torch.cumsum(A, dim=-1)
    group = torch.arange(h, device=X.device) // (h // g)

    # 1. the diagonal blocks: C·Bᵀ once per group, masked by the decays per head
    CB = torch.einsum("bclgn,bcsgn->bcgls", C, B)[:, :, group]  # (b, c, h, l, s)
    L = torch.exp(segsum(A)).permute(0, 2, 1, 3, 4)  # (b, c, h, l, s)
    Y_diag = torch.einsum("bchls,bcshp->bclhp", CB * L, X)

    # 2. each chunk's state from its own inputs
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum).permute(0, 2, 3, 1)  # (b, c, l, h)
    states = torch.einsum("bclhn,bclhp->bchpn", B[:, :, :, group], X * decay_states[..., None])

    # 3. the recurrence across chunks, from a zero state
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cumsum[..., -1], (1, 0))))  # (b, h, c + 1, c + 1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states, final = new_states[:, :-1], new_states[:, -1]

    # 4. the state entering each chunk to its outputs
    state_decay_out = torch.exp(A_cumsum).permute(0, 2, 3, 1)  # (b, c, l, h)
    Y_off = torch.einsum("bclhn,bchpn->bclhp", C[:, :, :, group], states) * state_decay_out[..., None]
    return (Y_diag + Y_off).reshape(b, c * ln, h, p)[:, :t], final


def conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The causal depthwise conv along T: x (B, T, ch), w (ch, k), bias
    (ch,); position t sees x_{t−k+1} … x_t, w[:, k−1] weighing x_t."""
    k = w.shape[1]
    y = F.conv1d(F.pad(x.transpose(1, 2), (k - 1, 0)), w[:, None, :].to(x.dtype), bias.to(x.dtype),
                 groups=w.shape[0])
    return y.transpose(1, 2)


def layer(x: torch.Tensor, p: dict, l: int, m: dict, precision: str) -> torch.Tensor:
    Bsz, T, _ = x.shape
    d_in, nh = dims(m)
    g, n, hd, eps = m["ssm_groups"], m["ssm_state"], m["ssm_head_dim"], m["rms_eps"]
    zxbcdt = mm(rmsnorm(x, p["ln"][l], eps), p["in_proj"][l], precision)
    z, xBC, dt = torch.split(zxbcdt, [d_in, d_in + 2 * g * n, nh], dim=-1)
    xBC = F.silu(conv(xBC, p["conv_w"][l], p["conv_b"][l]))
    xs, Bm, Cm = torch.split(xBC, [d_in, g * n, g * n], dim=-1)
    xs = xs.reshape(Bsz, T, nh, hd)
    dt = F.softplus(dt.float() + p["dt_bias"][l])  # (B, T, heads), fp32 in the control too
    A = -torch.exp(p["A_log"][l])
    x_in = xs * dt.to(xs.dtype)[..., None]
    y, _ = ssd(x_in.float(), dt * A, Bm.reshape(Bsz, T, g, n).float(), Cm.reshape(Bsz, T, g, n).float(),
               m["ssm_chunk"])
    y = y.to(xs.dtype) + p["D"][l].to(xs.dtype)[:, None] * xs
    y = rmsnorm(y.reshape(Bsz, T, d_in) * F.silu(z), p["norm"][l], eps)
    return x + mm(y, p["out_proj"][l], precision)


def loss(p: dict, tokens: torch.Tensor, labels: torch.Tensor, m: dict, precision: str = "fp32") -> torch.Tensor:
    """Mean next-token cross-entropy over the real vocabulary. Each layer, and
    the LM head's logits for each ``HEAD_ROWS`` rows, is recomputed in the
    backward (``checkpoint``), which changes no value."""
    V = m["vocab"]
    x = p["embed"][tokens].to(act(precision))
    for l in range(m["n_layers"]):
        x = checkpoint(layer, x, p, l, m, precision, use_reentrant=False)
    x = rmsnorm(x, p["ln_f"], m["rms_eps"]).reshape(-1, x.shape[-1])
    head = (p["embed"] if m["tie_embeddings"] else p["out_embed"])[:V]
    labels = labels.reshape(-1)
    N = labels.shape[0]
    return sum(checkpoint(head_loss, x[i:i + HEAD_ROWS], head, labels[i:i + HEAD_ROWS], precision, use_reentrant=False)
               for i in range(0, N, HEAD_ROWS)) / N
