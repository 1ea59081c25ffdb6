"""Mamba-2 (SSD — state-space duality), attention-free LM.

Chunked SSD per the paper's Listing 1 (arXiv:2405.21060): within a chunk the
recurrence is an attention-like quadratic block; across chunks a small
(H, P, N) state is carried. Decode is an O(1) recurrent state update.

On CPU tensors :func:`ssd_chunked` is a faithful port of the reference's jnp
body (with its casts to x's dtype and any number of groups). On CUDA tensors
it runs the two hand-written SSD kernels (``csrc/ssd_scan.cu``), which keep
every intermediate and the carried state in fp32 and take one group; meta
tensors take that path too, shapes only (:func:`repro_torch.device.kernel_path`).

Layout: x (B, T, H, P) heads; B/C (B, T, G, N) groups (G = 1 for
mamba2-1.3b); state (B, H, P, N). Parameters keep the reference's tree
(layer-stacked ``(L, …)`` leaves, same names), so a converted JAX tree loads
with ``load_state_dict``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import kernel_path, resolve_device
from repro_torch import dist as rdist
from repro_torch.dist import Axes
from repro_torch.kernels import ops
from .common import (
    embed_axes,
    embed_tokens,
    init_truncated_normal_,
    layer_view,
    logits_from_hidden,
    rmsnorm,
    run_layer,
    softmax_cross_entropy,
    softplus,
)

NEG_INF = -1e30
CACHE_DTYPE = torch.bfloat16  # the conv cache is bf16 whatever the compute dtype, as in the reference
LAYER_PARAMS = ("ln", "in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D", "norm", "out_proj")


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_in, nh, conv_dim


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x, dA, B, C, chunk: int):
    """x (b,t,h,p); dA (b,t,h) log-decay (≤0); B,C (b,t,g,n).
    Returns (y (b,t,h,p) in x's dtype, final_state (b,h,p,n)): the state in
    x's dtype on the CPU, as the reference; fp32 from the CUDA kernels,
    through :class:`ops.SSDScan` (the kernels' forward, their gradient in
    torch ops)."""
    if kernel_path(x):
        return ops.SSDScan.apply(x, dA, B, C, chunk)
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    t_orig = t
    if t % chunk:
        # pad with identity steps: dA=0 (decay 1), B·x=0 — state unaffected
        pad = chunk - t % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        t = x.shape[1]
    nc = t // chunk

    xc = x.reshape(b, nc, chunk, g, hpg, p)
    Ac = dA.reshape(b, nc, chunk, g, hpg)
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)

    cum = torch.cumsum(Ac, dim=2)  # (b,nc,cs,g,hpg)

    # --- intra-chunk (diagonal blocks) ---
    seg = cum[:, :, :, None] - cum[:, :, None, :]  # (b,nc,i,j,g,hpg)
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    L = torch.exp(torch.where(causal[None, None, :, :, None, None], seg, NEG_INF))
    CB = torch.einsum("bcign,bcjgn->bcijg", Cc.float(), Bc.float())
    scores = CB[..., None] * L  # (b,nc,i,j,g,hpg)
    y_diag = torch.einsum("bcijgh,bcjghp->bcighp", scores.to(x.dtype), xc)

    # --- chunk states ---
    decay_states = torch.exp(cum[:, :, -1:] - cum)  # (b,nc,cs,g,hpg)
    S = torch.einsum("bcjgn,bcjgh,bcjghp->bcghpn", Bc, decay_states.to(x.dtype), xc)

    # --- inter-chunk recurrence ---
    chunk_decay = torch.exp(cum[:, :, -1])  # (b,nc,g,hpg)
    H = torch.zeros((b, g, hpg, p, n), dtype=x.dtype, device=x.device)
    H_in = []
    for c in range(nc):
        H_in.append(H)  # the state ENTERING chunk c
        H = chunk_decay[:, c, ..., None, None].to(x.dtype) * H + S[:, c]
    H_in = torch.stack(H_in, dim=1)  # (b,nc,g,hpg,p,n)

    # --- off-diagonal contribution from carried state ---
    state_decay = torch.exp(cum)  # (b,nc,cs,g,hpg)
    y_off = torch.einsum("bcign,bcghpn,bcigh->bcighp", Cc, H_in, state_decay.to(x.dtype))

    y = (y_diag + y_off).reshape(b, t, h, p)[:, :t_orig]
    return y, H.reshape(b, h, p, n)


def ssd_decode_step(state, x, dA, B, C):
    """One-token update (fp32 state). state (b,h,p,n); x (b,h,p); dA (b,h);
    B,C (b,g,n)."""
    b, h, p, n = state.shape
    g = B.shape[1]
    hpg = h // g
    st = state.reshape(b, g, hpg, p, n).float()
    xg = x.reshape(b, g, hpg, p).float()
    dAg = torch.exp(dA).reshape(b, g, hpg)
    st = st * dAg[..., None, None] + torch.einsum("bgn,bghp->bghpn", B.float(), xg)
    y = torch.einsum("bgn,bghpn->bghp", C.float(), st)
    return y.reshape(b, h, p).to(x.dtype), st.reshape(b, h, p, n)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class Mamba2LM(nn.Module):
    """Parameters are created zero-filled on ``device`` in ``param_dtype``;
    :meth:`init` draws them, or ``load_state_dict`` loads a converted tree.
    Computation runs in ``cfg.dtype``. The layers run in a Python loop over
    per-layer views of the stacked tensors. Parameters do not require grad
    until ``requires_grad_()`` is called; on CUDA the SSD kernels' gradient
    is :class:`ops.SSDScan`'s backward."""

    def __init__(self, cfg, device=None, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.family != "ssm":
            raise NotImplementedError(f"family {cfg.family!r}: Mamba2LM ports the ssm family")
        self.cfg = cfg
        dev = resolve_device(device)
        d, L, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab
        d_in, nh, conv_dim = _dims(cfg)
        proj_out = 2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state + nh

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=param_dtype, device=dev), requires_grad=False)

        self.embed = p(V, d)
        self.ln = p(L, d)
        self.ln_f = p(d)
        self.in_proj = p(L, d, proj_out)
        self.conv_w = p(L, conv_dim, cfg.conv_kernel)
        self.conv_b = p(L, conv_dim)
        self.A_log = p(L, nh)
        self.dt_bias = p(L, nh)
        self.D = p(L, nh)
        self.norm = p(L, d_in)
        self.out_proj = p(L, d_in, d)
        if not cfg.tie_embeddings:
            self.out_embed = p(V, d)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Mamba2LM":
        """Draw the parameters with the reference's shapes and stds:
        ``std · truncated_normal(-2, 2)`` for the embedding (padding rows
        zero), ``in_proj``, ``conv_w`` (0.2) and ``out_proj``;
        ``A_log = log(linspace(1, 16, nh))``, ``dt_bias = -2``, ``D = 1``,
        norms and ``conv_b`` zero. ``generator`` lives on the parameters'
        device."""
        cfg = self.cfg
        d = cfg.d_model
        d_in, nh, _ = _dims(cfg)
        init_truncated_normal_(self.embed, d**-0.5, generator)
        self.embed[cfg.vocab:] = 0
        init_truncated_normal_(self.in_proj, d**-0.5, generator)
        init_truncated_normal_(self.conv_w, 0.2, generator)
        init_truncated_normal_(self.out_proj, d_in**-0.5, generator)
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh)).expand(cfg.n_layers, nh))
        self.dt_bias.fill_(-2.0)
        self.D.fill_(1.0)
        if not cfg.tie_embeddings:
            init_truncated_normal_(self.out_embed, d**-0.5, generator)
            self.out_embed[cfg.vocab:] = 0
        return self

    def param_axes(self) -> dict:
        """The logical axes of the parameter tree, key for key the reference's."""
        p = {
            "embed": embed_axes(),
            "ln": Axes("layers", "param_embed"),
            "ln_f": Axes("param_embed"),
            "in_proj": Axes("layers", "param_embed", "rnn_width"),
            "conv_w": Axes("layers", "conv_dim", None),
            "conv_b": Axes("layers", "conv_dim"),
            "A_log": Axes("layers", "ssm_heads"),
            "dt_bias": Axes("layers", "ssm_heads"),
            "D": Axes("layers", "ssm_heads"),
            "norm": Axes("layers", "rnn_width"),
            "out_proj": Axes("layers", "rnn_width", "param_embed"),
        }
        if not self.cfg.tie_embeddings:
            p["out_embed"] = embed_axes()
        return p

    def cache_axes(self) -> dict:
        return {
            "conv": Axes("layers", "cache_batch", None, "conv_dim"),
            "ssm": Axes("layers", "cache_batch", "ssm_heads", None, "ssm_state"),
            "length": Axes(),
        }

    def _layer_params(self, l: int) -> dict:
        return {k: layer_view(getattr(self, k), l) for k in LAYER_PARAMS}

    def _out_embed(self, embed=None) -> torch.Tensor:
        """The output projection: when tied, the input embedding, or
        ``embed``, that already gathered."""
        if not self.cfg.tie_embeddings:
            return rdist.gather_param(self.out_embed)
        return rdist.gather_param(self.embed) if embed is None else embed

    def _layer_at(self, l, x):
        """Layer ``l``'s parameters taken, then :meth:`_layer` (see
        :func:`~.common.run_layer`): x."""
        return self._layer(self._layer_params(l), x)[0]

    def _conv(self, lp, xBC, conv_state=None):
        """Causal depthwise conv along T. xBC (B,T,conv_dim); the taps are
        summed in the reference's order."""
        k = self.cfg.conv_kernel
        T = xBC.shape[1]
        w = lp["conv_w"].to(xBC.dtype)  # (conv_dim, k)
        if conv_state is None:
            pad = F.pad(xBC, (0, 0, k - 1, 0))
        else:
            pad = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
        out = pad[:, 0:T] * w[:, 0]
        for i in range(1, k):
            out = out + pad[:, i:i + T] * w[:, i]
        return F.silu(out + lp["conv_b"].to(xBC.dtype))

    def _layer(self, lp, x, state=None):
        """One block. ``state=None`` runs the whole sequence (chunked SSD);
        ``state=(conv, ssm)`` runs one token. Returns (x, conv state, ssm
        state): the last ``k-1`` inputs of the conv, and the SSD state."""
        cfg = self.cfg
        d_in, nh, _ = _dims(cfg)
        hd, g, n, k = cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state, cfg.conv_kernel
        B_, T, _ = x.shape
        h = rmsnorm(x, lp["ln"], cfg.rms_eps)
        zxbcdt = h @ lp["in_proj"].to(h.dtype)
        z, xBC, dt = torch.split(zxbcdt, [d_in, d_in + 2 * g * n, nh], dim=-1)
        if state is None:
            conv_new = F.pad(xBC, (0, 0, k - 1, 0))[:, -(k - 1):]
            xBC = self._conv(lp, xBC)
        else:
            conv_state, ssm_state = state
            conv_new = torch.cat([conv_state[:, 1:].to(xBC.dtype), xBC], dim=1)
            xBC = self._conv(lp, xBC, conv_state)

        xs, Bc, Cc = torch.split(xBC, [d_in, g * n, g * n], dim=-1)
        xs = xs.reshape(B_, T, nh, hd)
        Bc = Bc.reshape(B_, T, g, n)
        Cc = Cc.reshape(B_, T, g, n)
        dt = softplus(dt.float() + lp["dt_bias"].float())
        A = -torch.exp(lp["A_log"].float())  # (nh,)
        dA = dt * A  # (B,T,nh) log-decay
        x_in = xs * dt.to(xs.dtype)[..., None]

        if state is None:
            y, ssm_new = ssd_chunked(x_in, dA, Bc, Cc, min(cfg.ssm_chunk, T))
        else:
            y, ssm_new = ssd_decode_step(ssm_state, x_in[:, 0], dA[:, 0], Bc[:, 0], Cc[:, 0])
            y = y[:, None]
        y = y + lp["D"].to(y.dtype)[None, None, :, None] * xs
        y = y.reshape(B_, T, d_in)
        y = rmsnorm(y * F.silu(z), lp["norm"], cfg.rms_eps)
        out = y @ lp["out_proj"].to(y.dtype)
        return x + out, conv_new, ssm_new

    def _head(self, x, embed=None):
        x = rmsnorm(x, rdist.gather_param(self.ln_f), self.cfg.rms_eps)
        return logits_from_hidden(x, self._out_embed(embed), self.cfg.vocab)

    # -- public api ---------------------------------------------------------
    def forward(self, tokens, *, remat: bool = False):
        """tokens (B,T) → (fp32 logits (B,T,V), aux loss 0). ``remat`` runs
        each layer's forward again in the backward."""
        embed = rdist.gather_param(self.embed)  # once: the tied head's too
        x = embed_tokens(embed, tokens, self.compute_dtype)
        for l in range(self.cfg.n_layers):
            x = run_layer(self._layer_at, remat, l, x)
        return self._head(x, embed), torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, batch: dict, *, remat: bool = True, q_chunk: int = 0):
        """(loss, metrics) of the next-token labels, as the reference's
        ``loss``; ``q_chunk`` is unused (no attention)."""
        logits, _ = self.forward(batch["tokens"], remat=remat)
        return softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Conv tails (L,B,k-1,conv_dim) bf16 and SSD states (L,B,nh,p,n)
        fp32; the size does not depend on ``max_len``."""
        cfg = self.cfg
        _, nh, conv_dim = _dims(cfg)
        L = cfg.n_layers
        return {
            "conv": torch.zeros((L, batch, cfg.conv_kernel - 1, conv_dim), dtype=CACHE_DTYPE, device=self.device),
            "ssm": torch.zeros((L, batch, nh, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32,
                               device=self.device),
            "length": 0,
        }

    def prefill(self, tokens, *, pad_to: int | None = None):
        """Run the full prompt, build the recurrent cache, return last-token
        logits. ``pad_to`` is ignored: the cache has no length axis."""
        B, T = tokens.shape
        cache = self.init_cache(B, T)
        cache["length"] = T
        x = embed_tokens(self.embed, tokens, self.compute_dtype)
        for l in range(self.cfg.n_layers):
            x, conv, ssm = self._layer(self._layer_params(l), x)
            cache["conv"][l] = conv.to(CACHE_DTYPE)
            cache["ssm"][l] = ssm.float()
        return self._head(x[:, -1:])[:, 0], cache

    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B,1). The cache tensors are updated in place (the
        reference returns new arrays); the returned dict holds the same
        tensors and the new length."""
        x = embed_tokens(self.embed, tokens, self.compute_dtype)
        for l in range(self.cfg.n_layers):
            x, conv, ssm = self._layer(self._layer_params(l), x, (cache["conv"][l], cache["ssm"][l]))
            cache["conv"][l] = conv.to(CACHE_DTYPE)
            cache["ssm"][l] = ssm
        logits = self._head(x)[:, 0]
        return logits, {"conv": cache["conv"], "ssm": cache["ssm"], "length": int(cache["length"]) + 1}
