"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local sliding
window attention, cyclic layer pattern (default R,R,A).

RG-LRU (arXiv:2402.19427):
    r_t = sigmoid(W_a x_t)            (recurrence gate)
    i_t = sigmoid(W_x x_t)            (input gate)
    a_t = exp(-c · softplus(Λ) · r_t) (per-channel decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

Prefill runs the recurrence over T in :func:`rglru_scan`: on CUDA tensors the
hand-written RG-LRU kernel (``csrc/rglru_scan.cu``), on CPU tensors its plain
sequential version (the reference runs an associative scan: the same
function, summed in another order). Decode is the O(1) :func:`rglru_step` in
torch ops, as in the reference. Local attention runs the flash kernel with
``window`` at prefill and the paged-decode kernel over the ``window``-slot
ring buffer at decode, on the card.

Parameters keep the reference's tree: ``slots`` (one per letter of the
pattern, leaves stacked over the ``n_groups`` repetitions) and ``rem`` (the
unrolled remainder, leaves stacked over 1), so ``state_dict`` key
``slots.0.mix.w_in`` is the reference's ``['slots'][0]['mix']['w_in']``. The
caches have the reference's layout too and are updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import kernel_path, resolve_device
from repro_torch import dist as rdist
from repro_torch.dist import Axes
from repro_torch.kernels import ops
from . import attention as attn_lib
from .common import (
    embed_axes,
    embed_tokens,
    gelu_tanh,
    init_truncated_normal_,
    layer_view,
    logits_from_hidden,
    rmsnorm,
    rope_tables,
    run_layer,
    sigmoid,
    softmax_cross_entropy,
    softplus,
)
from .transformer import apply_mlp, attn_axes, attn_params, init_attn_, init_mlp_, mlp_axes, mlp_params, qkv


def rec_block_axes() -> dict:
    """The reference's logical axes of a recurrent block's tree."""
    return {
        "w_in": Axes("layers", "param_embed", "rnn_width"),
        "w_gate_branch": Axes("layers", "param_embed", "rnn_width"),
        "conv_w": Axes("layers", "rnn_width", None),
        "conv_b": Axes("layers", "rnn_width"),
        "w_a": Axes("layers", "param_embed", "rnn_width"),
        "w_x": Axes("layers", "param_embed", "rnn_width"),
        "lam": Axes("layers", "rnn_width"),
        "w_out": Axes("layers", "rnn_width", "param_embed"),
    }

_C = 8.0  # RG-LRU temperature
CACHE_DTYPE = torch.bfloat16  # conv tails and ring K/V are bf16 whatever the compute dtype, as in the reference


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def rglru_scan(x, r, i, lam, h0=None):
    """x, r, i (B,T,W); lam (W,). Returns (y (B,T,W) in x's dtype, h_last
    (B,W) fp32). On the card's path through :class:`ops.RGLRU` (the
    kernel's forward, its gradient in torch ops)."""
    if kernel_path(x):
        return ops.RGLRU.apply(x, r, i, lam, h0)
    return ops.rglru(x, r, i, lam, h0)


def rglru_step(h, x, r, i, lam):
    """One decode step. h (B,W) fp32; x, r, i (B,W). Returns (y in x's
    dtype, new h fp32)."""
    log_a = r.float() * (-_C * softplus(lam.float()))
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    h = a * h + beta * (i.float() * x.float())
    return h.to(x.dtype), h


def _causal_conv(xw, conv_w, conv_b, state=None):
    """Depthwise causal conv along T, no activation. xw (B,T,W); conv_w
    (W,k); state (B,k-1,W) holds the previous inputs for decode. The taps are
    summed in the reference's order, then ``conv_b`` is added."""
    k = conv_w.shape[-1]
    T = xw.shape[1]
    w = conv_w.to(xw.dtype)
    pad = F.pad(xw, (0, 0, k - 1, 0)) if state is None else torch.cat([state.to(xw.dtype), xw], dim=1)
    out = pad[:, 0:T] * w[:, 0]
    for j in range(1, k):
        out = out + pad[:, j:j + T] * w[:, j]
    return out + conv_b.to(xw.dtype)


def _fill_ring(ring, kv):
    """Write the last ``min(T, S)`` positions of kv (B,T,K,hd) into the
    S-slot ring (B,S,K,hd) at slot ``position % S``, as the reference's
    ``ring_from_full``."""
    T, S = kv.shape[1], ring.shape[1]
    n = min(T, S)
    idx = (T - n + torch.arange(n, device=kv.device)) % S
    ring[:, idx] = kv[:, T - n:].to(ring.dtype)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class _Slot(nn.Module):
    """One letter of the layer pattern: the parameters of its layers,
    stacked on a leading axis of length ``L``."""

    def __init__(self, cfg, kind: str, L: int, p):
        super().__init__()
        self.kind = kind
        d = cfg.d_model
        self.ln1 = p(L, d)
        self.ln2 = p(L, d)
        if kind == "R":
            w = cfg.rnn_width or d
            self.mix = nn.ParameterDict({
                "w_in": p(L, d, w), "w_gate_branch": p(L, d, w), "conv_w": p(L, w, cfg.conv_kernel),
                "conv_b": p(L, w), "w_a": p(L, w, w), "w_x": p(L, w, w), "lam": p(L, w), "w_out": p(L, w, d),
            })
        else:
            self.mix = attn_params(cfg, L, p)
        self.mlp = mlp_params(cfg, L, p)

    def layer(self, g: int) -> dict:
        """The parameters of the slot's ``g``-th layer (views)."""
        return {"ln1": layer_view(self.ln1, g), "ln2": layer_view(self.ln2, g),
                "mix": {k: layer_view(v, g) for k, v in self.mix.items()},
                "mlp": {k: layer_view(v, g) for k, v in self.mlp.items()}}


class GriffinLM(nn.Module):
    """Parameters are created zero-filled on ``device`` in ``param_dtype``;
    :meth:`init` draws them, or ``load_state_dict`` loads a converted tree.
    Computation runs in ``cfg.dtype``. The layers run in a Python loop, group
    by group, then the remainder. Parameters do not require grad until
    ``requires_grad_()`` is called; on CUDA the RG-LRU kernel's gradient is
    :class:`ops.RGLRU`'s backward."""

    def __init__(self, cfg, device=None, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.family != "hybrid":
            raise NotImplementedError(f"family {cfg.family!r}: GriffinLM ports the hybrid family")
        self.cfg = cfg
        dev = resolve_device(device)
        self.pattern = cfg.layer_pattern or "A"
        self.n_groups = cfg.n_layers // len(self.pattern)
        self.rem_pattern = self.pattern[: cfg.n_layers - self.n_groups * len(self.pattern)]

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=param_dtype, device=dev), requires_grad=False)

        d, V = cfg.d_model, cfg.padded_vocab
        self.embed = p(V, d)
        self.ln_f = p(d)
        self.slots = nn.ModuleList(_Slot(cfg, kind, self.n_groups, p) for kind in self.pattern)
        self.rem = nn.ModuleList(_Slot(cfg, kind, 1, p) for kind in self.rem_pattern)
        if not cfg.tie_embeddings:
            self.out_embed = p(V, d)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "GriffinLM":
        """Draw the parameters with the reference's shapes and stds:
        ``std · truncated_normal(-2, 2)`` for the embeddings (padding rows
        zero, ``d^-½``), ``w_in``/``w_gate_branch`` (``d^-½``), ``conv_w``
        (0.2), ``w_a``/``w_x``/``w_out`` (``w^-½``) and the attention and MLP
        weights; ``lam = linspace(0.5, 4, w)`` in every layer; norms and
        ``conv_b`` zero. ``generator`` lives on the parameters' device."""
        cfg = self.cfg
        d = cfg.d_model
        w = cfg.rnn_width or d
        init_truncated_normal_(self.embed, d**-0.5, generator)
        self.embed[cfg.vocab:] = 0
        for slot in (*self.slots, *self.rem):
            if slot.kind == "R":
                mix = slot.mix
                for name, std in (("w_in", d**-0.5), ("w_gate_branch", d**-0.5), ("conv_w", 0.2),
                                  ("w_a", w**-0.5), ("w_x", w**-0.5), ("w_out", w**-0.5)):
                    init_truncated_normal_(mix[name], std, generator)
                mix["lam"].copy_(torch.linspace(0.5, 4.0, w).expand_as(mix["lam"]))
            else:
                init_attn_(slot.mix, cfg, generator)
            init_mlp_(slot.mlp, cfg, generator)
        if not cfg.tie_embeddings:
            init_truncated_normal_(self.out_embed, d**-0.5, generator)
            self.out_embed[cfg.vocab:] = 0
        return self

    def _slot_axes(self, kind: str) -> dict:
        return {"ln1": Axes("layers", "param_embed"), "ln2": Axes("layers", "param_embed"), "mlp": mlp_axes(self.cfg),
                "mix": rec_block_axes() if kind == "R" else attn_axes(self.cfg)}

    def param_axes(self) -> dict:
        """The logical axes of the parameter tree, key for key the reference's."""
        p = {"embed": embed_axes(), "ln_f": Axes("param_embed"),
             "slots": [self._slot_axes(k) for k in self.pattern],
             "rem": [self._slot_axes(k) for k in self.rem_pattern]}
        if not self.cfg.tie_embeddings:
            p["out_embed"] = embed_axes()
        return p

    def cache_axes(self) -> dict:
        """As the reference's: a recurrent slot's conv tail takes ``batch``
        where its state takes ``cache_batch``; ``rem`` drops the stacked dim."""
        def slot_ax(kind):
            if kind == "R":
                return {"conv": Axes("layers", "batch", None, "rnn_width"),
                        "h": Axes("layers", "cache_batch", "rnn_width")}
            return {"k": Axes("layers", "cache_batch", "kv_seq", "act_kv", None),
                    "v": Axes("layers", "cache_batch", "kv_seq", "act_kv", None)}

        return {"slots": [slot_ax(k) for k in self.pattern],
                "rem": [{name: Axes(*ax.t[1:]) for name, ax in slot_ax(k).items()} for k in self.rem_pattern],
                "length": Axes()}

    def _layers(self, cache: dict | None = None):
        """(kind, slot, index in the slot, layer cache or None) for every
        layer in order. The layer cache holds views into ``cache``."""
        for g in range(self.n_groups):
            for s, slot in enumerate(self.slots):
                lc = {k: v[g] for k, v in cache["slots"][s].items()} if cache is not None else None
                yield slot.kind, slot, g, lc
        for s, slot in enumerate(self.rem):
            yield slot.kind, slot, 0, cache["rem"][s] if cache is not None else None

    def _slot_layer(self, kind, slot, g, x, sin, cos, cache=None, pos=None):
        """Layer ``g`` of ``slot``: its parameters taken, then :meth:`_layer`
        (see :func:`~.common.run_layer`)."""
        return self._layer(kind, slot.layer(g), x, sin, cos, cache, pos)

    def _layer(self, kind, lp, x, sin, cos, cache=None, pos=None):
        """One layer. ``cache=None``: the whole sequence, no cache (forward).
        A cache and ``pos=None``: the whole prompt, the layer's cache written
        (prefill). ``pos``: one token at that position, the cache read and
        updated in place (decode)."""
        cfg = self.cfg
        B, T, _ = x.shape
        decoding = pos is not None
        h = rmsnorm(x, lp["ln1"], cfg.rms_eps)
        mix = lp["mix"]
        if kind == "R":
            xw = h @ mix["w_in"].to(h.dtype)
            gate = gelu_tanh(h @ mix["w_gate_branch"].to(h.dtype))
            k = cfg.conv_kernel
            conv_in = cache["conv"] if decoding else None
            tail_src = torch.cat([conv_in.to(xw.dtype), xw], dim=1) if decoding else xw
            conv_tail = F.pad(tail_src, (0, 0, k - 1, 0))[:, -(k - 1):]
            xc = _causal_conv(xw, mix["conv_w"], mix["conv_b"], conv_in)
            r = sigmoid(xc @ mix["w_a"].to(xc.dtype))
            i = sigmoid(xc @ mix["w_x"].to(xc.dtype))
            if decoding:
                y, h_last = rglru_step(cache["h"], xc[:, 0], r[:, 0], i[:, 0], mix["lam"])
                y = y[:, None]
            else:
                y, h_last = rglru_scan(xc, r, i, mix["lam"])
            mix_out = (y * gate) @ mix["w_out"].to(y.dtype)
            if cache is not None:
                cache["conv"].copy_(conv_tail)
                cache["h"].copy_(h_last)
        else:  # local attention
            q, kk, vv = qkv(mix, h, cfg, sin, cos)
            if decoding:
                kc = attn_lib.update_cache(cache["k"], kk, pos, ring=True)
                vc = attn_lib.update_cache(cache["v"], vv, pos, ring=True)
                ao = attn_lib.decode_attention(q, kc, vc, min(pos + 1, cfg.window))
            else:
                ao = attn_lib.full_attention(q, kk, vv, causal=True, window=cfg.window, q_chunk=2048)
                if cache is not None:
                    _fill_ring(cache["k"], kk)
                    _fill_ring(cache["v"], vv)
            mix_out = ao.reshape(B, T, -1) @ mix["wo"].to(x.dtype)
        x = x + mix_out
        h2 = rmsnorm(x, lp["ln2"], cfg.rms_eps)
        return x + apply_mlp(lp["mlp"], h2, cfg)

    def _out_embed(self, embed=None) -> torch.Tensor:
        """The output projection: when tied, the input embedding, or
        ``embed``, that already gathered."""
        if not self.cfg.tie_embeddings:
            return rdist.gather_param(self.out_embed)
        return rdist.gather_param(self.embed) if embed is None else embed

    def _head(self, x, embed=None):
        x = rmsnorm(x, rdist.gather_param(self.ln_f), self.cfg.rms_eps)
        return logits_from_hidden(x, self._out_embed(embed), self.cfg.vocab)

    def _run(self, tokens, cache=None, pos=None, remat=False, embed=None):
        """``embed``: the input embedding already gathered, else gathered here."""
        cfg = self.cfg
        T = tokens.shape[1]
        x = embed_tokens(rdist.gather_param(self.embed) if embed is None else embed, tokens, self.compute_dtype)
        positions = torch.arange(T, device=tokens.device) if pos is None else torch.tensor([pos], device=tokens.device)
        sin, cos = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
        for kind, slot, g, lc in self._layers(cache):
            x = run_layer(self._slot_layer, remat, kind, slot, g, x, sin, cos, lc, pos)
        return x

    # -- public api ---------------------------------------------------------
    def forward(self, tokens, *, remat: bool = False):
        """tokens (B,T) → (fp32 logits (B,T,V), aux loss 0). ``remat`` runs
        each layer's forward again in the backward."""
        embed = rdist.gather_param(self.embed)  # once: the tied head's too
        x = self._run(tokens, remat=remat, embed=embed)
        return self._head(x, embed), torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, batch: dict, *, remat: bool = True, q_chunk: int = 0):
        """(loss, metrics) of the next-token labels, as the reference's
        ``loss``; ``q_chunk`` is unused (the reference's is too)."""
        logits, _ = self.forward(batch["tokens"], remat=remat)
        return softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))

    def _slot_cache(self, kind: str, lead: tuple, batch: int) -> dict:
        cfg = self.cfg
        dev = self.device
        if kind == "R":
            w = cfg.rnn_width or cfg.d_model
            return {"conv": torch.zeros((*lead, batch, cfg.conv_kernel - 1, w), dtype=CACHE_DTYPE, device=dev),
                    "h": torch.zeros((*lead, batch, w), dtype=torch.float32, device=dev)}
        shape = (*lead, batch, cfg.window, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=CACHE_DTYPE, device=dev),
                "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=dev)}

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Per slot, stacked over the groups: conv tails (G,B,k-1,w) bf16 and
        RG-LRU states (G,B,w) fp32 for R, ring K/V (G,B,window,K,hd) bf16 for
        A; ``rem`` without the leading axis. The size does not depend on
        ``max_len``."""
        return {
            "slots": [self._slot_cache(kind, (self.n_groups,), batch) for kind in self.pattern],
            "rem": [self._slot_cache(kind, (), batch) for kind in self.rem_pattern],
            "length": 0,
        }

    def prefill(self, tokens, *, pad_to: int | None = None):
        """Run the prompt, build the decode caches (ring K/V of the last
        ``window`` positions for A, conv tail and RG-LRU state for R), return
        last-token logits. ``pad_to`` is ignored, as in the reference: the
        caches have no length axis beyond the window."""
        cache = self.init_cache(tokens.shape[0], tokens.shape[1])
        cache["length"] = tokens.shape[1]
        x = self._run(tokens, cache)
        return self._head(x[:, -1:])[:, 0], cache

    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B,1) at position ``cache['length']``. The cache tensors are
        updated in place (the reference returns new arrays); the returned dict
        holds the same tensors and the new length."""
        pos = int(cache["length"])
        x = self._run(tokens, cache, pos)
        logits = self._head(x)[:, 0]
        return logits, {"slots": cache["slots"], "rem": cache["rem"], "length": pos + 1}
