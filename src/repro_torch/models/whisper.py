"""Whisper-style encoder-decoder (the audio family), as the reference's
``repro/models/whisper.py``.

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, enc_len, d_model), adds sinusoidal
positions and runs bidirectional self-attention; the decoder is a causal LM
with learned positions, cross-attention over the encoder's output and the
input embedding tied to the output. LayerNorm and a GELU MLP in every layer.

On CUDA tensors every attention runs a kernel of the port. In prefill the
flash kernel runs the encoder's self-attention (T = S = enc_len,
non-causal), the decoder's causal self-attention (T = S = prompt) and its
cross-attention (T = prompt, S = enc_len, non-causal). In decode the
paged-decode kernel runs the decoder's self-attention over its cache and
its cross-attention over all enc_len slots of the cross cache.

Parameters keep the reference's tree (``embed``, ``dec_pos``,
``enc.{ln1,ln2,attn.*,mlp.*}``, ``enc_ln_f``, ``dec.{ln1,ln2,ln3,attn.*,
cross.*,mlp.*}``, ``dec_ln_f``; per-layer leaves stacked on a leading axis),
so a converted JAX tree loads with ``load_state_dict``. The cache is the
reference's: ``k``/``v`` (the decoder's self K/V, L × B × max_len slots),
``ck``/``cv`` (the cross K/V, L × B × enc_len), all bf16, and ``length``.
Prefill attends over the cross K/V in the compute dtype and caches them
rounded to bf16; decode attends over the bf16 copies.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch import dist as rdist
from repro_torch import trace
from repro_torch.dist import Axes
from . import attention as attn_lib
from .common import (
    embed_axes,
    embed_tokens,
    init_truncated_normal_,
    layer_view,
    layernorm,
    logits_from_hidden,
    run_layer,
    softmax_cross_entropy,
)
from .transformer import (CACHE_DTYPE, apply_mlp, attn_axes, attn_params, init_attn_, init_mlp_, mlp_axes, mlp_params,
                          qkv)

MAX_DEC_POS = 40960  # rows of the learned decoder positions, as the reference's table
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
             5.0000001201e-1)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of an fp32 CPU tensor as XLA's CPU backend evaluates it:
    Cephes' polynomial, its multiply-adds fused (formed in fp64, where the
    product of two fp32 values is exact, then rounded once). ``torch.exp``
    rounds 35 of whisper-small's 384 position frequencies to the other
    neighbouring fp32 value, and pos·f then moves by up to 1.2e-4 at pos
    1499; a correctly rounded exp (``torch.exp`` in fp64, rounded to fp32)
    differs at 41. With this exp the frequencies are the reference's bit for
    bit under jaxlib 0.9.0 on the CPU (another jaxlib, or XLA on another
    backend, may evaluate exp otherwise: ``test_sinusoid_pos_matches_reference``
    in ``tests/test_torch_whisper.py`` would show it)."""
    def c(v):
        return torch.full_like(x, v)

    def fma(a, b, d):
        return (a.double() * b.double() + d.double()).float()

    x = x.clamp(-87.8, 88.8)
    n = torch.floor(fma(x, c(1.44269504088896341), c(0.5)))
    r = x - c(0.693359375) * n
    r = r - c(-2.12194440e-4) * n
    z = fma(r, c(_EXP_POLY[0]), c(_EXP_POLY[1]))
    for p in _EXP_POLY[2:]:
        z = fma(z, r, c(p))
    z = 1.0 + fma(z, r * r, r)
    return torch.ldexp(z, n)


@functools.lru_cache(maxsize=8)
def sinusoid_pos(T: int, d: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(T, d) fp32 encoder positions, ``[sin(t·f), cos(t·f)]`` with
    ``f_i = exp(−ln(10⁴)·i/(d/2 − 1))``, computed in fp32 on the CPU as the
    reference computes them, then kept on ``device``. Do not write into the
    returned tensor: it is cached."""
    half = d // 2
    freqs = _exp_f32(-math.log(10000.0) * torch.arange(half, dtype=torch.float32) / (half - 1))
    ang = torch.arange(T, dtype=torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(device)


class _Stack(nn.Module):
    """The layer-stacked parameters of the encoder (``ln1``, ``ln2``,
    ``attn``, ``mlp``) or of the decoder (also ``ln3`` and ``cross``)."""

    def __init__(self, cfg, L: int, p, decoder: bool):
        super().__init__()
        d = cfg.d_model
        self.ln1, self.ln2 = p(L, d), p(L, d)
        self.attn = attn_params(cfg, L, p)
        if decoder:
            self.ln3 = p(L, d)
            self.cross = attn_params(cfg, L, p)
        self.mlp = mlp_params(cfg, L, p)

    def layer(self, l: int) -> dict:
        lp = {name: layer_view(t, l) for name, t in self.named_parameters(recurse=False)}
        lp.update({name: {k: layer_view(t, l) for k, t in leaves.items()} for name, leaves in self.named_children()})
        return lp


class WhisperModel(nn.Module):
    """Parameters are created zero-filled on ``device`` in ``param_dtype``;
    :meth:`init` draws them, or ``load_state_dict`` loads a converted tree.
    Computation runs in ``cfg.dtype``. Parameters do not require grad until
    ``requires_grad_()`` is called on the module."""

    def __init__(self, cfg, device=None, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.family != "audio":
            raise NotImplementedError(f"family {cfg.family!r}: WhisperModel runs the audio family")
        self.cfg = cfg
        dev = resolve_device(device)
        d = cfg.d_model

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=param_dtype, device=dev), requires_grad=False)

        self.embed = p(cfg.padded_vocab, d)
        self.dec_pos = p(MAX_DEC_POS, d)
        self.enc = _Stack(cfg, cfg.enc_layers, p, decoder=False)
        self.enc_ln_f = p(d)
        self.dec = _Stack(cfg, cfg.n_layers, p, decoder=True)
        self.dec_ln_f = p(d)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # -- init ----------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "WhisperModel":
        """Draw the parameters with the reference's shapes and stds:
        ``std · truncated_normal(-2, 2)`` with std ``d^-½`` for the
        embedding (vocab padding rows zero), 0.02 for ``dec_pos``, and
        :func:`.transformer.init_attn_` / ``init_mlp_``'s for every
        attention (self and cross) and MLP; norms and biases zero.
        ``generator`` lives on the parameters' device."""
        cfg = self.cfg
        init_truncated_normal_(self.embed, cfg.d_model**-0.5, generator)
        self.embed[cfg.vocab:] = 0
        init_truncated_normal_(self.dec_pos, 0.02, generator)
        for attn in (self.enc.attn, self.dec.attn, self.dec.cross):
            init_attn_(attn, cfg, generator)
        for mlp in (self.enc.mlp, self.dec.mlp):
            init_mlp_(mlp, cfg, generator)
        return self

    def param_axes(self) -> dict:
        """The logical axes of the parameter tree, key for key the reference's."""
        cfg = self.cfg
        ln = Axes("layers", "param_embed")
        enc = {"ln1": ln, "ln2": ln, "attn": attn_axes(cfg), "mlp": mlp_axes(cfg)}
        dec = {"ln1": ln, "ln2": ln, "ln3": ln, "attn": attn_axes(cfg), "cross": attn_axes(cfg), "mlp": mlp_axes(cfg)}
        return {"embed": embed_axes(), "dec_pos": Axes("param_seq", "param_embed"), "enc": enc,
                "enc_ln_f": Axes("param_embed"), "dec": dec, "dec_ln_f": Axes("param_embed")}

    def cache_axes(self) -> dict:
        return {
            "k": Axes("layers", "cache_batch", "kv_seq", "act_kv", None),
            "v": Axes("layers", "cache_batch", "kv_seq", "act_kv", None),
            "ck": Axes("layers", "cache_batch", None, "act_kv", None),
            "cv": Axes("layers", "cache_batch", None, "act_kv", None),
            "length": Axes(),
        }

    # -- encoder -------------------------------------------------------------
    def _enc_layer(self, lp, x, q_chunk):
        cfg = self.cfg
        B, T, _ = x.shape
        q, k, v = qkv(lp["attn"], layernorm(x, lp["ln1"], cfg.rms_eps), cfg, None, None)
        ao = attn_lib.full_attention(q, k, v, causal=False, q_chunk=q_chunk)
        x = x + ao.reshape(B, T, -1) @ lp["attn"]["wo"].to(x.dtype)
        return x + apply_mlp(lp["mlp"], layernorm(x, lp["ln2"], cfg.rms_eps), cfg)

    def _enc_layer_at(self, l, x, q_chunk):
        """Encoder layer ``l``'s parameters taken, then :meth:`_enc_layer`
        (see :func:`~.common.run_layer`)."""
        return self._enc_layer(self.enc.layer(l), x, q_chunk)

    @trace.spanned("whisper.encode")
    def encode(self, enc_embeds, *, remat: bool = False, q_chunk: int = 2048) -> torch.Tensor:
        """Frame embeddings (B, S, d) → the encoder's output (B, S, d) in
        the compute dtype."""
        cfg = self.cfg
        dtype = self.compute_dtype
        x = enc_embeds.to(dtype)
        x = x + sinusoid_pos(x.shape[1], cfg.d_model, x.device).to(dtype)
        for l in range(cfg.enc_layers):
            x = run_layer(self._enc_layer_at, remat, l, x, q_chunk)
        return layernorm(x, rdist.gather_param(self.enc_ln_f), cfg.rms_eps)

    # -- decoder -------------------------------------------------------------
    def _cross_kv(self, lp, enc_out):
        """One layer's cross-attention K/V over the encoder's output:
        (B, S, K, hd) each, in its dtype."""
        cfg = self.cfg
        B, S, _ = enc_out.shape
        k = enc_out @ lp["wk"].to(enc_out.dtype)
        v = enc_out @ lp["wv"].to(enc_out.dtype)
        if cfg.attention_bias:
            k = k + lp["bk"].to(k.dtype)
            v = v + lp["bv"].to(v.dtype)
        shape = (B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        return k.reshape(shape), v.reshape(shape)

    def _cross(self, lp, h, ck, cv, q_chunk=None):
        """Cross-attention of h (B, T, d) over ck/cv (B, S, K, hd), output
        projected: the flash kernel's non-causal attention, or with
        ``q_chunk`` None (decode, T 1) the paged-decode kernel over all S
        slots."""
        cfg = self.cfg
        B, T, _ = h.shape
        qc = h @ lp["wq"].to(h.dtype)
        if cfg.attention_bias:
            qc = qc + lp["bq"].to(h.dtype)
        qc = qc.reshape(B, T, cfg.n_heads, cfg.resolved_head_dim)
        if q_chunk is None:
            co = attn_lib.decode_attention(qc, ck, cv, ck.shape[1])
        else:
            co = attn_lib.full_attention(qc, ck, cv, causal=False, q_chunk=q_chunk)
        return co.reshape(B, T, -1) @ lp["wo"].to(h.dtype)

    def _dec_layer(self, lp, x, enc_out, q_chunk):
        """One decoder layer over the whole sequence: (x, k, v, ck, cv)."""
        cfg = self.cfg
        B, T, _ = x.shape
        q, k, v = qkv(lp["attn"], layernorm(x, lp["ln1"], cfg.rms_eps), cfg, None, None)
        ao = attn_lib.full_attention(q, k, v, causal=True, q_chunk=q_chunk)
        x = x + ao.reshape(B, T, -1) @ lp["attn"]["wo"].to(x.dtype)
        ck, cv = self._cross_kv(lp["cross"], enc_out)
        x = x + self._cross(lp["cross"], layernorm(x, lp["ln2"], cfg.rms_eps), ck, cv, q_chunk)
        x = x + apply_mlp(lp["mlp"], layernorm(x, lp["ln3"], cfg.rms_eps), cfg)
        return x, k, v, ck, cv

    def _dec_layer_at(self, l, x, enc_out, q_chunk):
        """Decoder layer ``l``'s parameters taken, then :meth:`_dec_layer`
        (see :func:`~.common.run_layer`)."""
        return self._dec_layer(self.dec.layer(l), x, enc_out, q_chunk)

    def _trunk(self, tokens, enc_embeds, q_chunk, sink=None, remat=False, embed=None):
        """Encoder (zero frames in the compute dtype when ``enc_embeds`` is
        None, as the reference), then the decoder over ``tokens`` from
        position 0: the final hidden states (B, T, d). ``sink(l, k, v, ck,
        cv)`` receives each decoder layer's self and cross K/V. ``embed``:
        the token embedding already gathered, else gathered here."""
        cfg = self.cfg
        B, T = tokens.shape
        dtype = self.compute_dtype
        if enc_embeds is None:
            enc_embeds = torch.zeros((B, cfg.enc_len, cfg.d_model), dtype=dtype, device=self.device)
        enc_out = self.encode(enc_embeds, remat=remat, q_chunk=q_chunk)
        x = embed_tokens(rdist.gather_param(self.embed) if embed is None else embed, tokens, dtype)
        x = x + rdist.gather_param(self.dec_pos)[:T].to(dtype)
        for l in range(cfg.n_layers):
            x, k, v, ck, cv = run_layer(self._dec_layer_at, remat, l, x, enc_out, q_chunk)
            if sink is not None:
                sink(l, k, v, ck, cv)
        return layernorm(x, rdist.gather_param(self.dec_ln_f), cfg.rms_eps)

    # -- public api ------------------------------------------------------------
    def forward(self, tokens, enc_embeds=None, *, remat: bool = False, q_chunk: int = 2048):
        """Logits (B, T, padded vocab) fp32, and a zero aux loss (the
        reference's second output)."""
        embed = rdist.gather_param(self.embed)  # once: the tied head's too
        x = self._trunk(tokens, enc_embeds, q_chunk, remat=remat, embed=embed)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits_from_hidden(x, embed, self.cfg.vocab), aux

    def loss(self, batch: dict, *, remat: bool = True, q_chunk: int = 2048):
        """``batch``: tokens and labels (B, T), optional mask and
        enc_embeds. Returns (loss, metrics) as the reference's ``loss``."""
        logits, _ = self.forward(batch["tokens"], batch.get("enc_embeds"), remat=remat, q_chunk=q_chunk)
        return softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))

    # -- serving -----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        K, hd = cfg.n_kv_heads, cfg.resolved_head_dim

        def zeros(S):
            return torch.zeros((cfg.n_layers, batch, S, K, hd), dtype=CACHE_DTYPE, device=self.device)

        return {"k": zeros(max_len), "v": zeros(max_len), "ck": zeros(cfg.enc_len), "cv": zeros(cfg.enc_len),
                "length": 0}

    def prefill(self, tokens, enc_embeds=None, *, q_chunk: int = 2048, pad_to: int | None = None):
        """Encode the frames (zeros when None), run the prompt, build the
        cache (self K/V padded to ``pad_to`` slots), return last-token
        logits."""
        B, T = tokens.shape
        cache = self.init_cache(B, max(T, pad_to or T))
        cache["length"] = T

        def sink(l, k, v, ck, cv):
            cache["k"][l, :, :T] = k
            cache["v"][l, :, :T] = v
            cache["ck"][l] = ck
            cache["cv"][l] = cv

        x = self._trunk(tokens, enc_embeds, q_chunk, sink)
        logits = logits_from_hidden(x[:, -1:, :], self.embed, self.cfg.vocab)[:, 0]
        return logits, cache

    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) — appends one position at cache['length']. The self
        K/V are written in place (the reference returns new arrays); the
        returned dict holds the same tensors and the new length."""
        cfg = self.cfg
        B = tokens.shape[0]
        pos = int(cache["length"])
        dtype = self.compute_dtype
        x = embed_tokens(self.embed, tokens, dtype) + self.dec_pos[pos:pos + 1].to(dtype)
        for l in range(cfg.n_layers):
            lp = self.dec.layer(l)
            q, k, v = qkv(lp["attn"], layernorm(x, lp["ln1"], cfg.rms_eps), cfg, None, None)
            kc = attn_lib.update_cache(cache["k"][l], k, pos)
            vc = attn_lib.update_cache(cache["v"][l], v, pos)
            ao = attn_lib.decode_attention(q, kc, vc, pos + 1)
            x = x + ao.reshape(B, 1, -1) @ lp["attn"]["wo"].to(x.dtype)
            x = x + self._cross(lp["cross"], layernorm(x, lp["ln2"], cfg.rms_eps), cache["ck"][l], cache["cv"][l])
            x = x + apply_mlp(lp["mlp"], layernorm(x, lp["ln3"], cfg.rms_eps), cfg)
        x = layernorm(x, self.dec_ln_f, cfg.rms_eps)
        logits = logits_from_hidden(x, self.embed, cfg.vocab)[:, 0]
        return logits, {**cache, "length": pos + 1}
