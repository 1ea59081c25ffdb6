"""Decoder-only transformer LM covering the dense, moe and vlm families.

GQA attention (+qk-norm for qwen3, +bias for qwen2-moe, +parallel
attention/FFN residual block for command-r), GLU or GELU FFN or the MoE FFN
(:mod:`.moe`), optional vision-embedding merge, rotary or learned positions.

Parameters keep the reference's layout: a leading ``L`` axis on every
per-layer tensor and the same key paths (``state_dict`` key ``attn.wq`` is
the reference's ``['attn']['wq']``), so :mod:`repro_torch.convert` moves
parameter trees between the packages. The layers run in a Python loop over
per-layer views of the stacked tensors (:func:`.common.layer_view`).

Training: ``model.requires_grad_()`` makes the parameters trainable (they
are created without grad, for serving), and :meth:`TransformerLM.loss`
recomputes each layer in the backward (``remat``), as the reference's
``nothing_saveable`` policy.

§Perf variants (:mod:`repro_torch.dist.perf`), as the reference places them:
V1 saves a layer's two post-product tensors under remat, V2 routes the MoE
FFN per data shard (:func:`.moe.moe_ffn`), V3 decodes over a cache split on
the ``model`` mesh dim (:func:`.attention.sharded_decode_update_attend`), V6
casts the stacked weights before the layer, V9 reduces the row-parallel
products (``wo`` in the full-sequence layer, every MLP's ``w_down``) in bf16
over the ``model`` ranks (:func:`row_parallel_einsum`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch import dist as rdist
from repro_torch.dist import Axes
from repro_torch.dist.perf import perf
from . import attention as attn_lib
from .common import (
    apply_rope,
    checkpoint_name,
    embed_axes,
    embed_tokens,
    gelu_tanh,
    glu_activation,
    init_truncated_normal_,
    layer_view,
    logits_from_hidden,
    norm,
    rmsnorm,
    rope_tables,
    run_layer,
    save_only_these_names,
    softmax_cross_entropy,
)
from .moe import init_moe_, moe_axes, moe_ffn, moe_params

CACHE_DTYPE = torch.bfloat16  # the KV cache is bf16 whatever the compute dtype, as in the reference


def attn_params(cfg, L: int, p) -> nn.ParameterDict:
    """The reference's ``init_attn`` tree for ``L`` stacked layers, each
    leaf made by ``p(*shape)``."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    attn = {"wq": p(L, d, H * hd), "wk": p(L, d, K * hd), "wv": p(L, d, K * hd), "wo": p(L, H * hd, d)}
    if cfg.attention_bias:
        attn.update(bq=p(L, H * hd), bk=p(L, K * hd), bv=p(L, K * hd))
    if cfg.qk_norm:
        attn.update(q_norm=p(L, hd), k_norm=p(L, hd))
    return nn.ParameterDict(attn)


def mlp_params(cfg, L: int, p) -> nn.ParameterDict:
    """The reference's ``init_mlp`` tree for ``L`` stacked layers."""
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.activation == "gelu":
        return nn.ParameterDict({"w_up": p(L, d, ff), "w_down": p(L, ff, d)})
    return nn.ParameterDict({"w_gate": p(L, d, ff), "w_up": p(L, d, ff), "w_down": p(L, ff, d)})


def attn_axes(cfg) -> dict:
    """The reference's logical axes of the attention tree."""
    p = {
        "wq": Axes("layers", "param_embed", "heads"),
        "wk": Axes("layers", "param_embed", "kv"),
        "wv": Axes("layers", "param_embed", "kv"),
        "wo": Axes("layers", "heads", "param_embed"),
    }
    if cfg.attention_bias:
        p["bq"] = Axes("layers", "heads")
        p["bk"] = Axes("layers", "kv")
        p["bv"] = Axes("layers", "kv")
    if cfg.qk_norm:
        p["q_norm"] = Axes("layers", None)
        p["k_norm"] = Axes("layers", None)
    return p


def mlp_axes(cfg) -> dict:
    """The reference's logical axes of the MLP tree."""
    if cfg.activation == "gelu":
        return {"w_up": Axes("layers", "param_embed", "mlp"), "w_down": Axes("layers", "mlp", "param_embed")}
    return {
        "w_gate": Axes("layers", "param_embed", "mlp"),
        "w_up": Axes("layers", "param_embed", "mlp"),
        "w_down": Axes("layers", "mlp", "param_embed"),
    }


@torch.no_grad()
def init_attn_(attn: nn.ParameterDict, cfg, generator: torch.Generator) -> None:
    """The reference's stds: ``d^-½`` for wq/wk/wv, ``(H·hd)^-½`` for wo;
    biases and qk-norm scales stay zero."""
    for name in ("wq", "wk", "wv"):
        init_truncated_normal_(attn[name], cfg.d_model**-0.5, generator)
    init_truncated_normal_(attn["wo"], (cfg.n_heads * cfg.resolved_head_dim) ** -0.5, generator)


@torch.no_grad()
def init_mlp_(mlp: nn.ParameterDict, cfg, generator: torch.Generator) -> None:
    """The reference's stds: ``d^-½`` in, ``d_ff^-½`` out."""
    for name in ("w_gate", "w_up"):
        if name in mlp:
            init_truncated_normal_(mlp[name], cfg.d_model**-0.5, generator)
    init_truncated_normal_(mlp["w_down"], cfg.d_ff**-0.5, generator)


def row_parallel_einsum(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u (B,T,F) @ w (F,D). §Perf V9, on CUDA tensors under a mesh with a
    ``model`` dim that divides F: each ``model`` rank multiplies its slice
    of F, and the partial products, rounded to u's dtype, are summed by a
    reduce-scatter and an all-gather over the ``model`` ranks (the ring
    all-reduce's two halves) in that dtype (:class:`RowParallel`, which has
    a backward). CPU tensors take the plain product, as the reference's CPU
    backend does. ``row_parallel_einsum.mesh_calls`` counts the calls that
    take the collective path (a remat recompute's too),
    ``row_parallel_einsum.backward_calls`` their backwards."""
    mesh = rdist.active_mesh()
    n = rdist.mesh_shape(mesh).get("model") if mesh is not None else None
    F = u.shape[-1]
    if not perf().bf16_rowparallel or n is None or F % n or not u.is_cuda:
        return u @ w
    row_parallel_einsum.mesh_calls += 1
    return RowParallel.apply(u, w, mesh)


class RowParallel(torch.autograd.Function):
    """V9's product on ``mesh``'s ``model`` ranks, each holding u and w
    whole (every ``model`` rank computes the same values, the port's rule
    for plain tensors): forward, rank m's slice f of F, ``u[..., f] @ w[f]``
    in u's dtype, summed over the ranks by a reduce-scatter and an
    all-gather. Backward: the all-gather's gradient is this rank's slice of
    dY and the reduce-scatter's the all-gather of those slices, which is dY
    itself, the same on every ``model`` rank; so dU[..., f] = dY·w[f]ᵀ and
    dW[f] = u[..., f]ᵀ·dY, each the rank's slice, gathered back over the
    ``model`` ranks to the whole (the value every rank holds)."""

    @staticmethod
    def forward(ctx, u, w, mesh):
        import torch.distributed as dist

        n = rdist.mesh_shape(mesh)["model"]
        f = rdist.shard_slice(mesh, "model", u.shape[-1])
        ctx.save_for_backward(u, w)
        ctx.mesh, ctx.f = mesh, f
        y = (u[..., f] @ w[f]).to(u.dtype)
        B, T, D = y.shape
        if D % n:
            raise ValueError(f"row_parallel_einsum: output dim {D} does not split over {n} model ranks")
        group = mesh.get_group("model")
        chunks = y.reshape(B * T, n, D // n).transpose(0, 1).contiguous()  # (n, B·T, D/n)
        flat = chunks.view(n * B * T, D // n)  # rank i's chunk in rows i·B·T.. (gloo reads dim 0)
        part = torch.empty_like(chunks[0])
        dist.reduce_scatter_tensor(part, flat, group=group)
        dist.all_gather_into_tensor(flat, part, group=group)
        return chunks.transpose(0, 1).reshape(B, T, D)

    @staticmethod
    def backward(ctx, dy):
        row_parallel_einsum.backward_calls += 1
        u, w = ctx.saved_tensors
        mesh, f = ctx.mesh, ctx.f
        du = rdist.all_gather_axes(dy @ w[f].t().to(dy.dtype), mesh, "model", u.ndim - 1)
        uf = u[..., f].reshape(-1, f.stop - f.start)
        dw = rdist.all_gather_axes(uf.t() @ dy.reshape(-1, dy.shape[-1]).to(uf.dtype), mesh, "model", 0)
        return du.to(u.dtype), dw.to(w.dtype), None


row_parallel_einsum.mesh_calls = 0
row_parallel_einsum.backward_calls = 0


def apply_mlp(lp: dict, h: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.activation == "gelu":
        return row_parallel_einsum(gelu_tanh(h @ lp["w_up"].to(h.dtype)), lp["w_down"].to(h.dtype))
    g = h @ lp["w_gate"].to(h.dtype)
    u = h @ lp["w_up"].to(h.dtype)
    return row_parallel_einsum(glu_activation(g, u, cfg.activation), lp["w_down"].to(h.dtype))


def qkv(lp: dict, h: torch.Tensor, cfg, sin, cos):
    """h (B,T,d) → q (B,T,H,hd), k/v (B,T,K,hd) with rope applied."""
    B, T, _ = h.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = h @ lp["wq"].to(h.dtype)
    k = h @ lp["wk"].to(h.dtype)
    v = h @ lp["wv"].to(h.dtype)
    if cfg.attention_bias:
        q = q + lp["bq"].to(h.dtype)
        k = k + lp["bk"].to(h.dtype)
        v = v + lp["bv"].to(h.dtype)
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, K, hd)
    v = v.reshape(B, T, K, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, lp["q_norm"], cfg.rms_eps)
        k = rmsnorm(k, lp["k_norm"], cfg.rms_eps)
    if cfg.use_rope:
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


class TransformerLM(nn.Module):
    """Parameters are created zero-filled on ``device`` in ``param_dtype``;
    :meth:`init` draws them, or ``load_state_dict`` loads a converted tree.
    Computation runs in ``cfg.dtype``. Parameters do not require grad until
    ``requires_grad_()`` is called on the module."""

    def __init__(self, cfg, device=None, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(f"family {cfg.family!r}: TransformerLM runs the dense, moe and vlm families")
        self.cfg = cfg
        dev = resolve_device(device)
        d, L, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=param_dtype, device=dev), requires_grad=False)

        self.embed = p(V, d)
        self.ln1 = p(L, d)
        self.ln_f = p(d)
        self.attn = attn_params(cfg, L, p)
        if not cfg.parallel_block:
            self.ln2 = p(L, d)
        if cfg.family == "moe":
            self.moe = moe_params(cfg, L, p)
        else:
            self.mlp = mlp_params(cfg, L, p)
        if not cfg.tie_embeddings:
            self.out_embed = p(V, d)
        if cfg.pos_emb == "learned":
            self.pos_embed = p(8192, d)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # -- init ----------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TransformerLM":
        """Draw the parameters with the reference's shapes and stds:
        ``std · truncated_normal(-2, 2)``, norms and biases zero, vocab
        padding rows zero. ``generator`` lives on the parameters' device."""
        cfg = self.cfg
        d = cfg.d_model
        init_truncated_normal_(self.embed, d**-0.5, generator)
        self.embed[cfg.vocab:] = 0
        init_attn_(self.attn, cfg, generator)
        if cfg.family == "moe":
            init_moe_(self.moe, cfg, generator)
        else:
            init_mlp_(self.mlp, cfg, generator)
        if not cfg.tie_embeddings:
            init_truncated_normal_(self.out_embed, d**-0.5, generator)
            self.out_embed[cfg.vocab:] = 0
        if cfg.pos_emb == "learned":
            init_truncated_normal_(self.pos_embed, 0.02, generator)
        return self

    def param_axes(self) -> dict:
        """The logical axes of the parameter tree, key for key the reference's."""
        cfg = self.cfg
        p: dict = {"embed": embed_axes(), "ln1": Axes("layers", "param_embed"), "ln_f": Axes("param_embed"),
                   "attn": attn_axes(cfg)}
        if not cfg.parallel_block:
            p["ln2"] = Axes("layers", "param_embed")
        if cfg.family == "moe":
            p["moe"] = moe_axes(cfg)
        else:
            p["mlp"] = mlp_axes(cfg)
        if not cfg.tie_embeddings:
            p["out_embed"] = embed_axes()
        if cfg.pos_emb == "learned":
            p["pos_embed"] = Axes("param_seq", "param_embed")
        return p

    def cache_axes(self) -> dict:
        return {
            "k": Axes("layers", "cache_batch", "kv_seq", "act_kv", None),
            "v": Axes("layers", "cache_batch", "kv_seq", "act_kv", None),
            "length": Axes(),
        }

    def _layer(self, l: int) -> dict:
        """Layer ``l``'s parameters (views of the stacked tensors); under
        §Perf V6 the slices of the ≥ 3-D stacked weights cast to the compute
        dtype here, as the reference casts them before its scan."""
        dtype = self.compute_dtype if perf().cast_weights_early else None

        def view(t):
            v = layer_view(t, l)
            return v.to(dtype) if dtype is not None and t.ndim >= 3 else v

        ffn = "moe" if self.cfg.family == "moe" else "mlp"
        lp = {"ln1": view(self.ln1), "attn": {k: view(v) for k, v in self.attn.items()},
              ffn: {k: view(v) for k, v in getattr(self, ffn).items()}}
        if not self.cfg.parallel_block:
            lp["ln2"] = view(self.ln2)
        return lp

    def _out_embed(self, embed=None) -> torch.Tensor:
        """The output projection: when tied, the input embedding, or
        ``embed``, that already gathered."""
        if not self.cfg.tie_embeddings:
            return rdist.gather_param(self.out_embed)
        return rdist.gather_param(self.embed) if embed is None else embed

    def _ffn(self, lp, h):
        """The FFN: (output, the layer's aux loss, None but in the MoE FFN)."""
        if "moe" in lp:
            return moe_ffn(lp["moe"], h, self.cfg)
        return apply_mlp(lp["mlp"], h, self.cfg), None

    def _block_tail(self, lp, x, h, ao, named: bool = False):
        """Residual adds and the FFN, after attention's output projection:
        (x, the layer's aux loss or None). ``named``: mark the FFN's output
        for §Perf V1, outside the parallel block as the reference."""
        cfg = self.cfg
        if cfg.parallel_block:
            mo, aux = self._ffn(lp, h)
            return x + ao + mo, aux
        x = x + ao
        mo, aux = self._ffn(lp, norm(x, lp["ln2"], cfg.rms_eps, cfg.norm_type))
        return x + (checkpoint_name(mo, "mlp_out") if named else mo), aux

    def _layer_block(self, l, x, sin, cos, q_chunk):
        """Layer ``l``'s parameters taken, then :meth:`_block` (see
        :func:`~.common.run_layer`)."""
        return self._block(self._layer(l), x, sin, cos, q_chunk)

    def _block(self, lp, x, sin, cos, q_chunk):
        """One layer over the whole sequence: (x, aux, k, v)."""
        B, T, _ = x.shape
        named = perf().save_dot_outputs
        h = norm(x, lp["ln1"], self.cfg.rms_eps, self.cfg.norm_type)
        q, k, v = qkv(lp["attn"], h, self.cfg, sin, cos)
        ao = attn_lib.full_attention(q, k, v, causal=True, q_chunk=q_chunk)
        ao = row_parallel_einsum(ao.reshape(B, T, -1), lp["attn"]["wo"].to(x.dtype))
        if named:
            ao = checkpoint_name(ao, "attn_out")
        return *self._block_tail(lp, x, h, ao, named), k, v

    # -- forward (prefill) -----------------------------------------------------
    def _trunk(self, tokens, vision_embeds, q_chunk, kv_sink=None, remat=False, embed=None):
        """``embed``: the input embedding already gathered, else gathered here."""
        cfg = self.cfg
        dtype = self.compute_dtype
        T = tokens.shape[1]
        x = embed_tokens(rdist.gather_param(self.embed) if embed is None else embed, tokens, dtype)
        if vision_embeds is not None:
            x[:, : vision_embeds.shape[1]] = vision_embeds.to(dtype)
        if cfg.pos_emb == "learned":
            x = x + rdist.gather_param(self.pos_embed)[:T].to(dtype)
        sin, cos = rope_tables(torch.arange(T, device=tokens.device), cfg.resolved_head_dim, cfg.rope_theta)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # under remat nothing is saved inside a layer (V1: but attn_out and mlp_out)
        kw = {"context_fn": lambda: save_only_these_names("attn_out", "mlp_out")} \
            if remat and perf().save_dot_outputs else {}
        for l in range(cfg.n_layers):
            x, aux_l, k, v = run_layer(self._layer_block, remat, l, x, sin, cos, q_chunk, **kw)
            if aux_l is not None:
                aux = aux + aux_l
            if kv_sink is not None:
                kv_sink(l, k, v)
        return norm(x, rdist.gather_param(self.ln_f), cfg.rms_eps, cfg.norm_type), aux

    def hidden_states(self, tokens, vision_embeds=None, *, remat: bool = False, collect_kv: bool = False,
                      q_chunk: int = 2048):
        """Returns (hidden (B,T,d), aux_loss, stacked (k, v) (L,B,T,K,hd) or None)."""
        kvs = []
        x, aux = self._trunk(tokens, vision_embeds, q_chunk,
                             (lambda l, k, v: kvs.append((k, v))) if collect_kv else None, remat)
        stacked = (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])) if collect_kv else None
        return x, aux, stacked

    def forward(self, tokens, vision_embeds=None, *, remat: bool = False, q_chunk: int = 2048):
        embed = rdist.gather_param(self.embed)  # once: the tied head's too
        x, aux = self._trunk(tokens, vision_embeds, q_chunk, remat=remat, embed=embed)
        return logits_from_hidden(x, self._out_embed(embed), self.cfg.vocab), aux

    def loss(self, batch: dict, *, remat: bool = True, q_chunk: int = 2048):
        """``batch``: tokens and labels (B,T), optional mask and vision_embeds.
        Returns (loss, metrics) as the reference's ``loss``: the MoE family
        adds ``router_aux_coef · aux`` and reports ``aux_loss``."""
        logits, aux = self.forward(batch["tokens"], batch.get("vision_embeds"), remat=remat, q_chunk=q_chunk)
        loss, metrics = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
        if self.cfg.family == "moe":
            loss = loss + self.cfg.router_aux_coef * aux
            metrics["aux_loss"] = aux
        metrics["loss"] = loss
        return loss, metrics

    # -- serving ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {
            "k": torch.zeros(shape, dtype=CACHE_DTYPE, device=self.device),
            "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=self.device),
            "length": 0,
        }

    def prefill(self, tokens, vision_embeds=None, *, q_chunk: int = 2048, pad_to: int | None = None):
        """Run the full prompt, build the KV cache (padded to ``pad_to`` slots
        for later decode steps), return last-token logits."""
        B, T = tokens.shape
        cache = self.init_cache(B, max(T, pad_to or T))
        cache["length"] = T

        def sink(l, k, v):
            cache["k"][l, :, :T] = k
            cache["v"][l, :, :T] = v

        x, _ = self._trunk(tokens, vision_embeds, q_chunk, sink)
        logits = logits_from_hidden(x[:, -1:, :], self._out_embed(), self.cfg.vocab)[:, 0]
        return logits, cache

    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B,1) — appends one position at cache['length']. The cache
        tensors are updated in place (the reference returns new arrays); the
        returned dict holds the same tensors and the new length. Under §Perf
        V3 the cache may be placed on the mesh (``repro_torch.dist.
        distribute_tree`` with :meth:`cache_axes`), each rank holding its
        shard."""
        cfg = self.cfg
        B = tokens.shape[0]
        pos = int(cache["length"])
        sharded = perf().sharded_decode_attn
        if not sharded and rdist.is_dtensor(cache["k"]):
            raise ValueError("a cache placed on a mesh is decoded by the sharded path (PerfConfig.sharded_decode_attn)")
        x = embed_tokens(self.embed, tokens, self.compute_dtype)
        if cfg.pos_emb == "learned":
            x = x + self.pos_embed[pos:pos + 1].to(x.dtype)
        sin, cos = rope_tables(torch.tensor([pos], device=tokens.device), cfg.resolved_head_dim, cfg.rope_theta)
        for l in range(cfg.n_layers):
            lp = self._layer(l)
            h = norm(x, lp["ln1"], cfg.rms_eps, cfg.norm_type)
            q, k, v = qkv(lp["attn"], h, cfg, sin, cos)
            if sharded:
                ao, _, _ = attn_lib.sharded_decode_update_attend(q, rdist.select(cache["k"], l),
                                                                 rdist.select(cache["v"], l), k, v, pos)
            else:
                kc = attn_lib.update_cache(cache["k"][l], k, pos)
                vc = attn_lib.update_cache(cache["v"][l], v, pos)
                ao = attn_lib.decode_attention(q, kc, vc, pos + 1)
            ao = ao.reshape(B, 1, -1) @ lp["attn"]["wo"].to(x.dtype)
            x, _ = self._block_tail(lp, x, h, ao)
        x = norm(x, self.ln_f, cfg.rms_eps, cfg.norm_type)
        logits = logits_from_hidden(x, self._out_embed(), cfg.vocab)[:, 0]
        return logits, {"k": cache["k"], "v": cache["v"], "length": pos + 1}
