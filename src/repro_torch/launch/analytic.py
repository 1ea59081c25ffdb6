"""Analytic traffic and FLOPs model per cell, for an idealized chip.

The port's own copy of the reference's ``launch/analytic.py``, with the same
arithmetic. The dry run (:mod:`.dryrun`) takes the roofline's memory term
from :func:`analytic_memory_bytes`: the bytes one rank must move in a step
(weights, optimizer state, gradients, activations, cache), idealized as
fused. It holds no hardware figure; the rates a time is taken at are
:data:`repro_torch.launch.mesh.H100`'s.

``model_flops`` is 6·N·D (train) / 2·N·D (inference) with N = active
params, D = tokens, plus the attention term: the "useful compute" the dry
run sets against the FLOPs it counts.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeCell

BF16 = 2
F32 = 4


def _shards(mesh_shape: dict) -> tuple[int, int, int]:
    data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    model = mesh_shape.get("model", 1)
    total = data * model
    return data, model, total


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Global useful FLOPs for the step (all chips)."""
    N = cfg.active_params_count()
    if cell.kind == "train":
        D = cell.global_batch * cell.seq_len
        base = 6.0 * N * D
        attn_mult = 3.0  # fwd + bwd
    elif cell.kind == "prefill":
        D = cell.global_batch * cell.seq_len
        base = 2.0 * N * D
        attn_mult = 1.0
    else:  # decode: one token per sequence
        D = cell.global_batch
        base = 2.0 * N * D
        attn_mult = 1.0

    # attention FLOPs: 4·H·hd per (q,k) pair per layer (QKᵀ + PV)
    attn = 0.0
    if cfg.n_heads and cfg.family != "ssm":
        hd = cfg.resolved_head_dim
        H = cfg.n_heads
        if cfg.family == "hybrid":
            n_attn = sum(1 for i in range(cfg.n_layers) if cfg._layer_kind(i) == "A")
            win = cfg.window
        else:
            n_attn = cfg.n_layers
            win = None
        if cell.kind == "decode":
            kv = min(cell.seq_len, win) if win else cell.seq_len
            attn = 4.0 * H * hd * kv * cell.global_batch * n_attn
        else:
            S = cell.seq_len
            avg_kv = min(S, win) / 1 if win else S / 2  # causal average
            if win:
                avg_kv = min(S / 2, win)
            attn = 4.0 * H * hd * avg_kv * S * cell.global_batch * n_attn * attn_mult
        if cfg.enc_dec:
            E = cfg.enc_len
            if cell.kind == "decode":
                # decode reuses cached encoder K/V: cross-attn for 1 token only
                attn += 4.0 * H * hd * E * cell.global_batch * cfg.n_layers
            else:
                # encoder self-attn + decoder cross-attn
                attn += (
                    4.0 * H * hd * E * E * cell.global_batch * cfg.enc_layers
                    + 4.0 * H * hd * E * cell.seq_len * cell.global_batch * cfg.n_layers
                ) * attn_mult
    return base + attn


def analytic_memory_bytes(cfg: ModelConfig, cell: ShapeCell, mesh_shape: dict, accum: int = 1) -> float:
    """Idealized per-chip HBM traffic for one step."""
    data, model, total = _shards(mesh_shape)
    N = cfg.params_count()
    d = cfg.d_model
    L = max(cfg.n_layers, 1)
    B = cell.global_batch
    S = cell.seq_len
    b_local = max(B // data, 1)

    if cell.kind == "train":
        # weights: each microstep reads the model-shard of bf16 weights for
        # fwd + remat-fwd + bwd (3×); FSDP gather traffic is collective, but
        # the gathered copy is read from HBM locally.
        w = 3.0 * accum * N * BF16 / model
        # optimizer: read p,m,v + write p,m,v (fp32, fully sharded)
        opt = 6.0 * N * F32 / total
        # gradients: accumulate read+write fp32 per microstep (sharded)
        gacc = 2.0 * accum * N * F32 / total if accum > 1 else 2.0 * N * F32 / total
        # activations: ~30 (b,t,d)-sized reads+writes per layer (fwd+bwd+remat)
        tokens_micro = b_local * S / accum if cell.kind == "train" else b_local * S
        act = 30.0 * L * tokens_micro * d * BF16 * accum
        return w + opt + gacc + act

    if cell.kind == "prefill":
        w = N * BF16 / model
        act = 12.0 * L * b_local * S * d * BF16
        cache = cache_bytes(cfg, cell, mesh_shape)  # write once
        return w + act + cache

    # decode
    w = N * BF16 / model
    cache = cache_bytes(cfg, cell, mesh_shape)  # read once + tiny write
    act = 12.0 * L * b_local * d * BF16
    return w + cache + act


def cache_bytes(cfg: ModelConfig, cell: ShapeCell, mesh_shape: dict) -> float:
    """Per-chip bytes of the decode state/cache."""
    data, model, total = _shards(mesh_shape)
    B, S = cell.global_batch, cell.seq_len
    b_local = max(B // data, 1)
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
        per_seq = nh * cfg.ssm_head_dim * cfg.ssm_state * F32 + conv_dim * (cfg.conv_kernel - 1) * BF16
        return cfg.n_layers * b_local * per_seq
    if cfg.family == "hybrid":
        w = cfg.rnn_width or cfg.d_model
        n_rec = sum(1 for i in range(cfg.n_layers) if cfg._layer_kind(i) == "R")
        n_att = cfg.n_layers - n_rec
        rec = n_rec * b_local * (w * F32 + w * (cfg.conv_kernel - 1) * BF16)
        att = n_att * b_local * min(S, cfg.window) * cfg.n_kv_heads * hd * 2 * BF16 / model
        return rec + att
    kv_len = S
    per = cfg.n_layers * b_local * kv_len * cfg.n_kv_heads * hd * 2 * BF16 / model
    if cfg.enc_dec:
        per += cfg.n_layers * b_local * cfg.enc_len * cfg.n_kv_heads * hd * 2 * BF16
    return per
