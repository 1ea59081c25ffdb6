"""Grouped-query attention: train/prefill (optionally chunked + windowed) and
single-token decode against a KV cache.

On CPU tensors each function is a faithful port of the reference's jnp body,
and autograd differentiates it. On CUDA tensors (and on meta tensors, which
follow the card's path: :func:`repro_torch.device.kernel_path`),
:func:`full_attention` runs the flash kernel through
:class:`repro_torch.kernels.ops.Attention` (whose backward is the same
gradient written out in torch ops), and :func:`decode_attention` runs the
paged-decode kernel over an identity-page view of the contiguous cache (a
view, not a copy).

Two §Perf variants (:mod:`repro_torch.dist.perf`) live here: V4, growing
causal key slices per query chunk in the CPU body (the flash kernel skips
masked tiles already), and V3/V5, :func:`sharded_decode_update_attend`, a
flash-decode over a cache whose sequence dim is split over the ``model``
mesh dim, combined across its ranks with ``torch.distributed``.

Shapes: q (B, T, H, D); k/v (B, S, K, D) with H = K·G (GQA groups).
"""
from __future__ import annotations

import math

import torch

from repro_torch import dist as rdist
from repro_torch.device import kernel_path
from repro_torch.dist.perf import perf
from repro_torch.kernels import ops

NEG_INF = -1e30


def _gqa_scores(q, k):
    """q (B,T,K,G,D), k (B,S,K,D) → (B,K,G,T,S) fp32."""
    return torch.einsum("btkgd,bskd->bkgts", q.float(), k.float())


def _gqa_out(p, v):
    """p (B,K,G,T,S) (same dtype as v), v (B,S,K,D) → (B,T,K,G,D)."""
    return torch.einsum("bkgts,bskd->btkgd", p, v)


def _mask(q_pos, k_pos, causal: bool, window: int | None):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def full_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                   q_chunk: int = 2048) -> torch.Tensor:
    """Exact attention. q (B,T,H,D) → (B,T,H,D). On the CPU it is chunked over
    query blocks so peak memory is O(T·q_chunk); the CUDA kernel keeps only
    one tile of scores on chip, whatever T, and its backward recomputes the
    scores ``q_chunk`` query rows at a time."""
    if kernel_path(q):
        return ops.Attention.apply(q, k, v, causal, window, q_chunk)
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, T, K, G, D) * scale
    k_pos = torch.arange(S, device=q.device)

    def block(qc, q0):
        s = _gqa_scores(qc, k)
        q_pos = q0 + torch.arange(qc.shape[1], device=q.device)
        m = _mask(q_pos, k_pos, causal, window)
        s = torch.where(m, s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return _gqa_out(p, v)

    if T <= q_chunk:
        out = block(qg, 0)
    elif causal and perf().causal_chunk_growth:
        # §Perf V4: query chunk i only attends keys [lo, (i+1)·c), lo rounded
        # down to 128: growing slices halve the FLOPs of full-width chunks
        if T % q_chunk:
            raise ValueError(f"T={T} is not a multiple of q_chunk={q_chunk}")
        outs = []
        for i in range(T // q_chunk):
            hi = (i + 1) * q_chunk
            lo = max(0, i * q_chunk - window + 1) if window is not None else 0
            lo = (lo // 128) * 128
            s = _gqa_scores(qg[:, i * q_chunk:hi], k[:, lo:hi])
            m = _mask(i * q_chunk + torch.arange(q_chunk, device=q.device),
                      lo + torch.arange(hi - lo, device=q.device), causal, window)
            p = torch.softmax(torch.where(m, s, NEG_INF), dim=-1).to(v.dtype)
            outs.append(_gqa_out(p, v[:, lo:hi]))
        out = torch.cat(outs, dim=1)
    else:
        if T % q_chunk:
            raise ValueError(f"T={T} is not a multiple of q_chunk={q_chunk}")
        out = torch.cat([block(qg[:, i:i + q_chunk], i) for i in range(0, T, q_chunk)], dim=1)
    return out.reshape(B, T, H, D)


def identity_page_size(S: int) -> int:
    """Page size of the identity-page view of a length-``S`` cache: 64, or the
    largest power of two ≥ 16 that divides ``S``; where none does (whisper's
    1500-slot cross cache), one page of all ``S`` slots per sequence. The
    kernel finds a position's page as ``pos / page`` for any page size, and
    the view is the cache itself whichever is chosen."""
    if S <= 0:
        raise ValueError(f"cache length {S} is not positive")
    page = min(64, S & -S)  # S & -S: the largest power of two dividing S
    return page if page >= 16 else S


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int | None = None) -> torch.Tensor:
    """One-step decode. q (B,1,H,D); caches (B,S,K,D); cache_len int, 0-d or
    (B,) tensor = number of valid cache entries (the new token's K/V already
    written). With ``window`` the cache is a ring buffer of size S=window and
    all slots are valid once wrapped (the caller passes min(length, S))."""
    B, _, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    if kernel_path(q):
        # identity page table over the contiguous cache: page b·(S/page) + p
        # is sequence b's p-th page of the (B·S/page, page, K, D) view
        page = identity_page_size(S)
        n = S // page
        pk = k_cache.view(B * n, page, K, D)
        pv = v_cache.view(B * n, page, K, D)
        table = torch.arange(B * n, dtype=torch.int32, device=q.device).view(B, n)
        if isinstance(cache_len, torch.Tensor):
            lengths = cache_len.to(device=q.device, dtype=torch.int32).expand(B).contiguous()
        else:
            lengths = torch.full((B,), int(cache_len), dtype=torch.int32, device=q.device)
        return ops.paged_decode(q[:, 0], pk, pv, table, lengths).reshape(B, 1, H, D)
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, 1, K, G, D) * scale
    s = _gqa_scores(qg, k_cache)  # (B,K,G,1,S)
    pos = torch.arange(S, device=q.device)
    if not isinstance(cache_len, torch.Tensor) or cache_len.ndim == 0:
        valid = (pos < cache_len)[None, None, None, None, :]
    else:
        valid = (pos[None, :] < cache_len[:, None])[:, None, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)  # fp32, as the reference
    out = torch.einsum("bkgts,bskd->btkgd", p, v_cache.float()).to(q.dtype)
    return out.reshape(B, 1, H, D)


def update_cache(cache, new, index, ring: bool = False):
    """cache (B,S,K,D) ← new (B,1,K,D) at position index (ring: index % S).

    Writes in place and returns ``cache`` (the reference returns an updated
    copy). An index past the end is clamped to the last slot, as the
    reference's ``dynamic_update_slice`` does."""
    S = cache.shape[1]
    idx = int(index)
    idx = idx % S if ring else min(max(idx, 0), S - 1)
    cache[:, idx] = new[:, 0].to(cache.dtype)
    return cache


def sharded_decode_update_attend(q, k_cache, v_cache, k_new, v_new, pos):
    """Cache update + decode attention, with the cache's sequence dim split
    over the ``model`` mesh dim (§Perf V3/V5): each rank writes the new K/V
    if it owns position ``pos`` and computes fp32 partial online-softmax
    statistics (m, l, acc) over its local keys; the ranks combine them with
    an all-reduce MAX of m and an all-reduce SUM of the rescaled l and acc,
    (B,H) and (B,H,hd) values, not the cache.

    q (B,1,H,D), k_new/v_new (B,1,K,D): every rank's global values.
    k_cache/v_cache (B,S,K,D): plain tensors, or DTensors placed by the
    model's ``cache_axes`` (each rank holds its shard). Without a mesh, on a
    ``model`` dim of 1, or where it does not divide S, the dense path, as
    the reference: over a placed cache, on this rank's shard of the batch
    and of the KV heads (``act_kv`` takes ``model`` when ``kv_seq`` cannot),
    the output gathered back. Where ``model`` splits S the cache must be
    placed with S on it. Returns (out (B,1,H,D), k_cache, v_cache), the
    caches updated in place. Forward only, as decode does not train in
    either package: on a placed cache it raises under autograd.
    ``sharded_decode_update_attend.mesh_calls`` counts the calls on a
    placed cache.
    """
    mesh = rdist.active_mesh()
    B, S, K, D = k_cache.shape
    H = q.shape[2]
    n = rdist.mesh_shape(mesh).get("model", 1) if mesh is not None else 1
    split = n > 1 and S % n == 0
    if not rdist.is_dtensor(k_cache):
        if split:
            raise ValueError("a cache split over the model ranks must be placed on the mesh (distribute_tree "
                             "with the model's cache_axes)")
        kc = update_cache(k_cache, k_new, pos)
        vc = update_cache(v_cache, v_new, pos)
        return decode_attention(q, kc, vc, pos + 1), kc, vc

    import torch.distributed as dist

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_new, v_new)):
        raise RuntimeError("sharded_decode_update_attend: decode does not train, and this path has no backward; "
                           "run it under torch.no_grad()")
    sharded_decode_update_attend.mesh_calls += 1
    cm = k_cache.device_mesh
    bs, ss, ks, ds = rdist.placement_spec(k_cache)
    kc, vc = k_cache.to_local(), v_cache.to_local()
    if (tuple(v_cache.placements) != tuple(k_cache.placements) or ds
            or (ss != ("model",) if split else kc.shape[1] != S)):
        raise ValueError(f"cache placed {k_cache.placements}: S {S} over {n} model ranks")
    G = H // K
    b, kh = rdist.shard_slice(cm, bs, B), rdist.shard_slice(cm, ks, K)
    q, k_new, v_new = q[b, :, kh.start * G:kh.stop * G], k_new[b, :, kh], v_new[b, :, kh]
    if not split:  # the dense path on this rank's shard
        update_cache(kc, k_new, pos)
        update_cache(vc, v_new, pos)
        out = decode_attention(q, kc, vc, pos + 1)
    else:
        S_l = S // n
        s0 = cm.get_local_rank("model") * S_l
        if s0 <= pos < s0 + S_l:  # this rank owns the slot
            update_cache(kc, k_new, pos - s0)
            update_cache(vc, v_new, pos - s0)
        # partial flash statistics over the local keys, fp32
        K_l = kc.shape[2]
        qg = q.reshape(-1, 1, K_l, G, D) * (1.0 / math.sqrt(D))
        s = _gqa_scores(qg, kc)  # (B_l,K_l,G,1,S_l)
        valid = (s0 + torch.arange(S_l, device=q.device)) < pos + 1
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(dim=-1)  # (B_l,K_l,G,1)
        p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
        l = p.sum(dim=-1)
        acc = torch.einsum("bkgts,bskd->btkgd", p, vc.float())  # (B_l,1,K_l,G,D)
        # the combine across the model ranks
        m_g = rdist.all_reduce_axes(m.clone(), cm, "model", dist.ReduceOp.MAX)
        corr = torch.exp(m - m_g)
        l_g = rdist.all_reduce_axes(l * corr, cm, "model", dist.ReduceOp.SUM)
        acc_g = rdist.all_reduce_axes(acc * corr.permute(0, 3, 1, 2)[..., None], cm, "model", dist.ReduceOp.SUM)
        l_g = torch.where(l_g == 0.0, 1.0, l_g)
        out = (acc_g / l_g.permute(0, 3, 1, 2)[..., None]).reshape(-1, 1, K_l * G, D).to(q.dtype)
    out = rdist.all_gather_axes(out, cm, ks, 2)
    return rdist.all_gather_axes(out, cm, bs, 0), k_cache, v_cache


sharded_decode_update_attend.mesh_calls = 0
