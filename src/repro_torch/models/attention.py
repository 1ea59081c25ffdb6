"""Grouped-query attention: train/prefill (optionally chunked + windowed) and
single-token decode against a KV cache.

On CPU tensors each function is a faithful port of the reference's jnp body,
and autograd differentiates it. On CUDA tensors, :func:`full_attention` runs
the flash kernel through :class:`repro_torch.kernels.ops.Attention` (whose
backward is the same gradient written out in torch ops), and
:func:`decode_attention` runs the paged-decode kernel over an identity-page
view of the contiguous cache (a view, not a copy).

Shapes: q (B, T, H, D); k/v (B, S, K, D) with H = K·G (GQA groups).
"""
from __future__ import annotations

import math

import torch

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
    if q.is_cuda:
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
    if q.is_cuda:
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
    """Cache update + decode attention. Only the single-device path of the
    reference is ported; its split over a ``model`` mesh axis comes with the
    distributed slice. Returns (out (B,1,H,D), k_cache, v_cache)."""
    kc = update_cache(k_cache, k_new, pos)
    vc = update_cache(v_cache, v_new, pos)
    return decode_attention(q, kc, vc, pos + 1), kc, vc
