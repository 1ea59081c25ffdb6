"""Plain PyTorch versions of the attention kernels: the ground truth the CUDA
kernels are held against, and what :mod:`.ops` runs on CPU tensors."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def mha_reference(q, k, v, *, causal=True, window=None):
    """q (B,T,H,hd); k/v (B,S,K,hd) — exact softmax attention in fp32."""
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, T, K, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float())
    q_pos = torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return o.reshape(B, T, H, hd).to(q.dtype)


def paged_decode_reference(q, pages_k, pages_v, page_table, lengths):
    """q (B,H,hd); pages_* (P, page, K, hd); page_table (B, maxp) int32;
    lengths (B,) int32 — exact paged decode attention.

    A row with ``length == 0`` gives zeros, as the TPU kernel does
    (``repro.kernels.ref`` gives the mean of V there instead)."""
    B, H, hd = q.shape
    P, page, K, _ = pages_k.shape
    maxp = page_table.shape[1]
    G = H // K
    idx = page_table.long()
    kg = pages_k[idx].reshape(B, maxp * page, K, hd)
    vg = pages_v[idx].reshape(B, maxp * page, K, hd)
    qg = q.reshape(B, K, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kg.float())
    valid = torch.arange(maxp * page, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.where(valid[:, None, None], torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p, vg.float())
    return o.reshape(B, H, hd).to(q.dtype)
