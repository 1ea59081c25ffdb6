"""Public entry points of the kernels.

The device decides: a CUDA tensor goes to the hand-written CUDA kernel, a
CPU tensor to its plain PyTorch version in :mod:`.ref`, a meta tensor to a
shape-only function that returns the kernel's outputs (empty, of its shapes
and dtypes) and counts the kernel's work (:mod:`.cost`) in the active tally,
as the CUDA route does while one is active. There is no flag and no
fallback: a CUDA launch that fails raises.

The CUDA kernels have no backward. Attention gets one in :class:`Attention`
(the kernel's forward, the gradient in torch ops). The others raise on CUDA
when autograd would record them, rather than return a tensor with no
``grad_fn``; the CPU versions are plain torch ops and differentiate, and the
meta versions may be recorded, as no kernel runs there.
"""
from __future__ import annotations

import torch

from . import cost, ref
from .decode_attention import paged_decode_attention
from .flash_attention import attention_backward, flash_attention
from .rglru_scan import rglru_scan
from .ssd_scan import inter_chunk_scan, ssd_chunked_cuda


def _no_autograd(name: str, remedy: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"the CUDA {name} kernel has no backward: {remedy}")


def _empty(shape, dtype, like) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def attention(q, k, v, *, causal=True, window=None):
    if q.is_meta:
        cost.record("flash_attention", cost.flash_attention(q, k, v, causal=causal, window=window))
        return _empty(q.shape, q.dtype, q)
    if q.is_cuda:
        _no_autograd("flash attention", "train through ops.Attention (models/attention.full_attention)", q, k, v)
        if cost.counting():
            cost.record("flash_attention", cost.flash_attention(q, k, v, causal=causal, window=window))
        return flash_attention(q, k, v, causal=causal, window=window)
    return ref.mha_reference(q, k, v, causal=causal, window=window)


class Attention(torch.autograd.Function):
    """Exact attention with a gradient: the forward is :func:`attention` (the
    flash kernel on the card, the plain version on the CPU, shapes only on
    meta), the backward is :func:`.flash_attention.attention_backward`, which
    recomputes P from the saved q and k, ``q_chunk`` query rows at a time, in
    torch ops on every device. Under ``no_grad`` it is :func:`attention`
    itself."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.q_chunk = causal, window, q_chunk
        return attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, do, causal=ctx.causal, window=ctx.window, q_chunk=ctx.q_chunk)
        return dq, dk, dv, None, None, None


def paged_decode(q, pages_k, pages_v, page_table, lengths):
    if q.is_meta:
        cost.record("paged_decode", cost.paged_decode(q, pages_k, pages_v, page_table, lengths))
        return _empty(q.shape, q.dtype, q)
    if q.is_cuda:
        _no_autograd("paged decode", "decode serves and does not train", q, pages_k, pages_v)
        if cost.counting():
            cost.record("paged_decode", cost.paged_decode(q, pages_k, pages_v, page_table, lengths))
        return paged_decode_attention(q, pages_k, pages_v, page_table, lengths)
    return ref.paged_decode_reference(q, pages_k, pages_v, page_table, lengths)


def ssd_scan(x, dA, B_, C_, chunk):
    """Chunked SSD → (y in x's dtype, final state fp32). The CPU path is the
    sequential oracle, as the reference's ``use_pallas=False`` path. On meta,
    the CUDA path's steps with shapes only: the two kernels' outputs, the
    inter-chunk recurrence in torch ops between them."""
    if x.is_meta:
        b, t, h, p = x.shape
        n, nc = B_.shape[3], -(-t // chunk)
        cost.record("ssd_states", cost.ssd_states(x, dA, B_, C_, chunk))
        y_diag, S = _empty((b, nc, h, chunk, p), torch.float32, x), _empty((b, nc, h, p, n), torch.float32, x)
        H_in, H_last = inter_chunk_scan(S, dA, chunk)
        cost.record("ssd_output", cost.ssd_output(x, dA, C_, chunk))
        y = _empty(x.shape, x.dtype, x)
        del y_diag, S, H_in  # ssd_output has read them
        return y, H_last
    if x.is_cuda:
        _no_autograd("SSD", "its gradient on CUDA is ROADMAP Queue A item 21 (mamba2 trains on the CPU only)",
                     x, dA, B_, C_)
        if cost.counting():
            cost.record("ssd_states", cost.ssd_states(x, dA, B_, C_, chunk))
            cost.record("ssd_output", cost.ssd_output(x, dA, C_, chunk))
        return ssd_chunked_cuda(x, dA, B_, C_, chunk)
    return ref.ssd_chunk_reference(x, dA, B_, C_)


def rglru(x, r, i, lam, h0=None):
    """RG-LRU recurrence → (y in x's dtype, h_last fp32). The CPU path is the
    sequential plain version (the reference's associative scan computes the
    same function in another summation order)."""
    if x.is_meta:
        cost.record("rglru_scan", cost.rglru_scan(x, r, i, lam, h0))
        B, _, W = x.shape
        return _empty(x.shape, x.dtype, x), _empty((B, W), torch.float32, x)
    if x.is_cuda:
        _no_autograd("RG-LRU", "its gradient on CUDA is ROADMAP Queue A item 21 (recurrentgemma trains on the CPU "
                     "only)", x, r, i, lam, h0)
        if cost.counting():
            cost.record("rglru_scan", cost.rglru_scan(x, r, i, lam, h0))
        return rglru_scan(x, r, i, lam, h0)
    return ref.rglru_reference(x, r, i, lam, h0)
