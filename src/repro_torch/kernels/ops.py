"""Public entry points of the kernels.

The device decides: a CUDA tensor goes to the hand-written CUDA kernel, a
CPU tensor to its plain PyTorch version in :mod:`.ref`. There is no flag and
no fallback: a CUDA launch that fails raises.

The CUDA kernels have no backward. Attention gets one in :class:`Attention`
(the kernel's forward, the gradient in torch ops). The others raise on CUDA
when autograd would record them, rather than return a tensor with no
``grad_fn``; the CPU versions are plain torch ops and differentiate.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import paged_decode_attention
from .flash_attention import attention_backward, flash_attention
from .rglru_scan import rglru_scan
from .ssd_scan import ssd_chunked_cuda


def _no_autograd(name: str, remedy: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"the CUDA {name} kernel has no backward: {remedy}")


def attention(q, k, v, *, causal=True, window=None):
    if q.is_cuda:
        _no_autograd("flash attention", "train through ops.Attention (models/attention.full_attention)", q, k, v)
        return flash_attention(q, k, v, causal=causal, window=window)
    return ref.mha_reference(q, k, v, causal=causal, window=window)


class Attention(torch.autograd.Function):
    """Exact attention with a gradient: the forward is :func:`attention` (the
    flash kernel on the card, the plain version on the CPU), the backward is
    :func:`.flash_attention.attention_backward`, which recomputes P from the
    saved q and k, ``q_chunk`` query rows at a time. Under ``no_grad`` it is
    :func:`attention` itself."""

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
    if q.is_cuda:
        _no_autograd("paged decode", "decode serves and does not train", q, pages_k, pages_v)
        return paged_decode_attention(q, pages_k, pages_v, page_table, lengths)
    return ref.paged_decode_reference(q, pages_k, pages_v, page_table, lengths)


def ssd_scan(x, dA, B_, C_, chunk):
    """Chunked SSD → (y in x's dtype, final state fp32). The CPU path is the
    sequential oracle, as the reference's ``use_pallas=False`` path."""
    if x.is_cuda:
        _no_autograd("SSD", "its gradient on CUDA is ROADMAP Queue A item 21 (mamba2 trains on the CPU only)",
                     x, dA, B_, C_)
        return ssd_chunked_cuda(x, dA, B_, C_, chunk)
    return ref.ssd_chunk_reference(x, dA, B_, C_)


def rglru(x, r, i, lam, h0=None):
    """RG-LRU recurrence → (y in x's dtype, h_last fp32). The CPU path is the
    sequential plain version (the reference's associative scan computes the
    same function in another summation order)."""
    if x.is_cuda:
        _no_autograd("RG-LRU", "its gradient on CUDA is ROADMAP Queue A item 21 (recurrentgemma trains on the CPU "
                     "only)", x, r, i, lam, h0)
        return rglru_scan(x, r, i, lam, h0)
    return ref.rglru_reference(x, r, i, lam, h0)
