"""Public entry points of the kernels.

The device decides: a CUDA tensor goes to the hand-written CUDA kernel, a
CPU tensor to its plain PyTorch version in :mod:`.ref`. There is no flag and
no fallback: a CUDA launch that fails raises.
"""
from __future__ import annotations

from . import ref
from .decode_attention import paged_decode_attention
from .flash_attention import flash_attention
from .rglru_scan import rglru_scan
from .ssd_scan import ssd_chunked_cuda


def attention(q, k, v, *, causal=True, window=None):
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, window=window)
    return ref.mha_reference(q, k, v, causal=causal, window=window)


def paged_decode(q, pages_k, pages_v, page_table, lengths):
    if q.is_cuda:
        return paged_decode_attention(q, pages_k, pages_v, page_table, lengths)
    return ref.paged_decode_reference(q, pages_k, pages_v, page_table, lengths)


def ssd_scan(x, dA, B_, C_, chunk):
    """Chunked SSD → (y in x's dtype, final state fp32). The CPU path is the
    sequential oracle, as the reference's ``use_pallas=False`` path."""
    if x.is_cuda:
        return ssd_chunked_cuda(x, dA, B_, C_, chunk)
    return ref.ssd_chunk_reference(x, dA, B_, C_)


def rglru(x, r, i, lam, h0=None):
    """RG-LRU recurrence → (y in x's dtype, h_last fp32). The CPU path is the
    sequential plain version (the reference's associative scan computes the
    same function in another summation order)."""
    if x.is_cuda:
        return rglru_scan(x, r, i, lam, h0)
    return ref.rglru_reference(x, r, i, lam, h0)
