"""Public entry points of the kernels.

The device decides: a CUDA tensor goes to the hand-written CUDA kernel, a
CPU tensor to its plain PyTorch version in :mod:`.ref`, a meta tensor to a
shape-only function that returns the kernel's outputs (empty, of its shapes
and dtypes) and counts the kernel's work (:mod:`.cost`) in the active tally,
as the CUDA route does while one is active. There is no flag and no
fallback: a CUDA launch that fails raises.

A CUDA kernel has no backward of its own. Attention, the SSD scan and the
RG-LRU get one in :class:`Attention`, :class:`SSDScan` and :class:`RGLRU`:
the kernel's forward, the gradient in torch ops (:func:`attention_backward`,
:func:`ssd_backward`, :func:`rglru_backward`). The MoE's two row gathers are
each other's backward: :class:`MoEDispatch` and :class:`MoECombine` run
:func:`gather_rows` one way and :func:`gather_sum_rows` the other, through
the inverse routing maps, on every device. The bare entry points raise on
CUDA when autograd would record them, rather than return a tensor with no
``grad_fn``, and paged decode has no Function (decode serves and does not
train); the CPU versions are plain torch ops and differentiate, and the meta
versions may be recorded, as no kernel runs there.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from . import cost, moe_gather, ref
from .decode_attention import paged_decode_attention
from .flash_attention import attention_backward, flash_attention
from .rglru_scan import rglru_scan
from .ssd_scan import inter_chunk_scan, ssd_chunked_cuda

RGLRU_BACKWARD_CHUNK = 64  # rglru_backward's chunk: 2·64 + ⌈T/64⌉ Python steps over T


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
    @trace.spanned("attention.backward")
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
        _no_autograd("SSD", "train through ops.SSDScan (models/mamba2.ssd_chunked)", x, dA, B_, C_)
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
        _no_autograd("RG-LRU", "train through ops.RGLRU (models/rglru.rglru_scan)", x, r, i, lam, h0)
        if cost.counting():
            cost.record("rglru_scan", cost.rglru_scan(x, r, i, lam, h0))
        return rglru_scan(x, r, i, lam, h0)
    return ref.rglru_reference(x, r, i, lam, h0)


def _grad_leaves(ctx, tensors):
    """Detached copies of the saved inputs; those whose gradient the
    backward must give require one."""
    return [None if t is None else t.detach().requires_grad_(need)
            for t, need in zip(tensors, ctx.needs_input_grad)]


def _input_grads(leaves, outs, cotangents) -> tuple:
    """∂(Σ out·cotangent)/∂leaf for each leaf that requires a gradient, None
    for the others, zeros where no kept output depends on it (the final SSD
    state on C); an absent cotangent (None) drops its output. Autograd
    calls a backward only when some output has a cotangent and some input
    needs a gradient."""
    pairs = [(o, g.float()) for o, g in zip(outs, cotangents) if g is not None]
    want = [t for t in leaves if t is not None and t.requires_grad]
    grads = iter(torch.autograd.grad([o for o, _ in pairs], want, [g for _, g in pairs], allow_unused=True,
                                     materialize_grads=True))
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in leaves)


def ssd_backward(x, dA, B_, C_, chunk, dy, dH):
    """The gradient of :func:`ssd_scan` into (x, dA, B_, C_), each in its
    input's dtype (None where an input needs none), given the cotangents of
    y and of the final state (either may be None). It recomputes the
    kernels' own decomposition in fp32, as the kernels keep their
    intermediates: ``ref.ssd_states_reference``, :func:`inter_chunk_scan`,
    ``ref.ssd_output_reference``, then differentiates it (g = 1, as the
    kernels)."""
    with torch.enable_grad():
        xf, dAf, Bf, Cf = (t.float() for t in (x, dA, B_, C_))
        y_diag, S = ref.ssd_states_reference(xf, dAf, Bf, Cf, chunk)
        H_in, H_last = inter_chunk_scan(S, dAf, chunk)
        y = ref.ssd_output_reference(y_diag, dAf, Cf, H_in, torch.float32)
        return _input_grads((x, dA, B_, C_), (y, H_last), (dy, dH))


def rglru_backward(x, r, i, lam, h0, dy, dh):
    """The gradient of :func:`rglru` into (x, r, i, lam, h0), each in its
    input's dtype (None where an input needs none or h0 is None), given the
    cotangents of y and of h_last (either may be None). It recomputes the
    recurrence in fp32 through ``ref.rglru_chunked_reference`` (chunks of
    ``RGLRU_BACKWARD_CHUNK``: a Python step per step of one chunk and per
    chunk, never per step of T) and differentiates it."""
    with torch.enable_grad():
        y, h_last = ref.rglru_chunked_reference(x.float(), r.float(), i.float(), lam.float(),
                                                None if h0 is None else h0.float(), chunk=RGLRU_BACKWARD_CHUNK)
        return _input_grads((x, r, i, lam, h0), (y, h_last), (dy, dh))


class SSDScan(torch.autograd.Function):
    """The SSD scan with a gradient: the forward is :func:`ssd_scan` (the two
    SSD kernels on the card, the sequential plain version on the CPU, shapes
    only on meta), the backward :func:`ssd_backward`. It saves x, dA, B_ and
    C_ only."""

    @staticmethod
    def forward(ctx, x, dA, B_, C_, chunk):
        ctx.save_for_backward(x, dA, B_, C_)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return ssd_scan(x, dA, B_, C_, chunk)

    @staticmethod
    @trace.spanned("ssd.backward")
    def backward(ctx, dy, dH):
        x, dA, B_, C_ = _grad_leaves(ctx, ctx.saved_tensors)
        return (*ssd_backward(x, dA, B_, C_, ctx.chunk, dy, dH), None)


class RGLRU(torch.autograd.Function):
    """The RG-LRU with a gradient: the forward is :func:`rglru` (the RG-LRU
    kernel on the card, the sequential plain version on the CPU, shapes only
    on meta), the backward :func:`rglru_backward`."""

    @staticmethod
    def forward(ctx, x, r, i, lam, h0):
        ctx.save_for_backward(x, r, i, lam, h0)
        ctx.set_materialize_grads(False)
        return rglru(x, r, i, lam, h0)

    @staticmethod
    @trace.spanned("rglru.backward")
    def backward(ctx, dy, dh):
        return rglru_backward(*_grad_leaves(ctx, ctx.saved_tensors), dy, dh)


def gather_rows(src, idx):
    """src (M, d), idx (R,) int64 in [0, M] → (R, d) in src's dtype:
    ``src[idx[r]]``, zeros where ``idx[r] == M``."""
    if src.is_meta:
        cost.record("gather_rows", cost.gather_rows(src, idx))
        return _empty((idx.shape[0], src.shape[1]), src.dtype, src)
    if src.is_cuda:
        _no_autograd("row gather", "train through ops.MoEDispatch / ops.MoECombine (models/moe.py)", src)
        if cost.counting():
            cost.record("gather_rows", cost.gather_rows(src, idx))
        return moe_gather.gather_rows(src, idx)
    return ref.gather_rows_reference(src, idx)


def gather_sum_rows(src, places, fp32_sum: bool = False):
    """src (M, d), places (N, k) int64 in [0, M] → (N, d) in src's dtype:
    ``Σ_j src[places[n, j]]`` in j order, a place M adding nothing; rounded
    after each add, or with ``fp32_sum`` summed in fp32 and rounded once."""
    if src.is_meta:
        cost.record("gather_sum_rows", cost.gather_sum_rows(src, places))
        return _empty((places.shape[0], src.shape[1]), src.dtype, src)
    if src.is_cuda:
        _no_autograd("row gather", "train through ops.MoEDispatch / ops.MoECombine (models/moe.py)", src)
        if cost.counting():
            cost.record("gather_sum_rows", cost.gather_sum_rows(src, places))
        return moe_gather.gather_sum_rows(src, places, fp32_sum)
    return ref.gather_sum_rows_reference(src, places, fp32_sum)


def count_rows(places, M: int) -> None:
    """While a profiler records, the counters ``moe.rows_gathered`` (places
    that are rows of the source: the rows a gather copies) and
    ``moe.rows_zeroed`` (rows of ``places`` (R, j) with none: output rows
    written as zeros without a read) of one gather through ``places``."""
    if trace.recording():
        live = places < M
        trace.count("moe.rows_gathered", live.sum())
        trace.count("moe.rows_zeroed", (~live.any(dim=1)).sum())


class MoEDispatch(torch.autograd.Function):
    """The MoE's dispatch: xt (N, d) through table (E, C) of token ids (N
    where a slot is dead) → xe (E, C, d), dead slots zero
    (:func:`gather_rows`). Its backward sums each token's slots through the
    inverse map, slots (N, k) of places in the flattened ``E·C`` outputs
    (``E·C`` where the token lost an expert): ``d_xt[n] = Σ_j
    d_xe[slots[n, j]]`` in ascending expert id, in fp32, rounded once
    (:func:`gather_sum_rows`). It saves slots only."""

    @staticmethod
    def forward(ctx, xt, table, slots):
        ctx.save_for_backward(slots)
        E, C = table.shape
        return gather_rows(xt, table.reshape(E * C)).view(E, C, xt.shape[1])

    @staticmethod
    def backward(ctx, d_xe):
        (slots,) = ctx.saved_tensors
        E, C, d = d_xe.shape
        count_rows(slots, E * C)
        return gather_sum_rows(d_xe.reshape(E * C, d), slots, fp32_sum=True), None, None


class MoECombine(torch.autograd.Function):
    """The MoE's combine: ye (E, C, d) through slots (N, k) → y (N, d), each
    token's outputs added in ascending expert id and rounded after each add
    (:func:`gather_sum_rows`). Its backward gathers through the inverse map,
    table (E, C): ``d_ye[e, c] = dy[table[e, c]]``, zero at a dead slot
    (:func:`gather_rows`). It saves table only."""

    @staticmethod
    def forward(ctx, ye, slots, table):
        ctx.save_for_backward(table)
        E, C, d = ye.shape
        return gather_sum_rows(ye.reshape(E * C, d), slots)

    @staticmethod
    def backward(ctx, dy):
        (table,) = ctx.saved_tensors
        E, C = table.shape
        count_rows(table.reshape(E * C, 1), dy.shape[0])
        return gather_rows(dy, table.reshape(E * C)).view(E, C, dy.shape[1]), None, None
