"""Wrapper around the CUDA paged-decode kernels (``csrc/paged_decode.cu``).

Replaces ``repro/kernels/decode_attention.py::paged_decode_attention``. The
work is split over the sequence (flash-decode): a partial kernel on a grid of
(splits, kv heads, sequences) reads each page in place from the ``(P, page,
K, hd)`` arena through the page table and writes per-split fp32 (m, l, acc);
a combine kernel merges the splits. Their plain versions are
:func:`.ref.paged_decode_partials_reference` and
:func:`.ref.combine_partials_reference`. CUDA tensors only:
:func:`repro_torch.kernels.ops.paged_decode` sends CPU tensors to the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 64
SPLIT_TILE = 16  # tokens per tile of the partial kernel: a split is whole tiles
NUM_SMS = 132  # H100 SXM
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def num_splits(B: int, K: int, capacity: int) -> int:
    """Splits of each (sequence, kv head)'s ``capacity`` token positions, so
    that ``B·K·splits`` covers the SMs at least once where the capacity has
    enough 16-token tiles, else one split per tile. Chosen on the host from
    shapes alone: the lengths stay on the device."""
    tiles = max(1, -(-capacity // SPLIT_TILE))
    want = min(tiles, -(-NUM_SMS // max(1, B * K)))
    per = tiles // want  # tiles per split, rounded down so that splits >= want
    return -(-tiles // per)


def split_tokens(capacity: int, splits: int) -> int:
    """Token positions of each split: whole 16-token tiles, ``splits`` of
    them covering ``capacity``."""
    tiles = max(1, -(-capacity // SPLIT_TILE))
    return -(-tiles // splits) * SPLIT_TILE


def _entry():
    global _fn
    if _fn is None:
        lib = _build.library("paged_decode")
        fn = lib.paged_decode_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 8
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.paged_decode_error_string.argtypes = [ctypes.c_int]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.paged_decode_error_string)
    return _fn


def shared_memory_bytes(hd: int, groups: int, kv_dtype: torch.dtype = torch.bfloat16,
                        page: int = 64, split_len: int = SPLIT_TILE) -> int:
    """Dynamic shared memory of one block of the partial kernel at head_dim
    ``hd`` with ``groups`` query heads per kv head, ``kv_dtype`` pages of
    ``page`` tokens and splits of ``split_len`` tokens."""
    fn = _build.library("paged_decode").paged_decode_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    return fn(hd, groups, _DTYPES[kv_dtype], page, split_len)


def paged_decode_attention(q: torch.Tensor, pages_k: torch.Tensor, pages_v: torch.Tensor,
                           page_table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd); pages_k/pages_v (P,page,K,hd); page_table (B,maxp) int32;
    lengths (B,) int32 → (B,H,hd) in q's dtype. q and the pages may differ in
    dtype (fp32 or bf16 each). Page ids must lie in [0, P). The pages' rows
    must start on 16 bytes (the kernel copies them in 16-byte pieces).

    ``paged_decode_attention.launches`` counts calls of this wrapper: one per
    call, although each call launches two kernels (partials and combine)."""
    o = _launch(q, pages_k, pages_v, page_table, lengths)[2]
    paged_decode_attention.launches += 1
    return o


def paged_decode_partials(q, pages_k, pages_v, page_table, lengths, split_len: int):
    """Both kernels with splits of ``split_len`` tokens (a multiple of 16),
    for tests: returns (m, l) (B,K,splits,G) and acc (B,K,splits,G,hd) in fp32
    as the partial kernel wrote them, to hold against
    :func:`.ref.paged_decode_partials_reference`, and the combined output.
    Not counted in ``paged_decode_attention.launches``."""
    ml, acc, o = _launch(q, pages_k, pages_v, page_table, lengths, split_len)
    return ml[..., 0], ml[..., 1], acc, o


def _launch(q, pages_k, pages_v, page_table, lengths, split_len=None):
    """Checks, then both kernels; ``split_len`` None: the plan of
    :func:`num_splits`. Returns the workspaces and the output."""
    tensors = (q, pages_k, pages_v, page_table, lengths)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_decode_attention takes CUDA tensors on one device")
    if q.dtype not in _DTYPES or pages_k.dtype not in _DTYPES or pages_v.dtype != pages_k.dtype:
        raise ValueError(f"dtypes q {q.dtype}, pages {pages_k.dtype}/{pages_v.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths must be int32")
    if q.ndim != 3 or pages_k.ndim != 4 or pages_v.shape != pages_k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, pages {tuple(pages_k.shape)}")
    B, H, hd = q.shape
    P, page, K, _ = pages_k.shape
    if pages_k.shape[3] != hd or K == 0 or H % K or H // K > MAX_GROUP:
        raise ValueError(f"shapes q {tuple(q.shape)}, pages {tuple(pages_k.shape)}")
    if page_table.ndim != 2 or page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)}, lengths {tuple(lengths.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if pages_k.stride() != pages_v.stride() or pages_k.stride(3) != 1 or q.stride(2) != 1:
        raise ValueError("pages need equal strides and a unit stride along head_dim; q too")
    vec = 16 // pages_k.element_size()
    if (any(st % vec for st, n in zip(pages_k.stride()[:3], pages_k.shape) if n > 1)
            or (pages_k.data_ptr() | pages_v.data_ptr()) % 16):
        raise ValueError("page rows must start on 16 bytes (strides and data pointers)")
    if page_table.stride(1) != 1 or not lengths.is_contiguous():
        raise ValueError("page_table needs unit column stride, lengths contiguity")
    maxp = page_table.shape[1]
    if split_len is None:
        split_len = split_tokens(maxp * page, num_splits(B, K, maxp * page))
    if split_len <= 0 or split_len % SPLIT_TILE:
        raise ValueError(f"split_len {split_len} is not a positive multiple of {SPLIT_TILE}")
    fn, err = _entry()
    splits = max(1, -(-maxp * page // split_len))
    G = H // K
    o = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    ws_ml = torch.empty((B, K, splits, G, 2), dtype=torch.float32, device=q.device)
    ws_acc = torch.empty((B, K, splits, G, hd), dtype=torch.float32, device=q.device)
    rc = fn(
        q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), ws_ml.data_ptr(), ws_acc.data_ptr(), o.data_ptr(),
        B, H, K, hd, P, page, maxp, split_len, splits,
        q.stride(0), q.stride(1), *pages_k.stride()[:3], page_table.stride(0),
        o.stride(0), o.stride(1),
        _DTYPES[q.dtype], _DTYPES[pages_k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: {err(rc).decode()}")
    return ws_ml, ws_acc, o


paged_decode_attention.launches = 0
