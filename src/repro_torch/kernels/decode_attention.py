"""Wrapper around the CUDA paged-decode kernel (``csrc/paged_decode.cu``).

Replaces ``repro/kernels/decode_attention.py::paged_decode_attention``. The
kernel reads each page in place from the ``(P, page, K, hd)`` arena and
dereferences the page table itself. CUDA tensors only:
:func:`repro_torch.kernels.ops.paged_decode` sends CPU tensors to the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        lib = _build.library("paged_decode")
        fn = lib.paged_decode_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 8
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.paged_decode_error_string.argtypes = [ctypes.c_int]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.paged_decode_error_string)
    return _fn


def shared_memory_bytes(hd: int, groups: int) -> int:
    """Dynamic shared memory of one block of the kernel at head_dim ``hd``
    with ``groups`` query heads per kv head."""
    fn = _build.library("paged_decode").paged_decode_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(hd, groups)


def paged_decode_attention(q: torch.Tensor, pages_k: torch.Tensor, pages_v: torch.Tensor,
                           page_table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd); pages_k/pages_v (P,page,K,hd); page_table (B,maxp) int32;
    lengths (B,) int32 → (B,H,hd) in q's dtype. q and the pages may differ in
    dtype (fp32 or bf16 each). Page ids must lie in [0, P)."""
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
    if page_table.stride(1) != 1 or not lengths.is_contiguous():
        raise ValueError("page_table needs unit column stride, lengths contiguity")
    fn, err = _entry()
    o = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    rc = fn(
        q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), o.data_ptr(),
        B, H, K, hd, P, page, page_table.shape[1],
        q.stride(0), q.stride(1), *pages_k.stride()[:3], page_table.stride(0),
        o.stride(0), o.stride(1),
        _DTYPES[q.dtype], _DTYPES[pages_k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: {err(rc).decode()}")
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0
