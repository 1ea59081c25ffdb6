"""Wrapper around the CUDA row-gather kernels of the MoE (``csrc/moe_gather.cu``).

Replaces no TPU kernel: the PyTorch advanced indexing of
``models/moe.py::_moe_tokens`` and its sorting ``index_put_`` backward. Rows
are ``d`` elements wide, ``d`` a multiple of 8 (16-byte vectors of fp32 or
bf16); indices are int64, as ``models.moe.dispatch`` makes them; the pad index
is ``src``'s row count, and any index that is not a row of ``src`` gives a
zero row (the sum: adds nothing). Inputs are made contiguous; the output is
allocated here; the kernels launch on the current stream. CUDA tensors only:
:func:`repro_torch.kernels.ops.gather_rows` and ``gather_sum_rows`` send CPU
tensors to the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = None


def _entry():
    global _fns
    if _fns is None:
        lib = _build.library("moe_gather")
        rows = lib.moe_gather_rows
        # src, idx, out; rows, M, row_bytes; stream
        rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        rows.restype = ctypes.c_int
        sums = lib.moe_gather_sum_rows
        # src, places, out; rows, k, M, d, dtype, fp32_sum; stream
        sums.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong] + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        sums.restype = ctypes.c_int
        lib.moe_gather_error_string.argtypes = [ctypes.c_int]
        lib.moe_gather_error_string.restype = ctypes.c_char_p
        _fns = (rows, sums, lib.moe_gather_error_string)
    return _fns


def _rows_in(src: torch.Tensor, index: torch.Tensor, name: str) -> torch.Tensor:
    """src checked and made contiguous and 16-byte aligned."""
    if not (src.is_cuda and index.device == src.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if src.dtype not in _DTYPES or index.dtype != torch.int64:
        raise ValueError(f"{name} takes fp32 or bf16 rows and int64 indices, got {src.dtype}, {index.dtype}")
    if src.ndim != 2 or src.shape[1] % 8:
        raise ValueError(f"{name} takes rows (M, d) with d a multiple of 8, got {tuple(src.shape)}")
    src = src.contiguous()
    return src if src.data_ptr() % 16 == 0 else src.clone()


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: {_entry()[2](rc).decode()}")


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (M, d), idx (R,) → out (R, d) in src's dtype: ``out[r] =
    src[idx[r]]``, zeros where ``idx[r] == M``."""
    src = _rows_in(src, idx, "gather_rows")
    if idx.ndim != 1:
        raise ValueError(f"gather_rows takes indices (R,), got {tuple(idx.shape)}")
    idx = idx.contiguous()
    (M, d), R = src.shape, idx.shape[0]
    out = torch.empty((R, d), dtype=src.dtype, device=src.device)
    rc = _entry()[0](src.data_ptr(), idx.data_ptr(), out.data_ptr(), R, M, d * src.element_size(),
                     torch.cuda.current_stream(src.device).cuda_stream)
    _check(rc, "gather_rows")
    gather_rows.launches += 1
    return out


def gather_sum_rows(src: torch.Tensor, places: torch.Tensor, fp32_sum: bool = False) -> torch.Tensor:
    """src (M, d), places (N, k) → out (N, d) in src's dtype: ``out[n] =
    Σ_j src[places[n, j]]`` in j order, places equal to M adding nothing.
    Rounded to the dtype after each add, or with ``fp32_sum`` summed in fp32
    and rounded once."""
    src = _rows_in(src, places, "gather_sum_rows")
    if places.ndim != 2:
        raise ValueError(f"gather_sum_rows takes places (N, k), got {tuple(places.shape)}")
    places = places.contiguous()
    (M, d), (N, k) = src.shape, places.shape
    out = torch.empty((N, d), dtype=src.dtype, device=src.device)
    rc = _entry()[1](src.data_ptr(), places.data_ptr(), out.data_ptr(), N, k, M, d, _DTYPES[src.dtype],
                     int(fp32_sum), torch.cuda.current_stream(src.device).cuda_stream)
    _check(rc, "gather_sum_rows")
    gather_sum_rows.launches += 1
    return out


gather_rows.launches = 0
gather_sum_rows.launches = 0
