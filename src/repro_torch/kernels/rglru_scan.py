"""Wrapper around the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

Replaces ``repro/kernels/rglru_scan.py::rglru_pallas``. x, r and i are read
in place through their strides (unit stride along W); any T and W are taken.
The kernel is a chunked scan over T in one launch; its ticket, flags and
chunk aggregates live in a workspace allocated here per call (from the
caching allocator, so a CUDA graph keeps its own). CUDA tensors only:
:func:`repro_torch.kernels.ops.rglru` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, r, i, lam, h0, y, h_last, workspace; B, T, W; the (b, t) strides of x, r, i; dtype, stream
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p]
_fn = None


def _entry():
    global _fn
    if _fn is None:
        lib = _build.library("rglru_scan")
        fn = lib.rglru_scan_fwd
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        lib.rglru_scan_workspace_bytes.argtypes = [ctypes.c_int] * 3
        lib.rglru_scan_workspace_bytes.restype = ctypes.c_longlong
        lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
        lib.rglru_scan_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.rglru_scan_workspace_bytes, lib.rglru_scan_error_string)
    return _fn


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor,
               h0: torch.Tensor | None = None):
    """x, r, i (B,T,W) fp32 or bf16, one dtype, on one CUDA device; lam (W,)
    of any float dtype (cast to fp32); h0 (B,W) fp32 or None (zeros) →
    (y (B,T,W) in x's dtype, h_last (B,W) fp32)."""
    if not all(t.is_cuda and t.device == x.device for t in (x, r, i, lam)):
        raise ValueError("rglru_scan takes CUDA tensors on one device")
    if x.dtype not in _DTYPES or r.dtype != x.dtype or i.dtype != x.dtype:
        raise ValueError(f"rglru_scan takes fp32 or bf16 x/r/i of one dtype, got "
                         f"{x.dtype}, {r.dtype}, {i.dtype}")
    if x.ndim != 3 or r.shape != x.shape or i.shape != x.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, r {tuple(r.shape)}, i {tuple(i.shape)}")
    B, T, W = x.shape
    if lam.shape != (W,):
        raise ValueError(f"lam must be ({W},), got {tuple(lam.shape)}")
    if x.stride(2) != 1 or r.stride(2) != 1 or i.stride(2) != 1:
        raise ValueError("rglru_scan needs a unit stride along W for x, r and i")
    if h0 is not None and (h0.device != x.device or h0.dtype != torch.float32 or h0.shape != (B, W)
                           or not h0.is_contiguous()):
        raise ValueError(f"h0 must be contiguous fp32 ({B}, {W}) on {x.device}")
    lam32 = lam.to(torch.float32).contiguous()
    fn, workspace_bytes, err = _entry()
    y = torch.empty((B, T, W), dtype=x.dtype, device=x.device)
    h_last = torch.empty((B, W), dtype=torch.float32, device=x.device)
    ws = torch.empty(workspace_bytes(B, T, W), dtype=torch.uint8, device=x.device)
    rc = fn(x.data_ptr(), r.data_ptr(), i.data_ptr(), lam32.data_ptr(),
            h0.data_ptr() if h0 is not None else None, y.data_ptr(), h_last.data_ptr(), ws.data_ptr(),
            B, T, W, *x.stride()[:2], *r.stride()[:2], *i.stride()[:2], _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: {err(rc).decode()}")
    rglru_scan.launches += 1
    return y, h_last


rglru_scan.launches = 0
