"""Wrappers around the CUDA SSD chunk kernels (``csrc/ssd_scan.cu``).

Replaces ``repro/kernels/ssd_scan.py::ssd_chunked_pallas``: :func:`ssd_states`
is its ``_states_kernel``, :func:`ssd_output` its ``_output_kernel``, and
:func:`ssd_chunked_cuda` runs both around the inter-chunk recurrence, which
stays in PyTorch (nc steps of an elementwise update, as the reference keeps
it in a host ``lax.scan``). bf16 inputs run on the tensor cores (``mma.sync``,
fp32 accumulation; every fp32 operand enters as three bf16 terms that sum to
it, so nothing is rounded beyond the bf16 inputs); fp32 inputs on CUDA cores
in fp32. Inputs are read in place through their strides; a ragged last chunk
is masked inside the kernels as identity steps, so nothing is padded on the
host. CUDA tensors only, ``g == 1`` only (as the TPU kernel):
:func:`repro_torch.kernels.ops.ssd_scan` sends CPU tensors to the plain
version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

HEAD_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 256
MAX_STATE = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = None


def _entry():
    global _fns
    if _fns is None:
        lib = _build.library("ssd_scan")
        states = lib.ssd_states_fwd
        states.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 10 + [
            ctypes.c_int, ctypes.c_void_p]
        states.restype = ctypes.c_int
        output = lib.ssd_output_fwd
        output.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8 + [
            ctypes.c_int, ctypes.c_void_p]
        output.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _fns = (states, output, lib.ssd_error_string)
    return _fns


def shared_memory_bytes(p: int, n: int, dtype: torch.dtype = torch.bfloat16) -> tuple[int, int]:
    """Dynamic shared memory of one block of (ssd_states, ssd_output) for
    ``dtype`` inputs at head_dim ``p`` and state ``n``."""
    lib = _build.library("ssd_scan")
    out = []
    for fn in (lib.ssd_states_smem_bytes, lib.ssd_output_smem_bytes):
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
        out.append(fn(p, n, _DTYPES[dtype]))
    return out[0], out[1]


def _check_bc(name, t, x, b, T):
    if not (t.is_cuda and t.device == x.device):
        raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
    if t.ndim != 4 or t.shape[:2] != (b, T):
        raise ValueError(f"{name} must be (b, t, g, n), got {tuple(t.shape)}")
    if t.shape[2] != 1:
        raise ValueError(f"the SSD kernels take a single group (g == 1), got g = {t.shape[2]}")
    if t.stride(3) != 1:
        raise ValueError(f"{name} needs a unit stride along n")


def _check_chunk(chunk, p, n):
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    if p not in HEAD_DIMS or not 1 <= n <= MAX_STATE:
        raise ValueError(f"head_dim {p} not in {HEAD_DIMS} or state {n} outside [1, {MAX_STATE}]")


def _check_rows_aligned(dtype, **tensors):
    """bf16 tiles are copied in 16-byte pieces: each row (every dimension but
    the last) must start on 16 bytes."""
    if dtype != torch.bfloat16:
        return
    for name, t in tensors.items():
        per16 = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % per16 for st, n in zip(t.stride()[:-1], t.shape) if n > 1):
            raise ValueError(f"bf16 SSD kernels need the rows of {name} on 16 bytes "
                             f"(strides {t.stride()}, data pointer % 16 = {t.data_ptr() % 16})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ssd_states(x: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor, chunk: int):
    """x (b,t,h,p) fp32 or bf16; dA (b,t,h) fp32; B_/C_ (b,t,1,n) in x's
    dtype → (y_diag (b,nc,h,cs,p), S (b,nc,h,p,n)), both fp32, nc = ⌈t/cs⌉.
    In bf16 each row of x, B_ and C_ must start on 16 bytes."""
    if not x.is_cuda:
        raise ValueError("ssd_states takes CUDA tensors")
    if x.ndim != 4 or x.dtype not in _DTYPES or x.stride(3) != 1:
        raise ValueError(f"x must be (b,t,h,p) fp32/bf16 with unit stride along p, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, T, h, p = x.shape
    for name, t in (("B_", B_), ("C_", C_)):
        _check_bc(name, t, x, b, T)
        if t.dtype != x.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from x's {x.dtype}")
    if not (dA.is_cuda and dA.device == x.device) or dA.shape != (b, T, h) or dA.dtype != torch.float32:
        raise ValueError(f"dA must be (b,t,h) fp32 on {x.device}, got {tuple(dA.shape)} {dA.dtype}")
    n = B_.shape[3]
    _check_chunk(chunk, p, n)
    _check_rows_aligned(x.dtype, x=x, B_=B_[:, :, 0], C_=C_[:, :, 0])
    nc = -(-T // chunk)
    y_diag = torch.empty((b, nc, h, chunk, p), dtype=torch.float32, device=x.device)
    S = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=x.device)
    fn, _, err = _entry()
    rc = fn(x.data_ptr(), dA.data_ptr(), B_.data_ptr(), C_.data_ptr(), y_diag.data_ptr(), S.data_ptr(),
            b, T, h, p, n, chunk, *x.stride()[:3], *dA.stride(), *B_.stride()[:2], *C_.stride()[:2],
            _DTYPES[x.dtype], _stream(x))
    if rc != 0:
        raise RuntimeError(f"ssd_states kernel launch failed: {err(rc).decode()}")
    ssd_states.launches += 1
    return y_diag, S


def ssd_output(y_diag: torch.Tensor, dA: torch.Tensor, C_: torch.Tensor, H_in: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """y_diag (b,nc,h,cs,p) fp32; dA (b,t,h) fp32; C_ (b,t,1,n); H_in
    (b,nc,h,p,n) fp32, the state entering each chunk → y (b,t,h,p) in
    ``dtype`` (which is also C_'s). In bf16 each row of C_, y_diag and H_in
    must start on 16 bytes."""
    if not y_diag.is_cuda:
        raise ValueError("ssd_output takes CUDA tensors")
    if y_diag.ndim != 5 or y_diag.dtype != torch.float32 or not y_diag.is_contiguous():
        raise ValueError(f"y_diag must be contiguous fp32 (b,nc,h,cs,p), got {tuple(y_diag.shape)}")
    b, nc, h, cs, p = y_diag.shape
    if not (dA.is_cuda and dA.device == y_diag.device) or dA.ndim != 3 or dA.dtype != torch.float32:
        raise ValueError(f"dA must be (b,t,h) fp32 on {y_diag.device}")
    T = dA.shape[1]
    if dA.shape != (b, T, h) or -(-T // cs) != nc:
        raise ValueError(f"dA {tuple(dA.shape)} does not fit y_diag {tuple(y_diag.shape)}")
    _check_bc("C_", C_, y_diag, b, T)
    n = C_.shape[3]
    if dtype not in _DTYPES or C_.dtype != dtype:
        raise ValueError(f"output dtype {dtype} must be fp32/bf16 and C_'s ({C_.dtype})")
    if H_in.shape != (b, nc, h, p, n) or H_in.dtype != torch.float32 or not H_in.is_contiguous() \
            or H_in.device != y_diag.device:
        raise ValueError(f"H_in must be contiguous fp32 {(b, nc, h, p, n)}, got {tuple(H_in.shape)}")
    _check_chunk(cs, p, n)
    _check_rows_aligned(dtype, C_=C_[:, :, 0], y_diag=y_diag, H_in=H_in.flatten(-2))
    y = torch.empty((b, T, h, p), dtype=dtype, device=y_diag.device)
    _, fn, err = _entry()
    rc = fn(y_diag.data_ptr(), dA.data_ptr(), C_.data_ptr(), H_in.data_ptr(), y.data_ptr(),
            b, T, h, p, n, cs, *dA.stride(), *C_.stride()[:2], *y.stride()[:3],
            _DTYPES[dtype], _stream(y_diag))
    if rc != 0:
        raise RuntimeError(f"ssd_output kernel launch failed: {err(rc).decode()}")
    ssd_output.launches += 1
    return y


ssd_states.launches = 0
ssd_output.launches = 0


def inter_chunk_scan(S: torch.Tensor, dA: torch.Tensor, chunk: int):
    """``H_c = exp(ΣdA_c)·H_{c−1} + S_c`` in fp32 over the chunks, from zero.
    S (b,nc,h,p,n) fp32; dA (b,t,h), its ragged tail an identity step.
    Returns (H_in (b,nc,h,p,n), the state entering each chunk; H_last
    (b,h,p,n))."""
    b, nc, h = S.shape[:3]
    T = dA.shape[1]
    decay = torch.exp(F.pad(dA.float(), (0, 0, 0, nc * chunk - T)).reshape(b, nc, chunk, h).sum(2))
    H_in = torch.empty_like(S)
    H = torch.zeros_like(S[:, 0])
    for c in range(nc):
        H_in[:, c] = H
        H = decay[:, c, :, None, None] * H + S[:, c]
    return H_in, H


def ssd_chunked_cuda(x: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor, chunk: int):
    """x (b,t,h,p); dA (b,t,h) fp32; B_/C_ (b,t,1,n) → (y (b,t,h,p) in x's
    dtype, H_last (b,h,p,n) fp32). Counterpart of ``ssd_chunked_pallas``;
    ``t`` need not be a multiple of ``chunk``."""
    y_diag, S = ssd_states(x, dA, B_, C_, chunk)
    H_in, H_last = inter_chunk_scan(S, dA, chunk)
    return ssd_output(y_diag, dA, C_, H_in, x.dtype), H_last
