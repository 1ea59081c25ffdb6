"""Wrapper around the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention``. bf16 inputs
run on the tensor cores (``mma.sync``, fp32 accumulation, P rounded to bf16
before P·V); fp32 inputs on CUDA cores in fp32. q/k/v are read in place
through their strides, so no pad, fold or transpose happens on the host. CUDA tensors only: :func:`repro_torch.kernels.ops.attention` sends CPU
tensors to the plain version.

The kernel has no backward. :func:`attention_backward` is its gradient in
torch ops, which :class:`repro_torch.kernels.ops.Attention` pairs with the
kernel's forward for training.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30
_fn = None


def _entry():
    global _fn
    if _fn is None:
        lib = _build.library("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def shared_memory_bytes(hd: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one block of the kernel for ``dtype`` inputs
    at head_dim ``hd``."""
    fn = _build.library("flash_attention").flash_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(hd, _DTYPES[dtype])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q (B,T,H,hd), k/v (B,S,K,hd) on one CUDA device, fp32 or bf16 →
    (B,T,H,hd) in q's dtype, with ``sm_scale = 1/sqrt(hd)``. In bf16 each
    row of q/k/v must start on 16 bytes (the kernel copies rows in 16-byte
    pieces)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention takes CUDA tensors on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes fp32 or bf16 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)} do not form GQA")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention needs a unit stride along head_dim")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st, n in zip(t.stride()[:3], t.shape) if n > 1)
            for t in (q, k, v)):
        raise ValueError("bf16 flash_attention needs q/k/v rows on 16 bytes (strides and data pointers)")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    fn, err = _entry()
    o = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, T, S, H, K, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), window or 0, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {err(rc).decode()}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def attention_backward(q, k, v, do, *, causal: bool = True, window: int | None = None,
                       q_chunk: int = 2048):
    """(dq, dk, dv) of ``softmax(Q·Kᵀ·s)·V`` at ``do``, in torch ops, as XLA
    differentiates the reference's jnp body
    (``repro/models/attention.py::full_attention``): q is scaled in its own
    dtype, the scores and softmax are fp32, and P is rounded to v's dtype
    before P·V, so dV = round(P)ᵀ·dO. Then dP = dO·Vᵀ,
    dS = P ⊙ (dP − rowsum(dP ⊙ P)), dQ = dS·K·s and dK = dSᵀ·(Q·s), summed
    over each kv head's query group. P is recomputed from q and k for
    ``q_chunk`` query rows at a time, so the memory is O(q_chunk·S). Works on
    any device; the gradients come back in the inputs' dtypes."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qs = q.reshape(B, T, K, G, D) * scale
    dog = do.reshape(B, T, K, G, D)
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(S, device=q.device)
    dq = torch.empty((B, T, K, G, D), dtype=q.dtype, device=q.device)
    dk = torch.zeros((B, S, K, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, S, K, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, T, q_chunk):
        qc, doc = qs[:, q0:q0 + q_chunk].float(), dog[:, q0:q0 + q_chunk].float()
        q_pos = q0 + torch.arange(qc.shape[1], device=q.device)
        mask = torch.ones((q_pos.shape[0], S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        s = torch.einsum("btkgd,bskd->bkgts", qc, kf)
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        dv += torch.einsum("bkgts,btkgd->bskd", p.to(v.dtype).float(), doc)
        dp = torch.einsum("btkgd,bskd->bkgts", doc, vf)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq[:, q0:q0 + q_chunk] = (torch.einsum("bkgts,bskd->btkgd", ds, kf) * scale).to(q.dtype)
        dk += torch.einsum("bkgts,btkgd->bskd", ds, qc)
    return dq.reshape(B, T, H, D), dk.to(k.dtype), dv.to(v.dtype)

