"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the reference package, so it also runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention

torch.set_num_threads(1)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the grids of tests/test_kernels.py, plus the serving shapes of qwen3-4b
FLASH_GRID = [
    (2, 256, 8, 4, 64, True, None),
    (1, 384, 4, 1, 128, True, None),
    (2, 256, 8, 8, 64, False, None),
    (1, 512, 4, 2, 64, True, 128),
    (1, 200, 4, 2, 64, True, None),
    (1, 256, 2, 2, 32, True, None),
    (1, 128, 32, 8, 128, True, None),
]
PAGED_GRID = [(2, 8, 4, 64, 16, 128, 4), (4, 4, 1, 128, 32, 128, 6), (2, 16, 8, 64, 16, 256, 3),
              (1, 32, 8, 128, 4, 64, 4)]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _close(ref_out, out, dtype):
    np.testing.assert_allclose(ref_out.float().cpu().numpy(), out.float().cpu().numpy(),
                               atol=_tol(dtype), rtol=1e-2)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, DTYPES[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,H,K,hd,causal,window", FLASH_GRID)
def test_flash_kernel_matches_plain(cuda, B, T, H, K, hd, causal, window, dtype):
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, T, H, hd), dtype, cuda)
    k, v = (_randn(rng, (B, T, K, hd), dtype, cuda) for _ in range(2))
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(ref.mha_reference(q, k, v, causal=causal, window=window), out, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,K,hd,P,page,maxp", PAGED_GRID)
def test_paged_kernel_matches_plain(cuda, B, H, K, hd, P, page, maxp, dtype):
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, H, hd), dtype, cuda)
    pk, pv = (_randn(rng, (P, page, K, hd), dtype, cuda) for _ in range(2))
    pt = torch.from_numpy(rng.integers(0, P, size=(B, maxp)).astype(np.int32)).to(cuda)
    lengths = torch.from_numpy(rng.integers(1, maxp * page, size=(B,)).astype(np.int32)).to(cuda)
    out = paged_decode_attention(q, pk, pv, pt, lengths)
    torch.cuda.synchronize()
    _close(ref.paged_decode_reference(q, pk, pv, pt, lengths), out, dtype)


@pytest.mark.gpu
def test_kernels_read_strided_views(cuda):
    """q/k/v as views into one fused tensor (no copy), ragged lengths, length 0."""
    rng = np.random.default_rng(1)
    qkv = _randn(rng, (2, 70, 12, 64), "bfloat16", cuda)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    _close(ref.mha_reference(q, k, v), flash_attention(q, k, v), "bfloat16")
    q = _randn(rng, (3, 8, 64), "float32", cuda)
    pk, pv = (_randn(rng, (10, 16, 2, 64), "float32", cuda) for _ in range(2))
    pt = torch.from_numpy(rng.integers(0, 10, size=(3, 5)).astype(np.int32)).to(cuda)
    lengths = torch.tensor([0, 1, 80], dtype=torch.int32, device=cuda)
    out = paged_decode_attention(q, pk, pv, pt, lengths)
    _close(ref.paged_decode_reference(q, pk, pv, pt, lengths), out, "float32")
    assert (out[0] == 0).all()


@pytest.mark.gpu
def test_model_attention_on_card_matches_cpu(cuda):
    """full_attention / decode_attention on CUDA tensors (kernels) equal their
    CPU bodies, incl. an fp32 query over the bf16 cache."""
    rng = np.random.default_rng(2)
    q = _randn(rng, (2, 40, 8, 16), "float32", "cpu")
    k, v = (_randn(rng, (2, 40, 2, 16), "float32", "cpu") for _ in range(2))
    out = attention.full_attention(q.to(cuda), k.to(cuda), v.to(cuda))
    _close(attention.full_attention(q, k, v), out, "float32")
    kc, vc = (_randn(rng, (2, 48, 2, 16), "bfloat16", "cpu") for _ in range(2))
    qd = _randn(rng, (2, 1, 8, 16), "float32", "cpu")
    for cache_len in (1, 33, torch.tensor([5, 48], dtype=torch.int32)):
        dev_len = cache_len.to(cuda) if isinstance(cache_len, torch.Tensor) else cache_len
        out = attention.decode_attention(qd.to(cuda), kc.to(cuda), vc.to(cuda), dev_len)
        _close(attention.decode_attention(qd, kc, vc, cache_len), out, "float32")
