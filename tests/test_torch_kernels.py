"""The port's attention kernels: plain versions against repro.kernels.ref over
the tests/test_kernels.py grids, one case each against the Pallas kernel in
interpret mode, and device dispatch in ops. The CUDA kernels themselves are
held against the plain versions on the card, in tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import paged_decode_attention as pallas_paged_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.flash_attention import flash_attention

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# the grids of tests/test_kernels.py
FLASH_GRID = [
    (2, 256, 8, 4, 64, True, None),   # GQA
    (1, 384, 4, 1, 128, True, None),  # MQA
    (2, 256, 8, 8, 64, False, None),  # MHA bidirectional
    (1, 512, 4, 2, 64, True, 128),    # sliding window
    (1, 200, 4, 2, 64, True, None),   # unaligned T
    (1, 256, 2, 2, 32, True, None),   # small head_dim
]
PAGED_GRID = [(2, 8, 4, 64, 16, 128, 4), (4, 4, 1, 128, 32, 128, 6), (2, 16, 8, 64, 16, 256, 3)]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().cpu().numpy(),
                               atol=_tol(dtype), rtol=1e-2)


def _flash_inputs(B, T, H, K, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    jd, _ = DTYPES[dtype]
    arrs = [jnp.asarray(rng.normal(size=s), jd) for s in [(B, T, H, hd), (B, T, K, hd), (B, T, K, hd)]]
    return arrs, [tensor_from_numpy(np.asarray(a)) for a in arrs]


def _paged_inputs(B, H, K, hd, P, page, maxp, dtype, seed=0):
    rng = np.random.default_rng(seed)
    jd, _ = DTYPES[dtype]
    arrs = [jnp.asarray(rng.normal(size=s), jd) for s in [(B, H, hd), (P, page, K, hd), (P, page, K, hd)]]
    arrs.append(jnp.asarray(rng.integers(0, P, size=(B, maxp)), jnp.int32))
    arrs.append(jnp.asarray(rng.integers(1, maxp * page, size=(B,)), jnp.int32))
    return arrs, [tensor_from_numpy(np.asarray(a)) for a in arrs]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,H,K,hd,causal,window", FLASH_GRID)
def test_mha_reference_matches(B, T, H, K, hd, causal, window, dtype):
    (q, k, v), (tq, tk, tv) = _flash_inputs(B, T, H, K, hd, dtype)
    out = ref.mha_reference(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == DTYPES[dtype][1]
    _close(jref.mha_reference(q, k, v, causal=causal, window=window), out, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,K,hd,P,page,maxp", PAGED_GRID)
def test_paged_decode_reference_matches(B, H, K, hd, P, page, maxp, dtype):
    jargs, targs = _paged_inputs(B, H, K, hd, P, page, maxp, dtype)
    out = ref.paged_decode_reference(*targs)
    assert out.dtype == DTYPES[dtype][1]
    _close(jref.paged_decode_reference(*jargs), out, dtype)


def test_flash_plain_matches_pallas_interpret():
    (q, k, v), (tq, tk, tv) = _flash_inputs(1, 200, 4, 2, 32, "float32")
    out = pallas_flash(q, k, v, causal=True, block_q=64, block_k=64, interpret=True)
    _close(out, ops.attention(tq, tk, tv, causal=True), "float32")


def test_paged_plain_matches_pallas_interpret():
    jargs, targs = _paged_inputs(2, 8, 4, 32, 12, 16, 4, "float32")
    jargs[4] = jnp.asarray([0, 37], jnp.int32)  # length 0 gives zeros in the TPU kernel
    targs[4] = torch.tensor([0, 37], dtype=torch.int32)
    out = ops.paged_decode(*targs)
    _close(pallas_paged_decode(*jargs, interpret=True), out, "float32")
    assert (out[0] == 0).all()


def test_ops_dispatch_cpu_goes_to_plain_version():
    f0, p0 = flash_attention.launches, paged_decode_attention.launches
    _, (tq, tk, tv) = _flash_inputs(1, 40, 4, 2, 16, "float32")
    assert torch.equal(ops.attention(tq, tk, tv, window=8), ref.mha_reference(tq, tk, tv, window=8))
    _, targs = _paged_inputs(2, 4, 2, 16, 8, 16, 3, "bfloat16")
    assert torch.equal(ops.paged_decode(*targs), ref.paged_decode_reference(*targs))
    assert (flash_attention.launches, paged_decode_attention.launches) == (f0, p0)


def test_kernel_wrappers_refuse_cpu_tensors():
    _, (tq, tk, tv) = _flash_inputs(1, 8, 2, 1, 16, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(tq, tk, tv)
    _, targs = _paged_inputs(1, 2, 1, 16, 4, 16, 2, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(*targs)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_report_reads_ptxas():
    log = ("ptxas info    : Compiling entry function '_Z16flash_fwd_kernel' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z16flash_fwd_kernel\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 64 registers, 400 bytes cmem[0]\n")
    rep = _build.BuildReport("flash_attention", _build._target("flash_attention"), 1.0, log)
    assert rep.resources() == ["_Z16flash_fwd_kernel: Used 64 registers, 400 bytes cmem[0]"]
    assert rep.path.parent == _build.BUILD_DIR and rep.path.name.startswith("flash_attention-")
