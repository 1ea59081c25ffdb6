"""The port's RG-LRU pieces on the CPU against the reference: the config, the
plain version of the CUDA kernel against the reference's sequential oracle
over the tests/test_kernels.py grid and against the Pallas kernel in
interpret mode with a carried h0, and the model's rglru_scan, rglru_step and
causal conv against the JAX functions. The CUDA kernel itself is held against
the plain version on the card, in tests/test_torch_gpu.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_pallas
from repro.models import rglru as jrglru
from repro_torch.configs import get_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rglru_scan import rglru_scan as rglru_kernel
from repro_torch.models import rglru

torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRID = [(2, 128, 256), (1, 256, 512)]  # tests/test_kernels.py::test_rglru_sweep
# tests/test_kernels.py::_tol with rtol 1e-2: fp32 differs in the order of
# operations only; bf16 rounds y, so a last-ulp fp32 difference may flip it
TOL = {"float32": (2e-5, 1e-2), "bfloat16": (2e-2, 1e-2)}
# tests/test_kernels.py::test_rglru_carried_state's tolerance (fp32)
FP32_ATOL = 1e-5


def _inputs(B, T, W, seed=0, lam_range=(0.5, 4.0)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, W)).astype(np.float32)
    r = rng.uniform(size=(B, T, W)).astype(np.float32)
    i = rng.uniform(size=(B, T, W)).astype(np.float32)
    lam = rng.uniform(*lam_range, size=(W,)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    return x, r, i, lam, h0


def _both(arrs, dtype):
    """numpy fp32 x/r/i → (jax, torch) in ``dtype``; lam and h0 stay fp32."""
    jdt, _ = DTYPES[dtype]
    x, r, i, lam, h0 = arrs
    j = [jnp.asarray(x, jdt), jnp.asarray(r, jdt), jnp.asarray(i, jdt), jnp.asarray(lam), jnp.asarray(h0)]
    return j, [tensor_from_numpy(np.asarray(a)) for a in j]


def _close(expect, got, tol):
    atol, rtol = tol
    np.testing.assert_allclose(np.asarray(expect, np.float32), got.float().numpy(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("over", [{}, {"n_layers": 5}])
def test_config_matches_reference(over):
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(ref_get_config(ARCH))
    r, t = ref_get_config(ARCH).reduced(**over), get_config(ARCH).reduced(**over)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert (t.n_layers, t.rnn_width, t.window, t.head_dim) == (over.get("n_layers", 3), 64, 32, 16)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,W", GRID)
def test_plain_matches_reference_oracle(B, T, W, dtype):
    (jx, jr, ji, jlam, _), (x, r, i, lam, _) = _both(_inputs(B, T, W), dtype)
    yr, hr = jref.rglru_reference(jx, jr, ji, jlam)
    y, h = ref.rglru_reference(x, r, i, lam)
    assert y.dtype == x.dtype and h.dtype == torch.float32 and h.shape == (B, W)
    _close(yr, y, TOL[dtype])
    _close(hr, h, TOL[dtype])


def test_plain_matches_pallas_interpret_with_carried_h0():
    """Two calls threading h0 against the Pallas kernel in interpret mode,
    itself given the same h0 (tests/test_kernels.py::test_rglru_carried_state)."""
    (jx, jr, ji, jlam, jh0), (x, r, i, lam, h0) = _both(_inputs(1, 128, 128, seed=1), "float32")
    y1, h1 = ref.rglru_reference(x[:, :64], r[:, :64], i[:, :64], lam, h0)
    y2, h2 = ref.rglru_reference(x[:, 64:], r[:, 64:], i[:, 64:], lam, h1)
    yp, hp = rglru_pallas(jx, jr, ji, jlam, h0=jh0, block_t=64, block_w=128, interpret=True)
    _close(yp, torch.cat([y1, y2], dim=1), (FP32_ATOL, 0.0))
    _close(hp, h2, (FP32_ATOL, 0.0))


def test_plain_softplus_has_no_threshold():
    """λ beyond 20, where torch's F.softplus would return λ itself."""
    (jx, jr, ji, jlam, _), (x, r, i, lam, _) = _both(_inputs(1, 16, 32, seed=2, lam_range=(15.0, 30.0)), "float32")
    yr, hr = jref.rglru_reference(jx, jr, ji, jlam)
    y, h = ref.rglru_reference(x, r, i, lam)
    _close(yr, y, (FP32_ATOL, 0.0))
    _close(hr, h, (FP32_ATOL, 0.0))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_h0", [False, True])
def test_model_scan_matches_jax_associative_scan(dtype, with_h0):
    (jx, jr, ji, jlam, jh0), (x, r, i, lam, h0) = _both(_inputs(2, 45, 64, seed=3), dtype)
    yr, hr = jrglru.rglru_scan(jx, jr, ji, jlam, jh0 if with_h0 else None)
    y, h = rglru.rglru_scan(x, r, i, lam, h0 if with_h0 else None)
    assert y.dtype == x.dtype and h.dtype == torch.float32
    _close(yr, y, TOL[dtype] if dtype == "bfloat16" else (FP32_ATOL, 0.0))
    _close(hr, h, (FP32_ATOL, 0.0))


def test_model_step_matches_jax():
    (jx, jr, ji, jlam, jh0), (x, r, i, lam, h0) = _both(_inputs(3, 1, 64, seed=4), "float32")
    yr, hr = jrglru.rglru_step(jh0, jx[:, 0], jr[:, 0], ji[:, 0], jlam)
    y, h = rglru.rglru_step(h0, x[:, 0], r[:, 0], i[:, 0], lam)
    _close(yr, y, (FP32_ATOL, 0.0))
    _close(hr, h, (FP32_ATOL, 0.0))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(5)
    xw = rng.normal(size=(2, 9 if not with_state else 1, 64)).astype(np.float32)
    w = rng.normal(size=(64, 4)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    state = rng.normal(size=(2, 3, 64)).astype(np.float32) if with_state else None
    out_ref = jrglru._causal_conv(jnp.asarray(xw), jnp.asarray(w), jnp.asarray(b),
                                  None if state is None else jnp.asarray(state))
    out = rglru._causal_conv(torch.from_numpy(xw), torch.from_numpy(w), torch.from_numpy(b),
                             None if state is None else torch.from_numpy(state))
    _close(out_ref, out, (FP32_ATOL, 0.0))


def test_dispatch_by_device_and_kernel_refuses_cpu_tensors():
    _, (x, r, i, lam, h0) = _both(_inputs(1, 8, 16, seed=6), "float32")
    y, h = ops.rglru(x, r, i, lam, h0)
    y_ref, h_ref = ref.rglru_reference(x, r, i, lam, h0)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    launches = rglru_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        rglru_kernel(x, r, i, lam, h0)
    assert rglru_kernel.launches == launches


# The CUDA kernel's chunked order (ref.rglru_chunked_reference): chunks of 1,
# 7 (ragged last chunk), 64 (ragged), T itself and more than T; chunks of 64
# in sub-chunks of 16 with the earlier chunks folded in 4 runs, chunks of 7
# in runs, and the kernel's own (chunks of 128 in sub-chunks of 16, 8 runs);
# each with a given h0, held at the kernel's tolerances against the
# sequential plain version, the JAX model's associative scan and the Pallas
# kernel in interpret mode.
CHUNKED_T, CHUNKED_W = 100, 64
CHUNKS = [(1, None, None), (7, None, None), (64, None, None), (CHUNKED_T, None, None), (CHUNKED_T + 28, None, None),
          (64, 16, 4), (7, None, 4), (128, 16, 8)]


def _chunked_case(dtype, seed, lam_range=(0.5, 4.0), long_memory=False, T=CHUNKED_T):
    arrs = list(_inputs(2, T, CHUNKED_W, seed=seed, lam_range=lam_range))
    if long_memory:  # r near 0 and x > 0: a → 1, and h grows over the whole sequence
        arrs[0] = np.abs(arrs[0])
        arrs[1] = arrs[1] * 0.01
    return _both(arrs, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk,sub,runs", CHUNKS)
def test_chunked_order_matches_plain_jax_and_pallas(chunk, sub, runs, dtype):
    (jx, jr, ji, jlam, jh0), (x, r, i, lam, h0) = _chunked_case(dtype, seed=7)
    y, h = ref.rglru_chunked_reference(x, r, i, lam, h0, chunk, sub, runs)
    assert y.dtype == x.dtype and y.shape == x.shape and h.dtype == torch.float32
    y_seq, h_seq = ref.rglru_reference(x, r, i, lam, h0)
    y_jax, h_jax = jrglru.rglru_scan(jx, jr, ji, jlam, jh0)
    y_pl, h_pl = rglru_pallas(jx, jr, ji, jlam, h0=jh0, interpret=True)
    for y_other, h_other in ((y_seq, h_seq), (y_jax, h_jax), (y_pl, h_pl)):
        _close(np.asarray(y_other.float() if isinstance(y_other, torch.Tensor) else y_other, np.float32),
               y, TOL[dtype])
        _close(np.asarray(h_other, np.float32), h, TOL["float32"])


@pytest.mark.parametrize("chunk,sub,runs", [(7, None, None), (7, None, 4), (64, 16, 4), (128, 16, 8),
                                            (1024, None, None)])
def test_chunked_order_long_memory(chunk, sub, runs):
    """λ in [-4, -1] and r in [0, 0.01]: a within 1e-3 of 1, so h carries
    across every chunk and grows (to ~10 by T = 1000, ragged). There the
    chunked order departs most from the sequential one, in fp32."""
    (jx, jr, ji, jlam, jh0), (x, r, i, lam, h0) = _chunked_case(
        "float32", seed=8, lam_range=(-4.0, -1.0), long_memory=True, T=1000)
    y, h = ref.rglru_chunked_reference(x, r, i, lam, h0, chunk, sub, runs)
    y_seq, h_seq = ref.rglru_reference(x, r, i, lam, h0)
    assert float(y_seq.abs().max()) > 5.0
    y_jax, h_jax = jrglru.rglru_scan(jx, jr, ji, jlam, jh0)
    for y_other, h_other in ((y_seq.numpy(), h_seq.numpy()), (y_jax, h_jax)):
        _close(y_other, y, TOL["float32"])
        _close(h_other, h, TOL["float32"])
