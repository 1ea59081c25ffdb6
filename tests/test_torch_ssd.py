"""The port's SSD pieces on the CPU against the reference: the sequential
oracle over the tests/test_kernels.py grid, the plain versions of the two
CUDA kernels composed with the inter-chunk scan against the Pallas kernel in
interpret mode and, with bf16 inputs, against the oracle and the JAX model,
the three-term bf16 split of the tensor-core kernels and the flip check
behind it, the model's chunked SSD (jnp port) and its one-token decode step.
The CUDA kernels themselves are held against the plain versions on the
card, in tests/test_torch_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunked_pallas
from repro.models import mamba2 as jmamba2
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import inter_chunk_scan, ssd_chunked_cuda
from repro_torch.launch import ssd_precision
from repro_torch.models import mamba2

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SSD_GRID = [(1, 128, 4, 32, 64, 32), (2, 256, 2, 64, 128, 64), (1, 64, 8, 16, 32, 64)]  # tests/test_kernels.py
# fp32: the JAX sweep's tolerance (the two sides differ in summation order).
# bf16: only the output y is rounded (both sides carry fp32 inside), so a
# one-ulp flip of a bf16 value (2^-8 relative) is the most they differ by.
TOL = {"float32": (5e-4, 1e-3), "bfloat16": (2e-2, 1e-2)}
# The model's chunked SSD: fp32 agrees to summation order; in bf16 both
# sides round the scores, the state and each product to bf16 at the same
# points, and differ only where the two libraries' bf16 matmuls accumulate
# in another order.
CHUNKED_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (6e-2, 2e-2)}


def _inputs(b, t, h, p, n, g=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    dA = (-np.abs(rng.normal(size=(b, t, h))) * 0.3).astype(np.float32)
    B_ = rng.normal(size=(b, t, g, n)).astype(np.float32)
    C_ = rng.normal(size=(b, t, g, n)).astype(np.float32)
    return x, dA, B_, C_


def _both(arrs, dtype):
    """numpy fp32 → (jax arrays in dtype, torch tensors in dtype); dA stays fp32."""
    jdt, tdt = DTYPES[dtype]
    x, dA, B_, C_ = arrs
    j = [jnp.asarray(x, jdt), jnp.asarray(dA), jnp.asarray(B_, jdt), jnp.asarray(C_, jdt)]
    t = [tensor_from_numpy(np.asarray(a)) for a in j]
    return j, t


def _close(expect, got, tol):
    atol, rtol = tol
    np.testing.assert_allclose(np.asarray(expect, np.float32), got.float().numpy(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,h,p,n,chunk", SSD_GRID)
def test_oracle_matches_reference(b, t, h, p, n, chunk, dtype):
    j, tt = _both(_inputs(b, t, h, p, n), dtype)
    yr, sr = jref.ssd_chunk_reference(*j)
    y, s = ref.ssd_chunk_reference(*tt)
    assert y.dtype == DTYPES[dtype][1] and s.dtype == torch.float32
    _close(yr.astype(jnp.float32), y, TOL[dtype])
    _close(sr, s, TOL["float32"])


@pytest.mark.parametrize("b,t,h,p,n,chunk", SSD_GRID + [(2, 70, 3, 16, 16, 32)])
def test_kernel_plain_versions_match_oracle(b, t, h, p, n, chunk):
    """ssd_states → inter-chunk scan → ssd_output, in their plain versions,
    is the chunked SSD: equal to the sequential oracle, ragged t included."""
    _, (x, dA, B_, C_) = _both(_inputs(b, t, h, p, n), "float32")
    y_diag, S = ref.ssd_states_reference(x, dA, B_, C_, chunk)
    nc = -(-t // chunk)
    assert y_diag.shape == (b, nc, h, chunk, p) and S.shape == (b, nc, h, p, n)
    H_in, H_last = inter_chunk_scan(S, dA, chunk)
    y = ref.ssd_output_reference(y_diag, dA, C_, H_in, x.dtype)
    yr, sr = ref.ssd_chunk_reference(x, dA, B_, C_)
    _close(yr.numpy(), y, TOL["float32"])
    _close(sr.numpy(), H_last, TOL["float32"])


@pytest.mark.parametrize("b,t,h,p,n,chunk", SSD_GRID + [(2, 70, 3, 16, 16, 32)])
def test_plain_versions_in_bf16_match_oracle(b, t, h, p, n, chunk):
    """The plain versions with bf16 inputs, as the tensor-core kernels take
    them (every fp32 operand as three bf16 terms, so nothing else is
    rounded), chained through the inter-chunk scan: y within
    tests/test_kernels.py::test_ssd_chunk_sweep's bf16 tolerance of the
    sequential oracle, the state within the fp32 one."""
    _, (x, dA, B_, C_) = _both(_inputs(b, t, h, p, n, seed=4), "bfloat16")
    y_diag, S = ref.ssd_states_reference(x, dA, B_, C_, chunk)
    H_in, H_last = inter_chunk_scan(S, dA, chunk)
    y = ref.ssd_output_reference(y_diag, dA, C_, H_in, x.dtype)
    yr, sr = ref.ssd_chunk_reference(x, dA, B_, C_)
    assert y.dtype == torch.bfloat16
    _close(yr.float().numpy(), y, TOL["bfloat16"])
    _close(sr.numpy(), H_last, TOL["float32"])


@pytest.mark.parametrize("b,t,h,p,n,chunk", [(2, 70, 4, 16, 8, 32), (1, 20, 2, 16, 8, 32), (1, 128, 4, 32, 64, 32)])
def test_plain_versions_in_bf16_match_jax_model_in_fp32(b, t, h, p, n, chunk):
    """The same chain against the JAX model's ssd_chunked on the same bf16
    inputs computed in fp32, which is what the kernels compute: within the
    bf16 tolerance (y is rounded to bf16). The JAX model's bf16 path rounds
    the scores, decay_states, H and state_decay to bf16 as well
    (src/repro/models/mamba2.py:75-99) and is further from the sequential
    oracle than the kernels are (python -m repro_torch.launch.ssd_precision)."""
    j, (x, dA, B_, C_) = _both(_inputs(b, t, h, p, n, seed=2), "bfloat16")
    f32 = [a.astype(jnp.float32) for a in j]
    yr, sr = jmamba2.ssd_chunked(*f32, chunk)
    y_diag, S = ref.ssd_states_reference(x, dA, B_, C_, chunk)
    H_in, H_last = inter_chunk_scan(S, dA, chunk)
    _close(yr, ref.ssd_output_reference(y_diag, dA, C_, H_in, x.dtype), TOL["bfloat16"])
    _close(sr, H_last, TOL["float32"])


def test_bf16x3_terms_sum_to_the_value():
    """The kernels' three-term split: each term is a bf16 value and the three
    sum to the fp32 value exactly, from 1e-13 to 1e13 in magnitude."""
    rng = np.random.default_rng(5)
    v = rng.normal(size=200_000) * np.exp(rng.uniform(-30, 30, size=200_000))
    v = torch.from_numpy(np.concatenate([v, [0.0, 1.0, -3.0, 65504.0]]).astype(np.float32))
    terms = ref.bf16x3(v)
    for term in terms:
        assert torch.equal(term.bfloat16().float(), term)
    assert torch.equal(sum(t.double() for t in terms), v.double())


@pytest.mark.parametrize("b,t,h,p,n,chunk", SSD_GRID + [(1, 300, 2, 64, 128, 100)])
def test_three_term_operands_do_not_flip(b, t, h, p, n, chunk):
    """The flip check: with the scores and x ⊙ decay as three bf16 terms (the
    kernels' operands), y_diag moves by no more than the fp32 tolerance when
    C·Bᵀ is summed in float64 instead of float32, and y_diag and S when the
    cumsum of dA is added up in the kernels' scan order."""
    x, dA, B_, C_ = ssd_precision.inputs(b, t, h, p, n)
    y0, S0 = ssd_precision.states(x, dA, B_, C_, chunk, "bf16x3")
    y1, _ = ssd_precision.states(x, dA, B_, C_, chunk, "bf16x3", cb_f64=True)
    y2, S2 = ssd_precision.states(x, dA, B_, C_, chunk, "bf16x3", scan_order=True)
    for a, b_ in ((y0, y1), (y0, y2), (S0, S2)):
        assert ssd_precision.spread(a, b_, TOL["float32"]) <= 1.0


def test_rounding_the_scores_to_bf16_would_flip_past_the_tolerance():
    """Why the kernels split instead of rounding where the JAX model rounds
    (the scores, mamba2.py:75): one C·Bᵀ summed in another order rounds some
    scores to the neighbouring bf16 value, which moves y_diag far past its
    fp32 tolerance (147x at this shape)."""
    x, dA, B_, C_ = ssd_precision.inputs(2, 256, 2, 64, 128)
    y0, _ = ssd_precision.states(x, dA, B_, C_, 64, "bf16")
    y1, _ = ssd_precision.states(x, dA, B_, C_, 64, "bf16", cb_f64=True)
    assert ssd_precision.spread(y0, y1, TOL["float32"]) > 10


def test_kernel_plain_versions_match_pallas_interpret():
    b, t, h, p, n, chunk = 1, 128, 4, 32, 64, 32
    j, (x, dA, B_, C_) = _both(_inputs(b, t, h, p, n, seed=1), "float32")
    yp, sp = ssd_chunked_pallas(*j, chunk, interpret=True)
    y_diag, S = ref.ssd_states_reference(x, dA, B_, C_, chunk)
    H_in, H_last = inter_chunk_scan(S, dA, chunk)
    _close(yp, ref.ssd_output_reference(y_diag, dA, C_, H_in, x.dtype), TOL["float32"])
    _close(sp, H_last, TOL["float32"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,h,p,n,g,chunk", [
    (2, 70, 4, 16, 8, 1, 32),   # ragged: 70 = 2 chunks of 32 + 6
    (1, 20, 2, 16, 8, 1, 32),   # t under the chunk (the model passes min(chunk, t))
    (1, 64, 4, 8, 8, 2, 16),    # two groups
])
def test_model_ssd_chunked_matches_reference(b, t, h, p, n, g, chunk, dtype):
    j, tt = _both(_inputs(b, t, h, p, n, g=g, seed=2), dtype)
    yr, sr = jmamba2.ssd_chunked(*j, chunk)
    y, s = mamba2.ssd_chunked(*tt, chunk)
    assert y.shape == (b, t, h, p) and y.dtype == DTYPES[dtype][1] and s.dtype == DTYPES[dtype][1]
    _close(yr.astype(jnp.float32), y, CHUNKED_TOL[dtype])
    _close(sr.astype(jnp.float32), s, CHUNKED_TOL[dtype])


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_reference(g):
    rng = np.random.default_rng(3)
    b, h, p, n = 2, 4, 8, 16
    state = rng.normal(size=(b, h, p, n)).astype(np.float32)
    x = rng.normal(size=(b, h, p)).astype(np.float32)
    dA = (-np.abs(rng.normal(size=(b, h))) * 0.3).astype(np.float32)
    B_, C_ = (rng.normal(size=(b, g, n)).astype(np.float32) for _ in range(2))
    yr, sr = jmamba2.ssd_decode_step(*(jnp.asarray(a) for a in (state, x, dA, B_, C_)))
    y, s = mamba2.ssd_decode_step(*(torch.from_numpy(a) for a in (state, x, dA, B_, C_)))
    _close(yr, y, (1e-5, 1e-5))
    _close(sr, s, (1e-5, 1e-5))


def test_softplus_matches_jax_at_the_model_inputs():
    """dt + dt_bias with dt_bias = -2 (the init) and beyond F.softplus's
    threshold of 20."""
    v = np.concatenate([np.linspace(-12, 8, 201), [19.5, 20.0, 20.5, 25.0, 40.0]]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jax.nn.softplus(jnp.asarray(v))),
                               mamba2.softplus(torch.from_numpy(v)).numpy(), rtol=1e-6, atol=0)


def test_ops_dispatch_by_device():
    """CPU tensors go to the oracle; the CUDA wrapper refuses them."""
    _, (x, dA, B_, C_) = _both(_inputs(1, 40, 2, 16, 8), "float32")
    y, s = ops.ssd_scan(x, dA, B_, C_, 32)
    yr, sr = ref.ssd_chunk_reference(x, dA, B_, C_)
    assert torch.equal(y, yr) and torch.equal(s, sr)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunked_cuda(x, dA, B_, C_, 32)
