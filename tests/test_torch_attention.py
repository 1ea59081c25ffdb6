"""The port's models/attention.py against repro.models.attention on CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ref as kref
from repro_torch.models import attention

torch.set_num_threads(1)

JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ATOL = {"float32": 2e-6, "bfloat16": 1e-2}


def _both(rng, shape, dtype):
    a = jnp.asarray(rng.normal(size=shape), JD[dtype])
    return a, tensor_from_numpy(np.asarray(a))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", list(JD))
@pytest.mark.parametrize("T,H,K,causal,window,q_chunk", [
    (24, 4, 2, True, None, 2048),
    (24, 4, 4, False, None, 2048),
    (40, 4, 1, True, 8, 2048),
    (64, 4, 2, True, None, 16),   # chunked over query blocks
    (64, 6, 2, True, 12, 32),
])
def test_full_attention(T, H, K, causal, window, q_chunk, dtype):
    rng = np.random.default_rng(0)
    q, tq = _both(rng, (2, T, H, 16), dtype)
    k, tk = _both(rng, (2, T, K, 16), dtype)
    v, tv = _both(rng, (2, T, K, 16), dtype)
    r = ref.full_attention(q, k, v, causal=causal, window=window, q_chunk=q_chunk)
    t = attention.full_attention(tq, tk, tv, causal=causal, window=window, q_chunk=q_chunk)
    assert t.dtype == tq.dtype
    _close(r, t, ATOL[dtype])


def test_full_attention_rejects_ragged_chunks():
    x = torch.zeros(1, 40, 2, 16)
    with pytest.raises(ValueError, match="q_chunk"):
        attention.full_attention(x, x[:, :, :1], x[:, :, :1], q_chunk=16)


def _decode_inputs(dtype, B=3, S=48, H=8, K=2, D=16, seed=1):
    rng = np.random.default_rng(seed)
    q, tq = _both(rng, (B, 1, H, D), dtype)
    kc, tkc = _both(rng, (B, S, K, D), "bfloat16")  # the cache is bf16, as in the model
    vc, tvc = _both(rng, (B, S, K, D), "bfloat16")
    return (q, kc, vc), (tq, tkc, tvc)


@pytest.mark.parametrize("dtype", list(JD))
@pytest.mark.parametrize("cache_len", [1, 17, 48, "per-row"])
def test_decode_attention(cache_len, dtype):
    (q, kc, vc), (tq, tkc, tvc) = _decode_inputs(dtype)
    if cache_len == "per-row":
        lens = np.array([3, 48, 20], np.int32)
        r = ref.decode_attention(q, kc, vc, jnp.asarray(lens))
        t = attention.decode_attention(tq, tkc, tvc, torch.from_numpy(lens))
    else:
        r = ref.decode_attention(q, kc, vc, jnp.asarray(cache_len, jnp.int32))
        t = attention.decode_attention(tq, tkc, tvc, cache_len)
    assert t.dtype == tq.dtype and t.shape == tq.shape
    _close(r, t, ATOL[dtype])


@pytest.mark.parametrize("S,page", [(256, 64), (48, 16), (96, 32), (64, 64), (1500, 1500), (40, 40)])
def test_identity_page_view_equals_decode_attention(S, page):
    """The view the CUDA path hands to the paged kernel, through the plain
    paged_decode_reference, equals the CPU decode body: pages of 64 or of a
    smaller power of two, and one page per sequence where no power of two
    ≥ 16 divides S (whisper's 1500-slot cross cache)."""
    assert attention.identity_page_size(S) == page
    _, (tq, tkc, tvc) = _decode_inputs("float32", S=S)
    B, _, H, D = tq.shape
    K, n = tkc.shape[2], S // page
    pk, pv = tkc.view(B * n, page, K, D), tvc.view(B * n, page, K, D)
    assert pk.data_ptr() == tkc.data_ptr()  # a view, not a copy
    table = torch.arange(B * n, dtype=torch.int32).view(B, n)
    lens = torch.tensor([1, S // 2 + 3, S], dtype=torch.int32)
    out = kref.paged_decode_reference(tq[:, 0], pk, pv, table, lens).reshape(B, 1, H, D)
    torch.testing.assert_close(out, attention.decode_attention(tq, tkc, tvc, lens), atol=2e-6, rtol=0)


@pytest.mark.parametrize("S,page", [(40, 40), (8, 8), (1500, 1500), (0, None)])
def test_identity_page_size_falls_back_to_one_page(S, page):
    """No power of two ≥ 16 divides S: one page of S slots; S 0 has none."""
    if page is None:
        with pytest.raises(ValueError):
            attention.identity_page_size(S)
    else:
        assert attention.identity_page_size(S) == page


@pytest.mark.parametrize("ring,index", [(False, 5), (False, 15), (True, 21), (False, 30)])
def test_update_cache(ring, index):
    rng = np.random.default_rng(2)
    c, tc = _both(rng, (2, 16, 2, 8), "bfloat16")
    n, tn = _both(rng, (2, 1, 2, 8), "float32")
    r = ref.update_cache(c, n, jnp.asarray(index, jnp.int32), ring=ring)
    t = attention.update_cache(tc, tn, index, ring=ring)
    assert t is tc  # written in place
    _close(r, t, 0)


def test_sharded_decode_update_attend_single_device():
    (q, kc, vc), (tq, tkc, tvc) = _decode_inputs("float32")
    rng = np.random.default_rng(3)
    kn, tkn = _both(rng, (3, 1, 2, 16), "float32")
    vn, tvn = _both(rng, (3, 1, 2, 16), "float32")
    ro, rk, rv = ref.sharded_decode_update_attend(q, kc, vc, kn, vn, jnp.asarray(9, jnp.int32))
    to, tk, tv = attention.sharded_decode_update_attend(tq, tkc, tvc, tkn, tvn, 9)
    _close(ro, to, 2e-6)
    _close(rk, tk, 0)
    _close(rv, tv, 0)
