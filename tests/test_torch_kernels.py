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
from repro_torch.kernels import _build, decode_attention, ops, ref
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


# the split design of the paged-decode kernel: per-split partials, then combine
SPLIT_LENS = [16, 32, 64, None]  # None: one split over the whole capacity


def _split_len(split_len, page, maxp):
    return split_len or -(-maxp * page // 16) * 16


def _split_decode(targs, split_len):
    m, l, acc = ref.paged_decode_partials_reference(*targs, split_len)
    return ref.combine_partials_reference(m, l, acc, targs[0].dtype)


@pytest.mark.parametrize("split_len", SPLIT_LENS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,K,hd,P,page,maxp", PAGED_GRID)
def test_split_decode_matches_references(B, H, K, hd, P, page, maxp, dtype, split_len):
    """Partials then combine equal the port's and the reference's paged decode,
    at random lengths ≥ 1, at lengths on a split boundary (later splits left
    wholly empty) and at the full capacity."""
    split_len = _split_len(split_len, page, maxp)
    cap = maxp * page
    jargs, targs = _paged_inputs(B, H, K, hd, P, page, maxp, dtype)
    m, l, acc = ref.paged_decode_partials_reference(*targs, split_len)
    splits = -(-cap // split_len)
    assert m.shape == l.shape == (B, K, splits, H // K) and acc.shape == (B, K, splits, H // K, hd)
    assert m.dtype == l.dtype == acc.dtype == torch.float32
    for lengths in (np.asarray(jargs[4]), np.full(B, min(split_len, cap)), np.full(B, cap),
                    np.minimum(np.arange(1, B + 1) * split_len + 1, cap)):
        jargs[4] = jnp.asarray(lengths, jnp.int32)
        targs[4] = torch.tensor(lengths, dtype=torch.int32)
        out = _split_decode(targs, split_len)
        assert out.dtype == DTYPES[dtype][1] and out.shape == (B, H, hd)
        _close(np.asarray(ref.paged_decode_reference(*targs).float()), out, dtype)
        _close(jref.paged_decode_reference(*jargs), out, dtype)


@pytest.mark.parametrize("split_len", SPLIT_LENS)
def test_split_decode_matches_pallas_interpret_with_length_zero(split_len):
    """Lengths 0 (zeros, as the TPU kernel gives), 1, on a split boundary and
    past it, against the Pallas kernel in interpret mode; splits past a
    length are empty partials (m = −1e30, l = 0, acc = 0)."""
    B, H, K, hd, P, page, maxp = 4, 8, 4, 32, 12, 16, 4
    split_len = _split_len(split_len, page, maxp)
    jargs, targs = _paged_inputs(B, H, K, hd, P, page, maxp, "float32")
    lengths = [0, 1, min(split_len, 64), 33]
    jargs[4] = jnp.asarray(lengths, jnp.int32)
    targs[4] = torch.tensor(lengths, dtype=torch.int32)
    out = _split_decode(targs, split_len)
    _close(pallas_paged_decode(*jargs, interpret=True), out, "float32")
    assert (out[0] == 0).all()
    m, l, acc = ref.paged_decode_partials_reference(*targs, split_len)
    assert (m[0] == ref.NEG_INF).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    empty = torch.arange(m.shape[2]) * split_len >= torch.tensor(lengths)[:, None]  # (B, splits)
    assert (l.permute(0, 2, 1, 3)[empty] == 0).all()


@pytest.mark.parametrize("B,K,capacity", [
    (1, 1, 2048),   # recurrentgemma-9b's ring: one split per 16-token tile
    (1, 8, 256),    # qwen3-4b's cache at max_len 256
    (4, 8, 256), (3, 2, 384), (2, 1, 1600), (1, 1, 16), (1, 8, 64), (8, 8, 20000), (1, 1, 100),
    (64, 8, 4096),  # B·K alone fills the SMs: one split
])
def test_num_splits_plan(B, K, capacity):
    splits = decode_attention.num_splits(B, K, capacity)
    split_len = decode_attention.split_tokens(capacity, splits)
    tiles = -(-capacity // 16)
    assert split_len % 16 == 0 and split_len > 0
    assert (splits - 1) * split_len < capacity <= splits * split_len  # covers it, no split wholly outside
    if tiles * B * K >= 132:
        assert B * K * splits >= 132
    else:
        assert splits == tiles  # the capacity allows no more: one split per tile
    assert splits <= max(tiles, 1)


@pytest.mark.parametrize("B,T,H,K,hd,causal,window", FLASH_GRID + [(1, 512, 16, 1, 256, True, 128)])
def test_bf16_probabilities_fit_the_tolerance(B, T, H, K, hd, causal, window):
    """The tensor-core flash kernel rounds P to bf16 before P·V; the plain
    version with that rounding agrees with the fp32-P version within the bf16
    tolerance of tests/test_kernels.py::_tol, over the flash grid and an MQA
    G 16, hd 256 window case."""
    _, (tq, tk, tv) = _flash_inputs(B, T, H, K, hd, "bfloat16")
    exact = ref.mha_reference(tq, tk, tv, causal=causal, window=window)
    rounded = ref.mha_reference(tq, tk, tv, causal=causal, window=window, p_dtype=torch.bfloat16)
    assert rounded.dtype == torch.bfloat16
    _close(np.asarray(exact.float()), rounded, "bfloat16")
    assert not torch.equal(exact, rounded)  # the rounding is really applied


@pytest.mark.parametrize("name,group", [
    ("_ZN51_GLOBAL__N__18_flash_attention_cu20flash_fwd_mma_kernelILi256EEEvPK13__nv_bfloat16", "flash_attention kernel"),
    ("_ZN51_GLOBAL__N__18_flash_attention_cu16flash_fwd_kernelIfLi128EEEvPKT_", "flash_attention kernel"),
    ("_ZN48_GLOBAL__N__15_paged_decode_cu27paged_decode_partial_kernelI13__nv_bfloat16S1_Li256EEEv", "paged_decode kernel"),
    ("_ZN48_GLOBAL__N__15_paged_decode_cu27paged_decode_combine_kernelI13__nv_bfloat16Li128EEEv", "paged_decode kernel"),
])
def test_profiler_groups_take_the_new_kernels(name, group):
    from repro_torch.launch.profile_serve import group_of
    assert group_of(name) == group
