"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the reference package, so it also runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch import dist as rdist
from repro_torch.configs import get_config
from repro_torch.dist.perf import PerfConfig, perf_context
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import paged_decode_attention, paged_decode_partials
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import inter_chunk_scan, ssd_chunked_cuda, ssd_output, ssd_states
from repro_torch.kernels import ops
from repro_torch.launch import grad_check
from repro_torch.models import attention, build_model, moe, transformer
from repro_torch.training import compression
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import TrainConfig, init_state, make_train_step
from repro_torch.tree import leaves_with_paths

torch.set_num_threads(1)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the grids of tests/test_kernels.py, plus the serving shapes of qwen3-4b,
# the head_dim-256 shapes of recurrentgemma-9b and the MoE configs' head shapes
FLASH_GRID = [
    (2, 256, 8, 4, 64, True, None),
    (1, 384, 4, 1, 128, True, None),
    (2, 256, 8, 8, 64, False, None),
    (1, 512, 4, 2, 64, True, 128),
    (1, 200, 4, 2, 64, True, None),
    (1, 256, 2, 2, 32, True, None),
    (1, 128, 32, 8, 128, True, None),
    # head_dim 256, recurrentgemma-9b's MQA (16 query heads on 1 kv head):
    # causal, ragged, and windowed with T > window
    (1, 256, 16, 1, 256, True, None),
    (2, 200, 16, 1, 256, True, None),
    (1, 512, 16, 1, 256, True, 128),
    # granite-moe-1b-a400m (hd 64, 16 query heads on 8 kv heads) and
    # qwen2-moe-a2.7b (hd 128, 16 on 16: no grouping) at prompt 128, and ragged
    (1, 128, 16, 8, 64, True, None),
    (1, 128, 16, 16, 128, True, None),
    (2, 77, 16, 8, 64, True, None),
    (2, 77, 16, 16, 128, True, None),
]
PAGED_GRID = [(2, 8, 4, 64, 16, 128, 4), (4, 4, 1, 128, 32, 128, 6), (2, 16, 8, 64, 16, 256, 3),
              (1, 32, 8, 128, 4, 64, 4), (2, 16, 1, 256, 16, 64, 6), (1, 16, 1, 256, 32, 64, 32),
              (1, 16, 8, 64, 4, 64, 4), (1, 16, 16, 128, 4, 64, 4), (3, 16, 8, 64, 12, 64, 4),
              (3, 16, 16, 128, 12, 64, 4)]


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


# the kernels' checks draw inputs whose outputs are O(1) (grad_check.shifted_qkv):
# from N(0, 1) ones the outputs are ~√(e/S), a few bf16 tolerances wide
def _qkv(rng, B, T, H, K, hd, dtype, device):
    return grad_check.shifted_qkv(rng, T, T, DTYPES[dtype], device, H=H, K=K, hd=hd, B=B)


def _pages(rng, B, H, K, hd, P, page, dtype, device):
    return grad_check.shifted_pages(rng, B, H, K, hd, P, page, DTYPES[dtype], device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,H,K,hd,causal,window", FLASH_GRID)
def test_flash_kernel_matches_plain(cuda, B, T, H, K, hd, causal, window, dtype):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, B, T, H, K, hd, dtype, cuda)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(ref.mha_reference(q, k, v, causal=causal, window=window), out, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,K,hd,P,page,maxp", PAGED_GRID)
def test_paged_kernel_matches_plain(cuda, B, H, K, hd, P, page, maxp, dtype):
    rng = np.random.default_rng(0)
    q, pk, pv = _pages(rng, B, H, K, hd, P, page, dtype, cuda)
    pt = torch.from_numpy(rng.integers(0, P, size=(B, maxp)).astype(np.int32)).to(cuda)
    lengths = torch.from_numpy(rng.integers(1, maxp * page, size=(B,)).astype(np.int32)).to(cuda)
    out = paged_decode_attention(q, pk, pv, pt, lengths)
    torch.cuda.synchronize()
    _close(ref.paged_decode_reference(q, pk, pv, pt, lengths), out, dtype)


@pytest.mark.gpu
def test_kernels_read_strided_views(cuda):
    """q/k/v as views into one fused tensor (no copy), ragged lengths, length 0."""
    rng = np.random.default_rng(1)
    mu = grad_check.shift_mean(64)  # q, k and v drawn as _qkv draws them, in one tensor
    means = torch.tensor([mu] * 8 + [-mu] * 2 + [1.0] * 2).view(1, 1, 12, 1)
    qkv = (torch.from_numpy(rng.normal(size=(2, 70, 12, 64)).astype(np.float32)) + means).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    _close(ref.mha_reference(q, k, v), flash_attention(q, k, v), "bfloat16")
    q, pk, pv = _pages(rng, 3, 8, 2, 64, 10, 16, "float32", cuda)
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


# (b, t, h, p, n, chunk): the grid of tests/test_kernels.py::test_ssd_chunk_sweep,
# then chunks of 100 and 256, ragged t, t under the chunk, p 128 with n 256,
# and the serving shape of mamba2-1.3b
SSD_GRID = [
    (1, 128, 4, 32, 64, 32), (2, 256, 2, 64, 128, 64), (1, 64, 8, 16, 32, 64),
    (1, 300, 2, 64, 128, 100), (2, 70, 3, 16, 16, 32), (1, 200, 2, 128, 256, 256),
    (1, 1024, 64, 64, 128, 256),
]
# the JAX sweep's tolerance in fp32; in bf16 the inputs and y are bf16
SSD_TOL = {"float32": (5e-4, 1e-3), "bfloat16": (2e-2, 1e-2)}


def _ssd_inputs(rng, b, t, h, p, n, dtype, device):
    x = _randn(rng, (b, t, h, p), dtype, device)
    dA = -torch.from_numpy(np.abs(rng.normal(size=(b, t, h))).astype(np.float32)).to(device) * 0.3
    B_, C_ = (_randn(rng, (b, t, 1, n), dtype, device) for _ in range(2))
    return x, dA, B_, C_


def _ssd_close(expect, out, dtype):
    atol, rtol = SSD_TOL[dtype]
    np.testing.assert_allclose(expect.float().cpu().numpy(), out.float().cpu().numpy(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,h,p,n,chunk", SSD_GRID)
def test_ssd_kernels_match_plain(cuda, b, t, h, p, n, chunk, dtype):
    x, dA, B_, C_ = _ssd_inputs(np.random.default_rng(0), b, t, h, p, n, dtype, cuda)
    y_diag, S = ssd_states(x, dA, B_, C_, chunk)
    yd_ref, S_ref = ref.ssd_states_reference(x, dA, B_, C_, chunk)
    torch.cuda.synchronize()
    _ssd_close(yd_ref, y_diag, "float32")  # fp32 outputs from the same inputs
    _ssd_close(S_ref, S, "float32")
    H_in, _ = inter_chunk_scan(S_ref, dA, chunk)
    y = ssd_output(yd_ref, dA, C_, H_in, x.dtype)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.shape == x.shape
    _ssd_close(ref.ssd_output_reference(yd_ref, dA, C_, H_in, x.dtype), y, dtype)
    y, H_last = ssd_chunked_cuda(x, dA, B_, C_, chunk)
    y_ref, H_ref = ref.ssd_chunk_reference(x, dA, B_, C_)
    torch.cuda.synchronize()
    assert H_last.dtype == torch.float32
    _ssd_close(y_ref, y, dtype)
    _ssd_close(H_ref, H_last, "float32")


# the bf16 tensor-core kernels' tile edges: (b, t, h, p, n, chunk) with t not
# a multiple of 16 or of the 64-wide j-tile, chunks of 100 and 45, n of 16,
# 32, 24 (not a multiple of 16) and 256, p of 16 to 128
SSD_EDGES = [
    (1, 77, 2, 16, 16, 32), (1, 130, 2, 32, 32, 100), (2, 200, 2, 64, 256, 256),
    (1, 333, 2, 128, 24, 64), (1, 45, 3, 64, 128, 45), (1, 260, 2, 128, 256, 100),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,p,n,chunk", SSD_EDGES)
def test_ssd_bf16_tensor_core_edges(cuda, b, t, h, p, n, chunk):
    test_ssd_kernels_match_plain(cuda, b, t, h, p, n, chunk, "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [20, 10])
def test_ssd_kernels_read_views_of_xbc(cuda, dtype, n):
    """x, B and C as views into one fused tensor, as the model's xBC (no
    copy): the B/C rows end inside a 16-byte piece, and at n = 10 the rows of
    H_in do not start on 16 bytes."""
    rng = np.random.default_rng(5)
    b, t, h, p, chunk = 1, 150, 2, 32, 64
    xbc = _randn(rng, (b, t, h * p + 2 * 24), dtype, cuda)
    x = xbc[..., :h * p].view(b, t, h, p)
    B_ = xbc[..., h * p:h * p + n].view(b, t, 1, n)
    C_ = xbc[..., h * p + 24:h * p + 24 + n].view(b, t, 1, n)
    dA = -torch.from_numpy(np.abs(rng.normal(size=(b, t, h))).astype(np.float32)).to(cuda) * 0.3
    y_diag, S = ssd_states(x, dA, B_, C_, chunk)
    yd_ref, S_ref = ref.ssd_states_reference(x, dA, B_, C_, chunk)
    _ssd_close(yd_ref, y_diag, "float32")
    _ssd_close(S_ref, S, "float32")
    y, H_last = ssd_chunked_cuda(x, dA, B_, C_, chunk)
    y_ref, H_ref = ref.ssd_chunk_reference(x, dA, B_, C_)
    _ssd_close(y_ref, y, dtype)
    _ssd_close(H_ref, H_last, "float32")


@pytest.mark.gpu
def test_ssd_bf16_rejects_misaligned_rows(cuda):
    """The bf16 kernels copy rows in 16-byte pieces: a view whose rows do not
    start on 16 bytes raises; fp32 takes it."""
    rng = np.random.default_rng(6)
    b, t, h, p, n = 1, 64, 2, 16, 16
    x, dA, B_, C_ = _ssd_inputs(rng, b, t, h, p, n, "bfloat16", cuda)
    x_off = _randn(rng, (b, t, h, p + 8), "bfloat16", cuda)[..., 1:p + 1]
    with pytest.raises(ValueError, match="16 bytes"):
        ssd_states(x_off, dA, B_, C_, 32)
    B_odd = _randn(rng, (b, t, 1, n + 1), "bfloat16", cuda)[..., :n]
    with pytest.raises(ValueError, match="16 bytes"):
        ssd_states(x, dA, B_odd, C_, 32)
    y_diag, S = ssd_states(x, dA, B_, C_, 32)
    H_in, _ = inter_chunk_scan(S, dA, 32)
    with pytest.raises(ValueError, match="16 bytes"):
        ssd_output(y_diag, dA, B_odd, H_in, torch.bfloat16)
    x32 = _randn(rng, (b, t, h, p + 8), "float32", cuda)[..., 1:p + 1]
    B32 = _randn(rng, (b, t, 1, n + 1), "float32", cuda)[..., :n]
    C32 = _randn(rng, (b, t, 1, n), "float32", cuda)
    y_diag, S = ssd_states(x32, dA, B32, C32, 32)
    yd_ref, S_ref = ref.ssd_states_reference(x32, dA, B32, C32, 32)
    _ssd_close(yd_ref, y_diag, "float32")
    _ssd_close(S_ref, S, "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_chunked_replays_in_cuda_graph(cuda, dtype):
    """One capture and two replays of ssd_chunked_cuda (both kernels and the
    inter-chunk scan) give its eager result bit for bit."""
    x, dA, B_, C_ = _ssd_inputs(np.random.default_rng(7), 1, 300, 4, 64, 128, dtype, cuda)
    first, out = _graph_replay(lambda: ssd_chunked_cuda(x, dA, B_, C_, 256))
    assert all(torch.equal(a, b) for a, b in zip(first, out))


@pytest.mark.gpu
def test_ssd_kernel_rejects_cpu_tensors_and_groups(cuda):
    rng = np.random.default_rng(3)
    x, dA, B_, C_ = _ssd_inputs(rng, 1, 64, 2, 16, 16, "float32", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunked_cuda(x, dA, B_, C_, 32)
    x, dA = x.to(cuda), dA.to(cuda)
    B2, C2 = (_randn(rng, (1, 64, 2, 16), "float32", cuda) for _ in range(2))
    with pytest.raises(ValueError, match="g == 1"):
        ssd_chunked_cuda(x, dA, B2, C2, 32)


@pytest.mark.gpu
def test_mamba2_full_width_on_card_matches_cpu(cuda):
    """mamba2-1.3b at full width, 2 layers, fp32: a ragged 300-token prefill
    (chunks of 256 and 44) and 2 decode steps, card (SSD kernels) against
    CPU (the jnp port). Both sides are fp32; the logits differ only in
    summation order, and the bf16 conv cache may round a last-ulp
    difference to a neighbouring value."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=2, dtype="float32")
    cpu = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, 300))).long()
    with torch.no_grad():
        lc, cc = cpu.prefill(prompt)
        lg, cg = gpu.prefill(prompt.to(cuda))
        steps = [(lc, lg)]
        for tok in (5, 7):
            lc, cc = cpu.decode_step(cc, torch.tensor([[tok]]))
            lg, cg = gpu.decode_step(cg, torch.tensor([[tok]], device=cuda))
            steps.append((lc, lg))
    for lc, lg in steps:
        lg = lg.cpu()
        assert torch.isfinite(lg).all()
        np.testing.assert_allclose(lc[:, :cfg.vocab].numpy(), lg[:, :cfg.vocab].numpy(), atol=5e-3, rtol=0)
        assert int(lc.argmax()) == int(lg.argmax())


@pytest.mark.gpu
def test_decode_over_the_ring_view(cuda):
    """recurrentgemma-9b's decode: 16 query heads on 1 kv head of 256 over a
    2048-slot bf16 ring (identity-page view, page 64), at lengths up to the
    full ring, card (paged-decode kernel) against the CPU body."""
    rng = np.random.default_rng(4)
    kc, vc = (_randn(rng, (1, 2048, 1, 256), "bfloat16", "cpu") for _ in range(2))
    q = _randn(rng, (1, 1, 16, 256), "float32", "cpu")
    for valid in (1, 100, 2047, 2048):
        out = attention.decode_attention(q.to(cuda), kc.to(cuda), vc.to(cuda), valid)
        _close(attention.decode_attention(q, kc, vc, valid), out, "float32")


# whisper-small's attention shapes (12 query heads on 12 kv heads of 64):
# the encoder's self-attention over its 1500 frames, and cross-attention of
# a 128-token prompt over them, both non-causal
WHISPER_FLASH = grad_check.WHISPER_SHAPES


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("T,S", WHISPER_FLASH)
def test_flash_kernel_at_whisper_shapes(cuda, T, S, dtype):
    """On ``grad_check.shifted_qkv`` inputs: outputs O(1), and a key past S
    left unmasked would take a large share of the softmax."""
    rng = np.random.default_rng(11)
    q, k, v = grad_check.shifted_qkv(rng, T, S, DTYPES[dtype], cuda)
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(ref.mha_reference(q, k, v, causal=False), out, dtype)


@pytest.mark.gpu
def test_decode_attention_over_whisper_cross_cache(cuda, monkeypatch):
    """whisper's decode cross-attention: ``models.attention.decode_attention``
    over a (1, 1500, 12, 64) bf16 cache, which no power-of-two page divides,
    runs the paged-decode kernel over one page of 1500 slots, the cache
    itself (no copy), card against the CPU body at every length class, on
    ``grad_check.shifted_qkv`` inputs (outputs O(1))."""
    rng = np.random.default_rng(12)
    _, kc, vc = grad_check.shifted_qkv(rng, 1, 1500, torch.bfloat16, "cpu")
    kg, vg = kc.to(cuda), vc.to(cuda)
    seen, paged = [], ops.paged_decode

    def spy(q, pk, pv, table, lengths):
        seen.append((pk.data_ptr() == kg.data_ptr(), pv.data_ptr() == vg.data_ptr(), tuple(pk.shape)))
        return paged(q, pk, pv, table, lengths)

    monkeypatch.setattr(ops, "paged_decode", spy)
    launches = paged_decode_attention.launches
    for dtype in DTYPES:
        q = grad_check.shifted_qkv(rng, 1, 1, DTYPES[dtype], "cpu")[0]
        for valid in (1, 64, 1499, 1500):
            out = attention.decode_attention(q.to(cuda), kg, vg, valid)
            _close(attention.decode_attention(q, kc, vc, valid), out, dtype)
    assert paged_decode_attention.launches == launches + 8
    assert seen == [(True, True, (1, 1500, 12, 64))] * 8


@pytest.mark.gpu
def test_whisper_full_width_on_card_matches_cpu(cuda):
    """whisper-small at full width, 2 encoder and 2 decoder layers, fp32:
    seeded frames over all 1500 positions, a 64-token prefill and 2 decode
    steps, card (flash in the encoder, self- and cross-attention; paged
    decode over the self and the 1500-slot cross caches) against CPU (the
    plain path). Weights are drawn on the card and copied to the CPU. Both
    sides are fp32 but for the bf16 caches, whose rounding of a last-ulp
    difference can move a logit by far less than the tolerance."""
    cfg = dataclasses.replace(get_config("whisper-small"), n_layers=2, enc_layers=2, dtype="float32")
    gpu = build_model(cfg, cuda).init(torch.Generator(device=cuda).manual_seed(0))
    cpu = build_model(cfg, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, 64))).long()
    frames = torch.from_numpy(rng.normal(size=(1, cfg.enc_len, cfg.d_model)).astype(np.float32))
    flash, paged = flash_attention.launches, paged_decode_attention.launches
    with torch.no_grad():
        lc, cc = cpu.prefill(prompt, frames, pad_to=128)
        lg, cg = gpu.prefill(prompt.to(cuda), frames.to(cuda), pad_to=128)
        steps = [(lc, lg)]
        for tok in (5, 7):
            lc, cc = cpu.decode_step(cc, torch.tensor([[tok]]))
            lg, cg = gpu.decode_step(cg, torch.tensor([[tok]], device=cuda))
            steps.append((lc, lg))
    assert flash_attention.launches - flash == cfg.enc_layers + 2 * cfg.n_layers
    assert paged_decode_attention.launches - paged == 2 * 2 * cfg.n_layers
    for lc, lg in steps:
        lg = lg.cpu()
        assert torch.isfinite(lg).all()
        np.testing.assert_allclose(lc[:, :cfg.vocab].numpy(), lg[:, :cfg.vocab].numpy(), atol=5e-3, rtol=0)
        assert int(lc.argmax()) == int(lg.argmax())


# (B, T, W): tests/test_kernels.py::test_rglru_sweep, a ragged T and W, T
# under one chunk of 128 steps, and the serving shape of recurrentgemma-9b;
# then the chunked kernel's edges: T one under and one over a chunk, a
# ragged last chunk with W past a 32-channel tile (rows not 16-byte
# aligned: plain loads), T 8192, and W 4100 over 129 tiles
RGLRU_GRID = [(2, 128, 256), (1, 256, 512), (1, 300, 200), (3, 5, 7), (1, 2048, 4096),
              (2, 127, 128), (2, 129, 384), (1, 1000, 130), (1, 8192, 1024), (1, 97, 4100)]


def _rglru_inputs(rng, B, T, W, dtype, device, long_memory=False):
    """λ in [0.5, 4] as the model's initialisation, where ∏a over a chunk of
    128 steps is 0 in fp32; with ``long_memory``, test_torch_rglru.py's long
    memory: λ in [−4, −1], r ≤ 0.01 and x > 0, a within 0.025 of 1 and ∏a
    over a chunk 0.2–0.9, as with trained weights."""
    x = _randn(rng, (B, T, W), dtype, device)
    r, i = (torch.from_numpy(rng.uniform(size=(B, T, W)).astype(np.float32)).to(device, DTYPES[dtype])
            for _ in range(2))
    lam = torch.from_numpy(rng.uniform(*((-4.0, -1.0) if long_memory else (0.5, 4.0)),
                                       size=(W,)).astype(np.float32)).to(device)
    if long_memory:
        x, r = x.abs(), r * 0.01
    return x, r, i, lam


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,W", RGLRU_GRID)
def test_rglru_kernel_matches_plain(cuda, B, T, W, dtype):
    x, r, i, lam = _rglru_inputs(np.random.default_rng(0), B, T, W, dtype, cuda)
    y, h = rglru_scan(x, r, i, lam.to(DTYPES[dtype]))
    y_ref, h_ref = ref.rglru_reference(x, r, i, lam.to(DTYPES[dtype]))
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.shape == x.shape and h.dtype == torch.float32 and h.shape == (B, W)
    _close(y_ref, y, dtype)
    _close(h_ref, h, "float32")  # fp32 on both sides, from the same rounded inputs


@pytest.mark.gpu
def test_rglru_kernel_carries_state_and_reads_views(cuda):
    """Two calls threading h0 equal one call (tests/test_kernels.py::
    test_rglru_carried_state); x, r, i as strided views of one tensor."""
    rng = np.random.default_rng(1)
    xri = _randn(rng, (1, 128, 3, 128), "float32", cuda)
    x, r, i = xri[:, :, 0], torch.sigmoid(xri[:, :, 1]), torch.sigmoid(xri[:, :, 2])
    lam = torch.linspace(0.5, 4.0, 128, device=cuda)
    y1, h1 = rglru_scan(x[:, :64], r[:, :64], i[:, :64], lam)
    y2, h2 = rglru_scan(x[:, 64:], r[:, 64:], i[:, 64:], lam, h0=h1)
    y_ref, h_ref = ref.rglru_reference(x, r, i, lam)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y_ref.cpu().numpy(), torch.cat([y1, y2], 1).cpu().numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(h_ref.cpu().numpy(), h2.cpu().numpy(), atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_kernel_takes_h0_over_a_batch(cuda, dtype):
    """B 3 with a given h0, each sequence over 4 chunks with a ragged last."""
    rng = np.random.default_rng(9)
    x, r, i, lam = _rglru_inputs(rng, 3, 200, 300, dtype, cuda)
    h0 = _randn(rng, (3, 300), "float32", cuda)
    y, h = rglru_scan(x, r, i, lam, h0)
    y_ref, h_ref = ref.rglru_reference(x, r, i, lam, h0)
    torch.cuda.synchronize()
    _close(y_ref, y, dtype)
    _close(h_ref, h, "float32")


# (B, T, W, h0 given) in long memory: T 8192 is 64 chunks, so the last one
# folds 8 runs of 8; B 3 with h0 over 8 chunks, W past a tile
RGLRU_LONG = [(1, 8192, 256, False), (3, 1000, 300, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,W,given_h0", RGLRU_LONG)
def test_rglru_kernel_carries_long_memory(cuda, B, T, W, given_h0, dtype):
    """a → 1: the aggregates of every earlier chunk, and h0, reach the last
    chunk, so runs folded out of order, skipped or read before they are
    published, or h0 dropped past chunk 0, show as errors far past the
    tolerance (with λ in [0.5, 4] they are multiplied by 0)."""
    rng = np.random.default_rng(12)
    x, r, i, lam = _rglru_inputs(rng, B, T, W, dtype, cuda, long_memory=True)
    h0 = _randn(rng, (B, W), "float32", cuda) if given_h0 else None
    y, h = rglru_scan(x, r, i, lam, h0)
    y_ref, h_ref = ref.rglru_reference(x, r, i, lam, h0)
    torch.cuda.synchronize()
    assert float(y_ref.float().abs().max()) > 5.0  # h grows over the whole sequence
    if given_h0:  # h0 moves the last chunk past the tolerance
        y_zero, _ = ref.rglru_reference(x, r, i, lam)
        moved = (y_ref.float() - y_zero.float())[:, -128:].abs() - 1e-2 * y_ref.float()[:, -128:].abs()
        assert float(moved.max()) > _tol(dtype)
    _close(y_ref, y, dtype)
    _close(h_ref, h, "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_kernel_reads_ragged_views(cuda, dtype):
    """x, r, i as views of one (2, 150, 3, 256) tensor cut to W 130: rows
    16-byte aligned, so the copies run, and the last piece of each row holds
    2 channels of 8 (bf16) or 4 (fp32)."""
    rng = np.random.default_rng(10)
    xri = _randn(rng, (2, 150, 3, 256), dtype, cuda)
    xri[:, :, 1:] = torch.sigmoid(xri[:, :, 1:])
    x, r, i = (xri[:, :, k, :130] for k in range(3))
    lam = torch.linspace(0.5, 4.0, 130, device=cuda)
    y, h = rglru_scan(x, r, i, lam)
    y_ref, h_ref = ref.rglru_reference(x, r, i, lam)
    torch.cuda.synchronize()
    _close(y_ref, y, dtype)
    _close(h_ref, h, "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_kernel_is_bit_identical_and_replays_in_cuda_graph(cuda, dtype):
    """The chunks fold in a fixed order, never in the order they finish: two
    eager calls are bit-equal, and one capture with two replays gives the
    eager result bit for bit (the workspace comes from the graph's pool). In
    long memory over 16 chunks, where the order of the folds shows."""
    rng = np.random.default_rng(11)
    x, r, i, lam = _rglru_inputs(rng, 2, 2048, 1024, dtype, cuda, long_memory=True)
    h0 = _randn(rng, (2, 1024), "float32", cuda)
    y1, h1 = rglru_scan(x, r, i, lam, h0)
    y2, h2 = rglru_scan(x, r, i, lam, h0)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    first, out = _graph_replay(lambda: torch.cat([t.float().flatten() for t in rglru_scan(x, r, i, lam, h0)]))
    assert torch.equal(first, out)


@pytest.mark.gpu
def test_rglru_kernel_rejects_cpu_tensors_and_strided_width(cuda):
    rng = np.random.default_rng(2)
    x, r, i, lam = _rglru_inputs(rng, 1, 8, 16, "float32", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan(x, r, i, lam)
    x, r, i, lam = (t.to(cuda) for t in (x, r, i, lam))
    with pytest.raises(ValueError, match="unit stride"):
        rglru_scan(x.transpose(1, 2), r.transpose(1, 2), i.transpose(1, 2), torch.ones(8, device=cuda))


@pytest.mark.gpu
def test_griffin_full_width_on_card_matches_cpu(cuda):
    """recurrentgemma-9b at full width, 3 layers (one RRA group), fp32: a
    40-token prefill and 2 decode steps, card (RG-LRU, flash and paged-decode
    kernels) against CPU (the plain path). Weights are drawn on the card and
    copied to the CPU. Both sides are fp32; the logits differ in summation
    order, and the bf16 caches may round a last-ulp difference to a
    neighbouring value."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=3, dtype="float32")
    gpu = build_model(cfg, cuda).init(torch.Generator(device=cuda).manual_seed(0))
    cpu = build_model(cfg, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, 40))).long()
    with torch.no_grad():
        lc, cc = cpu.prefill(prompt)
        lg, cg = gpu.prefill(prompt.to(cuda))
        steps = [(lc, lg)]
        for tok in (5, 7):
            lc, cc = cpu.decode_step(cc, torch.tensor([[tok]]))
            lg, cg = gpu.decode_step(cg, torch.tensor([[tok]], device=cuda))
            steps.append((lc, lg))
    for lc, lg in steps:
        lg = lg.cpu()
        assert torch.isfinite(lg).all()
        np.testing.assert_allclose(lc[:, :cfg.vocab].numpy(), lg[:, :cfg.vocab].numpy(), atol=5e-3, rtol=0)
        assert int(lc.argmax()) == int(lg.argmax())


# the redesigned attention kernels at their edges.
# paged decode: (B, H, K, hd, P, page, maxp, split tokens, identity page
# table): recurrentgemma-9b's ring view, B 3 x K 2 over a random page table, G 64
PAGED_EDGES = [(1, 16, 1, 256, 32, 64, 32, 16, True), (3, 8, 2, 64, 20, 16, 6, 32, False),
               (2, 64, 1, 128, 8, 16, 4, 16, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,K,hd,P,page,maxp,split_len,identity", PAGED_EDGES)
def test_paged_partials_match_plain(cuda, B, H, K, hd, P, page, maxp, split_len, identity, dtype):
    """The partial kernel's (m, l, acc) against their plain version, so that a
    fault in the partials is told apart from one in the combine, and the
    combined output against the plain decode, at lengths 0, 1, 15, 16, 17,
    every split boundary (and one past it) and the capacity."""
    rng = np.random.default_rng(5)
    q, pk, pv = _pages(rng, B, H, K, hd, P, page, dtype, cuda)
    if identity:
        pt = torch.arange(B * maxp, dtype=torch.int32, device=cuda).view(B, maxp)
    else:
        pt = torch.from_numpy(rng.integers(0, P, size=(B, maxp)).astype(np.int32)).to(cuda)
    cap = maxp * page
    edges = {0, 1, 15, 16, 17, cap} | {min(e, cap) for s in range(1, -(-cap // split_len) + 1)
                                       for e in (s * split_len, s * split_len + 1)}
    for length in sorted(edges):
        lengths = torch.tensor([(length + i * 7) % (cap + 1) for i in range(B)], dtype=torch.int32, device=cuda)
        m, l, acc, out = paged_decode_partials(q, pk, pv, pt, lengths, split_len)
        mr, lr, ar = ref.paged_decode_partials_reference(q, pk, pv, pt, lengths, split_len)
        torch.cuda.synchronize()
        for expect, got in ((mr, m), (lr, l), (ar, acc)):  # fp32 on both sides, from the same inputs
            assert got.shape == expect.shape
            _close(expect, got, "float32")
        _close(ref.paged_decode_reference(q, pk, pv, pt, lengths), out, dtype)
        assert (out[lengths == 0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("B,T,H,K,causal,window", [
    (1, 77, 4, 2, True, None),    # T not a multiple of 16 or 64
    (2, 50, 4, 4, False, None),   # non-causal
    (1, 100, 4, 1, True, 5),      # a window under one tile
    (1, 130, 8, 2, False, 9),     # non-causal with a window
])
def test_flash_bf16_tensor_core_edges(cuda, hd, B, T, H, K, causal, window):
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, B, T, H, K, hd, "bfloat16", cuda)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    _close(ref.mha_reference(q, k, v, causal=causal, window=window), out, "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_flash_bf16_reads_strided_views(cuda, hd):
    mu = grad_check.shift_mean(hd)  # q, k and v drawn as _qkv draws them, in one tensor
    means = torch.tensor([mu] * 8 + [-mu] * 2 + [1.0] * 2).view(1, 1, 12, 1)
    qkv = (torch.from_numpy(np.random.default_rng(7).normal(size=(2, 70, 12, hd)).astype(np.float32))
           + means).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    _close(ref.mha_reference(q, k, v), flash_attention(q, k, v), "bfloat16")


def _graph_replay(fn):
    first = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    return first, out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_wrappers_replay_in_cuda_graph(cuda, dtype):
    """One capture and two replays of each wrapper give its eager result bit
    for bit: paged decode's workspaces come from the graph's pool."""
    rng = np.random.default_rng(8)
    q, k, v = (_randn(rng, (1, 300, h, 256), dtype, cuda) for h in (16, 1, 1))
    first, out = _graph_replay(lambda: flash_attention(q, k, v, window=128))
    assert torch.equal(first, out)
    qd = _randn(rng, (2, 16, 256), dtype, cuda)
    pk, pv = (_randn(rng, (16, 64, 1, 256), dtype, cuda) for _ in range(2))
    pt = torch.from_numpy(rng.integers(0, 16, size=(2, 8)).astype(np.int32)).to(cuda)
    lengths = torch.tensor([0, 300], dtype=torch.int32, device=cuda)
    first, out = _graph_replay(lambda: paged_decode_attention(qd, pk, pv, pt, lengths))
    assert torch.equal(first, out) and (out[0] == 0).all()


# ---------------------------------------------------------------------------
# training: the flash kernel's gradient, kernels without one, a train step
# ---------------------------------------------------------------------------

# (B, T, S, H, K, hd, causal, window, q_chunk of the card's backward): hd
# 128 and 256, GQA and MQA, T ragged against the kernel's tiles and the
# backward's chunks; whisper's cross-attention (non-causal, T 100 against S
# 300 keys, hd 64, G 1)
ATTN_GRAD_GRID = [(2, 77, 77, 8, 2, 128, True, None, 32), (1, 200, 200, 32, 8, 128, True, None, 64),
                  (1, 130, 130, 16, 1, 256, True, None, 48), (2, 100, 100, 16, 1, 256, True, 40, 64),
                  (2, 100, 300, 12, 12, 64, False, None, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,S,H,K,hd,causal,window,q_chunk", ATTN_GRAD_GRID)
def test_attention_gradients_on_card_match_cpu(cuda, B, T, S, H, K, hd, causal, window, q_chunk, dtype):
    """``full_attention`` on the card (the flash kernel's forward, the
    gradient in torch ops through ``ops.Attention``) against the CPU's
    jnp-body port under autograd, at the same inputs and cotangent."""
    grads = _attention_grads(cuda, B, T, S, H, K, hd, causal, window, q_chunk, dtype)
    for name, got, expect in zip(("o", "dq", "dk", "dv"), grads["cuda"], grads["cpu"]):
        assert got.dtype == DTYPES[dtype], name
        _close(expect, got, dtype)


def _attention_grads(cuda, B, T, S, H, K, hd, causal, window, q_chunk, dtype) -> dict:
    """{"cuda": [o, dq, dk, dv] of ``full_attention`` on the card at
    ``q_chunk``, "cpu": the same of the CPU's body (q_chunk 2048)}, from one
    ``shifted_qkv`` draw and one cotangent."""
    rng = np.random.default_rng(9)
    host = list(grad_check.shifted_qkv(rng, T, S, DTYPES[dtype], "cpu", H=H, K=K, hd=hd, B=B))
    w = _randn(rng, (B, T, H, hd), "float32", "cpu")
    grads = {}
    for dev, chunk in ((cuda, q_chunk), (torch.device("cpu"), 2048)):
        q, k, v = (t.to(dev).requires_grad_() for t in host)
        o = attention.full_attention(q, k, v, causal=causal, window=window, q_chunk=chunk)
        assert o.grad_fn is not None
        (o.float() * w.to(dev)).sum().backward()
        grads[dev.type] = [o.detach()] + [t.grad for t in (q, k, v)]
    return grads


# every attention call of chip_smoke.py phase 6b's steps, one microbatch:
# (B, T, S, H, K, hd, causal, window); whisper-small's encoder (T = S =
# 1500), cross-attention (T 512 against S 1500) and decoder self-attention,
# granite-moe-1b-a400m's grouped hd 64 among them
TRAIN_CALLS = grad_check.FLASH_TRAIN_CALLS


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("call", list(TRAIN_CALLS))
def test_flash_kernel_at_training_calls(cuda, call, dtype):
    """The flash kernel against its plain version at the training step's
    calls, on ``grad_check.shifted_qkv`` inputs (outputs O(1))."""
    B, T, S, H, K, hd, causal, window = TRAIN_CALLS[call]
    rng = np.random.default_rng(12)
    q, k, v = grad_check.shifted_qkv(rng, T, S, DTYPES[dtype], cuda, H=H, K=K, hd=hd, B=B)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(ref.mha_reference(q, k, v, causal=causal, window=window), out, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("call", list(TRAIN_CALLS))
def test_attention_gradients_at_training_calls(cuda, call, dtype):
    """``full_attention`` at the training step's calls and its ``q_chunk``:
    the card (the flash kernel's forward, ``ops.Attention``'s backward)
    against the CPU's plain body under autograd. The output at the kernels'
    tolerance; in fp32 each gradient element too; in bf16 each gradient's
    max|Δ| over its max|g| on the CPU within ``grad_check.GRAD_RTOL``, as
    phase 6a gates a model's. An element of dk or dv there sums G·T products
    whose bf16-rounded intermediates the two sides round at other places
    (the CPU body in bf16, the card's backward in fp32 from bf16 inputs), so
    their difference follows the gradient's scale, not the element's:
    recurrentgemma-9b's MQA (G 16) gives |dk| up to ~14 and differences of
    ~0.03 on elements near 0, ~0.3% of the scale (each side ~0.3–0.4% from
    the fp32 body's gradient)."""
    B, T, S, H, K, hd, causal, window = TRAIN_CALLS[call]
    grads = _attention_grads(cuda, B, T, S, H, K, hd, causal, window, TrainConfig().q_chunk, dtype)
    for name, got, expect in zip(("o", "dq", "dk", "dv"), grads["cuda"], grads["cpu"]):
        assert got.dtype == DTYPES[dtype], name
        if name == "o" or dtype == "float32":
            _close(expect, got, dtype)
        else:
            rel = (got.float().cpu() - expect.float()).abs().max() / expect.float().abs().max()
            assert rel <= grad_check.GRAD_RTOL[dtype], (name, rel.item())


@pytest.mark.gpu
def test_kernels_without_a_gradient_raise_under_grad(cuda):
    rng = np.random.default_rng(10)
    x, B_, C_ = (_randn(rng, s, "float32", cuda) for s in ((1, 64, 2, 16), (1, 64, 1, 16), (1, 64, 1, 16)))
    dA = -_randn(rng, (1, 64, 2), "float32", cuda).abs()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_scan(x.requires_grad_(), dA, B_, C_, 32)
    xr, r, i = (_randn(rng, (1, 16, 32), "float32", cuda) for _ in range(3))
    lam = _randn(rng, (32,), "float32", cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rglru(xr, r, i, lam.requires_grad_())
    q = _randn(rng, (1, 16, 4, 32), "float32", cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention(q, q[:, :, :1].detach(), q[:, :, :1].detach())
    with torch.no_grad():  # serving: no autograd, no error
        ops.ssd_scan(x, dA, B_, C_, 32)
    with pytest.raises(RuntimeError, match="ops.SSDScan"):
        ops.ssd_scan(x, dA, B_, C_, 32)
    with pytest.raises(RuntimeError, match="ops.RGLRU"):
        ops.rglru(xr, r, i, lam)


# (b, t, h, p, n, chunk): ragged t at chunk 64, and one microbatch of
# chip_smoke.py phase 6b's mamba2-1.3b step
SSD_GRAD_CASES = [(1, 100, 4, 32, 64, 64), grad_check.SSD_TRAIN_SHAPE]
# (B, T, W): ragged W and T, and one microbatch of phase 6b's recurrentgemma-9b
RGLRU_GRAD_CASES = [(2, 100, 130), grad_check.RGLRU_TRAIN_SHAPE]


def _function_grads(fn, host_inputs, host_weights, dev):
    """``fn``'s outputs and the gradients of Σ out·weight into every input,
    on ``dev``."""
    leaves = [t.to(dev).requires_grad_() for t in host_inputs]
    outs = fn(*leaves)
    assert all(o.grad_fn is not None for o in outs)
    sum((o.float() * w.to(dev)).sum() for o, w in zip(outs, host_weights)).backward()
    return [o.detach() for o in outs] + [t.grad for t in leaves]


SSM_CARD_CASES = [("ssd", c, dt) for c in SSD_GRAD_CASES for dt in DTYPES] + \
    [("rglru", c, dt) for c in RGLRU_GRAD_CASES for dt in DTYPES] + \
    [("model", arch, "float32") for arch in ("mamba2-1.3b", "recurrentgemma-9b")] + \
    [pytest.param("rglru uniform gates", grad_check.RGLRU_TRAIN_SHAPE, "float32", marks=pytest.mark.xfail(
        strict=True, reason="ROADMAP Queue C 18: with r uniform in [0, 1], 1 - a^2 cancels near r = 0 and dr "
                            "differs card vs CPU past 2e-5 of its max, until it is written as -expm1(2 log a)"))]


def _model_grads_on_card_match_cpu(cuda, arch):
    cfg = get_config(arch).reduced(dtype="float32")
    gpu = build_model(cfg, cuda).init(torch.Generator(device=cuda).manual_seed(0)).requires_grad_()
    cpu = build_model(cfg, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    cpu.requires_grad_()
    tokens = torch.from_numpy(np.random.default_rng(14).integers(1, cfg.vocab, size=(2, 41)))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    for fn in (ssd_states, ssd_output, rglru_scan, flash_attention):
        fn.launches = 0
    losses = [m.loss({k: v.to(m.device) for k, v in batch.items()})[0] for m in (gpu, cpu)]
    for loss in losses:
        loss.backward()
    _close(losses[1].detach(), losses[0].detach(), "float32")
    for (name, pg), pc in zip(gpu.named_parameters(), cpu.parameters()):
        assert pc.grad.abs().sum() > 0 and pg.grad.abs().sum() > 0, name
        _close(pc.grad, pg.grad, "float32")
    kinds = (cfg.layer_pattern * cfg.n_layers)[: cfg.n_layers] if cfg.family == "hybrid" else "S" * cfg.n_layers
    assert (ssd_states.launches, ssd_output.launches, rglru_scan.launches, flash_attention.launches) == \
        tuple(2 * kinds.count(k) for k in "SSRA")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,case,dtype", SSM_CARD_CASES)
def test_ssm_functions_on_card_match_cpu(cuda, kind, case, dtype):
    """ops.SSDScan and ops.RGLRU on the card (the kernels' forward, the
    gradient in torch ops) against the CPU (the plain forwards, the same
    backward), random weights on both outputs: the outputs and every
    input's gradient, fp32 within 2e-5 of each tensor's max|·| (as
    tests/test_torch_ssm_grad.py reads them against jax.grad: values run to
    ~10³, and an element that sums terms of that size to ~10⁻⁴ keeps their
    rounding), bf16 at 2e-2 + 1e-2 relative per element. The RG-LRU's gates
    r and i are sigmoids of N(0, 1) draws, as the model's are; the case
    "rglru uniform gates" draws r and i uniform in [0, 1] and is expected to
    fail: near r = 0 the recurrence's 1 − a² = 1 − exp(2·log a) cancels
    (relative rounding 2⁻²⁴ / (1 − a²), 2% at r = 1e-7) in the kernel, the
    reference and the backward alike, and ∂/∂r there reads exp's last bit
    on each device (ROADMAP Queue C 18). Then reduced mamba2 and recurrentgemma (fp32,
    remat) through them on the card against the CPU's jnp-body ports: the
    loss and every parameter's gradient, each nonzero, at 2e-5 + 1e-2
    relative; every kernel of the model ran in the forward and in the
    recompute."""
    if kind == "model":
        return _model_grads_on_card_match_cpu(cuda, case)
    rng = np.random.default_rng(13)
    if kind == "ssd":
        b, t, h, p, n, chunk = case
        host = list(_ssd_inputs(rng, b, t, h, p, n, dtype, "cpu"))
        fn = lambda *a: ops.SSDScan.apply(*a, chunk)  # noqa: E731
        weights = [_randn(rng, (b, t, h, p), "float32", "cpu"), _randn(rng, (b, h, p, n), "float32", "cpu")]
    else:
        B, T, W = case
        x, r, i, lam = _rglru_inputs(rng, B, T, W, dtype, "cpu")
        if kind == "rglru":
            r, i = (torch.sigmoid(_randn(rng, (B, T, W), "float32", "cpu")).to(DTYPES[dtype]) for _ in range(2))
        host = [x, r, i, lam, _randn(rng, (B, W), "float32", "cpu")]
        fn = ops.RGLRU.apply
        weights = [_randn(rng, (B, T, W), "float32", "cpu"), _randn(rng, (B, W), "float32", "cpu")]
    got = _function_grads(fn, host, weights, cuda)
    want = _function_grads(fn, host, weights, torch.device("cpu"))
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if dtype == "float32":
            err, scale = (g.cpu() - w).abs().max().item(), w.abs().max().item()
            assert err <= _tol(dtype) * scale, (k, err, scale)
        else:
            _close(w, g, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_gives_every_parameter_a_gradient(cuda, accum):
    """One AdamW step of reduced qwen3-4b on the card: the loss is finite,
    flash ran forward and in the remat recompute, and every parameter got a
    finite, nonzero gradient and moved."""
    cfg = get_config("qwen3-4b").reduced(dtype="float32")
    model = build_model(cfg, cuda)
    state = init_state(model, torch.Generator(device=cuda).manual_seed(0), OptimizerConfig(warmup_steps=1))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tokens = torch.randint(1, cfg.vocab, (4, 65), device=cuda)
    flash_attention.launches = 0
    state, metrics = make_train_step(model, TrainConfig(opt=OptimizerConfig(warmup_steps=1), accum_steps=accum))(
        state, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    assert flash_attention.launches == cfg.n_layers * 2 * accum
    assert torch.isfinite(metrics["loss"]) and float(metrics["grad_norm"]) > 0
    for n, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
        assert p.grad.abs().sum() > 0, n
        assert not torch.equal(p.detach(), before[n]), n


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [True, False])
def test_stacked_gradients_land_layer_by_layer_on_card(cuda, remat):
    """When the backward reaches layer l's input on the card, every later
    layer's slice of the stacked gradients is already written, so no layer's
    gradient waits for the rest (``models/common.py::layer_view``)."""
    cfg = get_config("qwen3-4b").reduced(dtype="float32", n_layers=4)
    model = build_model(cfg, cuda).init(torch.Generator(device=cuda).manual_seed(0)).requires_grad_()
    wq, seen, block = model.attn["wq"], {}, model._block

    def spy(lp, x, *args):
        l = lp["ln1"].storage_offset() // cfg.d_model

        def hook(g):  # x's gradient is done: layer l's backward has run
            seen.setdefault(l, [wq.grad is not None and bool(wq.grad[j].abs().sum() > 0)
                                for j in range(cfg.n_layers)])

        x.register_hook(hook)
        return block(lp, x, *args)

    model._block = spy
    tokens = torch.randint(1, cfg.vocab, (2, 16), device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    loss, _ = model.loss({"tokens": tokens, "labels": tokens}, remat=remat)
    loss.backward()
    assert sorted(seen) == list(range(cfg.n_layers))
    for l, filled in seen.items():
        assert filled[l + 1:] == [True] * (cfg.n_layers - l - 1), (l, filled)
    assert all(wq.grad[j].abs().sum() > 0 for j in range(cfg.n_layers))


# (arch, capacity_factor, T): both MoE configs at full width, one layer of
# random weights, a 128-token prefill (N 128: C 64, no expert overflows) and
# decode (T 1); then granite-moe at capacity_factor 0.3 and T 256, where the
# experts overflow and each loses its slot-0 token (tests/test_torch_moe.py)
MOE_CASES = [("granite-moe-1b-a400m", 1.25, 128), ("qwen2-moe-a2.7b", 1.25, 128), ("granite-moe-1b-a400m", 1.25, 1),
             ("qwen2-moe-a2.7b", 1.25, 1), ("granite-moe-1b-a400m", 0.3, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch,cf,T", MOE_CASES)
def test_moe_ffn_on_card_matches_cpu(cuda, arch, cf, T, dtype):
    """``moe_ffn`` on CUDA tensors against the same function on the CPU
    (checked against the reference there): y within the kernels' tolerance,
    the same expert table, aux within fp32 noise; and two calls on the card
    give the same bits (the combine adds in a fixed order, no atomics)."""
    cfg = dataclasses.replace(get_config(arch), n_layers=1, capacity_factor=cf)
    lp = moe.moe_params(cfg, 1, lambda *s: torch.nn.Parameter(torch.zeros(s), requires_grad=False))
    moe.init_moe_(lp, cfg, torch.Generator().manual_seed(0))
    lp = {k: v[0] for k, v in lp.items()}
    x = _randn(np.random.default_rng(5), (1, T, cfg.d_model), dtype, "cpu")
    y, aux = moe.moe_ffn(lp, x, cfg)
    lg = {k: v.to(cuda) for k, v in lp.items()}
    yg, auxg = moe.moe_ffn(lg, x.to(cuda), cfg)
    yg2, auxg2 = moe.moe_ffn(lg, x.to(cuda), cfg)
    assert torch.equal(yg, yg2) and torch.equal(auxg, auxg2)
    _close(y, yg, dtype)
    np.testing.assert_allclose(aux.item(), auxg.item(), rtol=1e-5)
    xt = x.reshape(T, -1)
    top_p, top_i = torch.topk(torch.softmax(xt.float() @ lp["router"], -1), cfg.top_k, dim=-1)
    C = moe.capacity(T, cfg.top_k, cfg.n_experts, cf)
    table, _, _ = moe.dispatch(top_i, top_p, cfg.n_experts, C)
    table_g, _, _ = moe.dispatch(top_i.to(cuda), top_p.to(cuda), cfg.n_experts, C)
    assert torch.equal(table, table_g.cpu())
    if cf < 1:
        assert (table[:, 0] == T).any()  # an overflowing expert gave up its slot 0


# (N, k, E, d): qwen2-moe's routing at the benchmark cells' microbatches (4 ×
# 512 in 2 microbatches: N 1024 a layer; 1 × 4096) and N 2048, and
# granite-moe's (32 experts top-8 at d 1024); capacity factor 1.25
GATHER_CASES = [(2048, 4, 60, 2048), (4096, 4, 60, 2048), (1024, 4, 60, 2048), (2048, 8, 32, 1024)]


def _gather_case(N, k, E, d, dtype, seed=0):
    """A routing skewed as a router at its initial weights over zipf ids
    (most slots dead, most routed entries dropped), from ``moe.dispatch``;
    rows drawn on the CPU."""
    rng = np.random.default_rng(seed)
    scores = torch.from_numpy(rng.normal(size=(N, E)).astype(np.float32)) + torch.linspace(4.0, 0.0, E)
    top_p, top_i = torch.topk(torch.softmax(scores, -1), k, dim=-1)
    C = moe.capacity(N, k, E, 1.25)
    table, _, slots = moe.dispatch(top_i, top_p / top_p.sum(-1, keepdim=True), E, C)
    xt, dy = _randn(rng, (N, d), dtype, "cpu"), _randn(rng, (N, d), dtype, "cpu")
    ye, d_xe = _randn(rng, (E, C, d), dtype, "cpu"), _randn(rng, (E, C, d), dtype, "cpu")
    return table, slots, xt, ye, dy, d_xe


def _gather_grads(table, slots, xt, ye, dy, d_xe, device):
    """(xe, y, d_xt, d_ye) of ``ops.MoEDispatch`` / ``MoECombine`` on ``device``."""
    to = lambda t: t.detach().to(device, copy=True)  # noqa: E731
    a, b = to(xt).requires_grad_(), to(ye).requires_grad_()
    xe, y = ops.MoEDispatch.apply(a, to(table), to(slots)), ops.MoECombine.apply(b, to(slots), to(table))
    torch.autograd.backward([xe, y], [to(d_xe), to(dy)])
    return [t.detach().cpu() for t in (xe, y, a.grad, b.grad)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("N,k,E,d", GATHER_CASES)
def test_moe_gathers_match_the_cpu_route(cuda, N, k, E, d, dtype):
    """The two row-gather kernels through ``ops.MoEDispatch`` /
    ``MoECombine`` against the same Functions on the CPU (the plain
    versions): the forwards bit-equal (the combine rounds after each add, as
    the CPU's), the backwards bit-equal or within one ulp in bf16 (an fp32 sum
    rounded once on both sides)."""
    case = _gather_case(N, k, E, d, dtype)
    table, slots = case[:2]
    assert (table == N).float().mean() > 0.5 and (slots == table.numel()).any()
    from repro_torch.kernels import moe_gather

    before = (moe_gather.gather_rows.launches, moe_gather.gather_sum_rows.launches)
    got = _gather_grads(*case, cuda)
    assert (moe_gather.gather_rows.launches, moe_gather.gather_sum_rows.launches) == (before[0] + 2, before[1] + 2)
    want = _gather_grads(*case, torch.device("cpu"))
    xe, y, d_xt, d_ye = got
    assert torch.equal(xe, want[0]) and torch.equal(y, want[1]) and torch.equal(d_ye, want[3])
    if dtype == "float32":
        assert torch.equal(d_xt, want[2])
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(want[2].float().abs().clamp(min=2.0**-126))) - 7)
        assert ((d_xt.float() - want[2].float()).abs() <= ulp).all()
    assert torch.equal(_gather_grads(*case, cuda)[2], d_xt)  # the same bits again: no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1020, 2044, 12])
def test_moe_gathers_raise_on_a_width_not_a_multiple_of_8(cuda, d):
    from repro_torch.kernels import moe_gather

    src = torch.zeros(4, d, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        moe_gather.gather_rows(src, torch.zeros(3, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="multiple of 8"):
        moe_gather.gather_sum_rows(src, torch.zeros(3, 2, dtype=torch.int64, device=cuda))


@pytest.mark.gpu
def test_moe_train_step_has_no_sorting_index_backward(cuda):
    """A profiled qwen2-moe training step (full width, 2 layers, bf16
    compute, remat, 2 × 512 tokens): the MoE gathers' kernels run forward and
    backward, and PyTorch's ``indexing_backward_kernel`` (the accumulating
    ``index_put_`` behind advanced indexing's backward) never runs over bf16
    rows (the fp32 gates' gathers in ``dispatch`` keep theirs)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), n_layers=2)
    model = build_model(cfg, cuda)
    opt = OptimizerConfig(warmup_steps=1)
    state = init_state(model, torch.Generator(device=cuda).manual_seed(0), opt)
    step = make_train_step(model, TrainConfig(opt=opt, accum_steps=1, remat=True))
    tokens = torch.randint(1, cfg.vocab, (2, 513), device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    state, _ = step(state, batch)  # builds the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert torch.isfinite(metrics["loss"])
    assert not [n for n in names if "indexing_backward_kernel" in n and "BFloat16" in n], names
    assert any("gather_rows_kernel" in n for n in names) and any("gather_sum_rows_kernel" in n for n in names), names


# ---------------------------------------------------------------------------
# the distribution layer on one card: a 1-rank NCCL group (gloo beside it
# for CPU tensors) and a (1, 1) DeviceMesh, as chip_smoke.py's phase mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on one")
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("cuda:nccl,cpu:gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        yield make_host_mesh((1, 1), ("data", "model"), "cuda")
    finally:
        dist.destroy_process_group()


ALL_FLAGS = PerfConfig(**{f.name: True for f in dataclasses.fields(PerfConfig)})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_row_parallel_einsum_through_nccl_equals_the_product(cuda, nccl_mesh, dtype):
    """V9's reduce-scatter and all-gather over the one ``model`` rank give
    the plain product's bits."""
    rng = np.random.default_rng(10)
    u, w = _randn(rng, (2, 5, 256), dtype, cuda), _randn(rng, (256, 64), dtype, cuda)
    transformer.row_parallel_einsum.mesh_calls = 0
    with torch.no_grad(), rdist.mesh_context(nccl_mesh), perf_context(ALL_FLAGS):
        y = transformer.row_parallel_einsum(u, w)
    assert transformer.row_parallel_einsum.mesh_calls == 1
    assert torch.equal(y, u @ w)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m"])
def test_decode_under_the_mesh_equals_no_mesh(cuda, nccl_mesh, arch):
    """Every PerfConfig flag on, the KV cache placed on the (1, 1) mesh: the
    greedy tokens and logits of a reduced bf16 model as without a mesh (V3
    takes its dense path on the placed cache, V2 routes the one data shard,
    V9 runs through NCCL). Both runs decode with the paged-decode kernel over
    a cache of 64 slots, one identity page of 64, which is held here against
    its plain version at the model's heads and every length."""
    cfg = get_config(arch).reduced(dtype="bfloat16")
    model = build_model(cfg, cuda, param_dtype=torch.bfloat16).init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 16))).long().to(cuda)
    q, kc, vc = grad_check.shifted_qkv(rng, 1, 64, torch.bfloat16, "cpu", B=2, H=cfg.n_heads, K=cfg.n_kv_heads,
                                       hd=cfg.resolved_head_dim)
    for length in range(1, 65):
        _close(attention.decode_attention(q, kc, vc, length),
               attention.decode_attention(q.to(cuda), kc.to(cuda), vc.to(cuda), length), "bfloat16")

    def run(mesh):
        with torch.no_grad(), rdist.mesh_context(mesh), perf_context(ALL_FLAGS if mesh else PerfConfig()):
            logits, cache = model.prefill(prompt, pad_to=64)
            if mesh is not None:
                cache = rdist.distribute_tree(cache, mesh, model.cache_axes())
            out = [logits]
            for _ in range(4):
                logits, cache = model.decode_step(cache, out[-1][:, :cfg.vocab].argmax(-1, keepdim=True))
                out.append(logits)
        return torch.stack(out), cache

    want, _ = run(None)
    got, cache = run(nccl_mesh)
    assert rdist.is_dtensor(cache["k"])
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m"])
def test_trainer_under_the_mesh_equals_no_mesh(cuda, nccl_mesh, arch):
    """``Trainer(mesh=...)`` on the (1, 1) NCCL mesh, every PerfConfig flag
    on: 2 steps of a reduced model (fp32 masters, bf16 compute, 2
    microbatches) give the losses, grad norms and state of the trainer
    without a mesh: every leaf bit-equal but the tied embedding and its
    moments, those and the metrics within 1e-6 of their largest |value|
    (fp32 sums that may run in another order; a missing or wrong update
    exceeds it by orders). The state is placed (DTensor parameters on the
    card); V9 runs forward and backward through NCCL at the one rank, V2
    routes its one data shard."""
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_config(arch).reduced(dtype="bfloat16")
    tcfg = TrainerConfig(steps=2, global_batch=4, seq_len=64, log_every=1000,
                         train=TrainConfig(opt=OptimizerConfig(warmup_steps=1), accum_steps=2))
    runs = {}
    for on_mesh in (False, True):
        transformer.row_parallel_einsum.mesh_calls = transformer.row_parallel_einsum.backward_calls = 0
        moe.moe_ffn_local.mesh_calls = 0
        with perf_context(ALL_FLAGS):
            trainer = Trainer(cfg, tcfg, device=cuda, mesh=nccl_mesh if on_mesh else None)
            res = trainer.run()
        state = {p: (x.full_tensor() if rdist.is_dtensor(x) else x).detach() for p, x in
                 leaves_with_paths(trainer.state)}
        runs[on_mesh] = (res["metrics"], state)
        trainer.close()
    assert rdist.is_dtensor(trainer.model.embed) and trainer.model.embed.device.type == "cuda"
    row_parallel = cfg.n_layers * (1 if cfg.family == "moe" else 2)
    assert transformer.row_parallel_einsum.mesh_calls == row_parallel * 2 * 2 * 2  # forward, recompute
    assert transformer.row_parallel_einsum.backward_calls == row_parallel * 2 * 2
    assert moe.moe_ffn_local.mesh_calls == (cfg.n_layers * 2 * 2 * 2 if cfg.family == "moe" else 0)
    (plain, plain_state), (meshed, state) = runs[False], runs[True]

    def within(got, want):
        return (got.float() - want.float()).abs().max() <= 1e-6 * want.float().abs().max()

    assert len(meshed) == len(plain)
    for a, b in zip(meshed, plain):
        for k in ("loss", "grad_norm"):
            assert within(torch.tensor(a[k]), torch.tensor(b[k])), (a["step"], k, a[k], b[k])
    assert state.keys() == plain_state.keys()
    assert [p for p in state if not p.endswith("['embed']") and not torch.equal(state[p], plain_state[p])] == []
    assert [p for p in state if p.endswith("['embed']") and not within(state[p], plain_state[p])] == []


@pytest.mark.gpu
def test_compressed_psum_on_card_bit_equal_cpu(cuda, nccl_mesh):
    """``compressed_psum`` on CUDA tensors through NCCL and on CPU tensors
    through gloo: the same bits, ragged sizes and an all-zero block."""
    import torch.distributed as dist

    rng = np.random.default_rng(12)
    grads = {"a": _randn(rng, (3, 300), "float32", "cpu") * 1e-3, "b": [_randn(rng, (257,), "float32", "cpu")]}
    grads["a"][0, :256] = 0.0
    err = compression.init_error_state(grads)
    host = compression.compressed_psum(grads, err, dist.group.WORLD)
    to = lambda t: {"a": t["a"].to(cuda), "b": [t["b"][0].to(cuda)]}  # noqa: E731
    card = compression.compressed_psum(to(grads), to(err), nccl_mesh.get_group("data"))
    for h, c in zip(host, card):
        assert torch.equal(h["a"], c["a"].cpu()) and torch.equal(h["b"][0], c["b"][0].cpu())


@pytest.mark.gpu
def test_cuda_route_counts_as_the_meta_route(cuda):
    """Under a tally, each kernel's CUDA route counts the calls, FLOPs and
    bytes its meta route counts on the same shapes (paged decode at full
    lengths, the meta route's count), and its output has the meta output's
    shape and dtype."""
    from repro_torch.kernels import cost

    rng = np.random.default_rng(13)
    q, k, v = (_randn(rng, s, "bfloat16", cuda) for s in ((2, 96, 8, 64), (2, 96, 4, 64), (2, 96, 4, 64)))
    pq, pk, pv = (_randn(rng, s, "bfloat16", cuda) for s in ((2, 8, 64), (4, 64, 4, 64), (4, 64, 4, 64)))
    table = torch.arange(4, dtype=torch.int32, device=cuda).view(2, 2)
    lengths = torch.full((2,), 128, dtype=torch.int32, device=cuda)
    x, B_, C_ = (_randn(rng, s, "bfloat16", cuda) for s in ((1, 300, 4, 64), (1, 300, 1, 128), (1, 300, 1, 128)))
    dA = -_randn(rng, (1, 300, 4), "float32", cuda).abs() * 0.3
    rx = _randn(rng, (2, 100, 256), "bfloat16", cuda)
    rr, ri = torch.sigmoid(rx), torch.sigmoid(rx.flip(1))
    lam = torch.linspace(0.5, 4.0, 256, device=cuda)
    rows = _randn(rng, (40, 64), "bfloat16", cuda)
    idx = torch.from_numpy(rng.integers(0, 41, size=(70,))).to(cuda)
    calls = [(ops.attention, (q, k, v), {"window": 40}), (ops.paged_decode, (pq, pk, pv, table, lengths), {}),
             (ops.ssd_scan, (x, dA, B_, C_, 256), {}), (ops.rglru, (rx, rr, ri, lam), {}),
             (ops.gather_rows, (rows, idx), {}), (ops.gather_sum_rows, (rows, idx.view(35, 2)), {})]
    for fn, args, kw in calls:
        with cost.tally() as on_card:
            got = fn(*args, **kw)
        meta_args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
        with cost.tally() as on_meta:
            want = fn(*meta_args, **kw)
        assert (on_card.calls, on_card.flops, on_card.bytes) == (on_meta.calls, on_meta.flops, on_meta.bytes)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]


@pytest.mark.gpu
def test_checkpoint_store_on_disk_restores_card_tensors(cuda, tmp_path):
    """A state of CUDA tensors (bf16 and fp32, one of them several 4 MiB
    chunks long, and an int32 counter) saved through the port's
    ``BVCheckpointStore(path)`` into its engine on disk, then read by a new
    store on the same directory and copied back onto the card: every leaf
    bit-equal, and the engine's scrub clean."""
    from repro_torch.checkpoint.bvstore import BVCheckpointStore

    g = torch.Generator(device=cuda).manual_seed(0)
    state = {"params": {"w": torch.randn(1536, 2048, generator=g, device=cuda),
                        "emb": torch.randn(3000, 256, generator=g, device=cuda).bfloat16()},
             "opt": {"mu": torch.randn(77, 5, generator=g, device=cuda).bfloat16()},
             "step": torch.tensor(9, dtype=torch.int32, device=cuda)}
    store = BVCheckpointStore(str(tmp_path / "ck"))
    store.save(9, state)
    store.close()
    store = BVCheckpointStore(str(tmp_path / "ck"))
    try:
        template = {"params": {k: torch.empty_like(v) for k, v in state["params"].items()},
                    "opt": {"mu": torch.empty_like(state["opt"]["mu"])}, "step": torch.empty_like(state["step"])}
        loaded, meta = store.load(template=template)
        assert meta["step"] == 9 and store.db.verify_integrity()["findings"] == []
    finally:
        store.close()
    for (path, want), (_, got) in zip(leaves_with_paths(state), leaves_with_paths(loaded)):
        got = got.to(cuda)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got.view(torch.uint8) if got.dtype == torch.bfloat16 else got,
                           want.view(torch.uint8) if want.dtype == torch.bfloat16 else want), path


@pytest.mark.gpu
def test_sharded_and_replicated_stores_restore_card_tensors(cuda, tmp_path):
    """A state of CUDA tensors saved into the port's ``ShardedDB`` (3 shards)
    and into a ``DB`` with a replica attached, both on the store's own engine
    config (``bvstore.store_config``): the router re-opened, and the replica
    promoted after its primary's crash, each give every leaf back bit-equal
    on the card, with a clean scrub."""
    from repro_torch.checkpoint.bvstore import BVCheckpointStore, store_config
    from repro_torch.core import DB, ShardedDB, attach, bootstrap_replica

    g = torch.Generator(device=cuda).manual_seed(1)
    state = {"params": {"w": torch.randn(1536, 2048, generator=g, device=cuda),
                        "emb": torch.randn(3000, 256, generator=g, device=cuda).bfloat16()},
             "step": torch.tensor(5, dtype=torch.int32, device=cuda)}

    def restored_equal(store):
        loaded, meta = store.load(template=state)
        assert meta["step"] == 5 and store.db.verify_integrity()["findings"] == []
        for (path, want), (_, got) in zip(leaves_with_paths(state), leaves_with_paths(loaded)):
            got = got.to(cuda)
            assert got.dtype == want.dtype and got.shape == want.shape, path
            assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
                               want.view(torch.int16) if want.dtype == torch.bfloat16 else want), path

    store = BVCheckpointStore(db=ShardedDB.open(str(tmp_path / "sharded"), shards=3, config=store_config()))
    store.save(5, state)
    store.close()
    store = BVCheckpointStore(db=ShardedDB.open(str(tmp_path / "sharded"), config=store_config()))
    try:
        restored_equal(store)
    finally:
        store.close()

    primary = DB.open(str(tmp_path / "primary"), store_config())
    replica = bootstrap_replica(primary, str(tmp_path / "replica"), cfg=store_config())
    link = attach(primary, replica)
    BVCheckpointStore(db=primary).save(5, state)
    assert link.wait_caught_up(timeout=60) and replica.replication_status()["lag"] == 0
    primary.close(crash=True)
    replica.promote()
    store = BVCheckpointStore(db=replica)
    try:
        restored_equal(store)
    finally:
        store.close()
