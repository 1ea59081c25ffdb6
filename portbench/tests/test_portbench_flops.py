"""The yardstick's counts against hand arithmetic from the published sizes."""
from __future__ import annotations

import pytest

from portbench import flops, harness


def model(name):
    return harness.load("configs", name)["model"]


@pytest.mark.parametrize("name, params, gflop_512, gflop_4096", [
    # granite: 24 × (attention 3.146 M + router 0.033 M + 8 × 1.573 M) + head 49155 × 1024
    ("granite-moe-1b-a400m", 428_608_512, 2.65, 3.18),
    # qwen2-moe at 6 layers: 6 × (16.777 M + 0.123 M + 4 × 8.651 M + shared 34.603 M + 2048) + 151936 × 2048;
    # 5.005 GFLOP a token
    ("qwen2-moe-a2.7b", 827_813_888, 5.00, None),
])
def test_active_params_and_training_flops(name, params, gflop_512, gflop_4096):
    m = model(name)
    assert flops.active_matmul_params(m) == params
    assert flops.train_flops_per_token(m, 512) / 1e9 == pytest.approx(gflop_512, abs=0.005)
    if gflop_4096:
        assert flops.train_flops_per_token(m, 4096) / 1e9 == pytest.approx(gflop_4096, abs=0.005)


def test_attention_flops_are_the_causal_pairs():
    m = model("granite-moe-1b-a400m")
    # 24 layers × 4·64·16 × 512·513/2 over 512 tokens
    assert flops.attention_flops_per_token(m, 512) == 24 * 4 * 64 * 16 * 513 / 2


@pytest.mark.parametrize("shape, bound_ms, bound_by", [
    # PERF.md's kernel table, bound column, at the training calls
    ((2, 512, 512, 16, 8, 64, True, 2), 0.00188, "bytes"),      # granite-moe: 6.29 MB
    ((2, 512, 512, 16, 16, 128, True, 2), 0.00501, "bytes"),    # qwen2-moe: 16.78 MB
    ((2, 512, 512, 32, 8, 128, True, 2), 0.00626, "bytes"),     # qwen3-4b: 20.97 MB
    ((2, 1500, 1500, 12, 12, 64, False, 2), 0.01398, "flops"),  # whisper encoder: 13.82 GFLOP
    ((2, 512, 1500, 12, 12, 64, False, 2), 0.00477, "flops"),   # whisper cross: 4.72 GFLOP
])
def test_flash_bound_matches_the_kernel_table(shape, bound_ms, bound_by):
    assert flops.flash_bound_s(*shape) * 1e3 == pytest.approx(bound_ms, abs=0.000006)
    f, b = flops.flash_cost(*shape)
    by_bytes = b / flops.PEAKS["hbm_bytes_per_s"] >= f / flops.PEAKS["bf16_flops_per_s"]
    assert by_bytes == (bound_by == "bytes")


def test_flash_cost_refuses_a_causal_call_with_other_key_length():
    with pytest.raises(ValueError):
        flops.flash_cost(1, 128, 256, 4, 4, 64, True, 2)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"])
def test_the_moe_family_counts_with_the_yardstick(name):
    """The MoE family's model FLOPs are the yardstick's attention and FFN
    formula, unchanged, at every traffic length."""
    from portbench import families

    m = model(name)
    for T in (512, 4096):
        assert families.of(m).flops_per_token(m, T) == flops.train_flops_per_token(m, T)


def test_mamba2_flops_by_hand():
    m = model("mamba2-1.3b")
    # 48 × (in_proj 2048 × 8512 + out_proj 4096 × 2048) + the tied head 50280 × 2048
    assert flops.mamba2_matmul_params(m) == 48 * (2048 * 8512 + 4096 * 2048) + 50280 * 2048 == 1_342_390_272
    # a chunk of 256: C·Bᵀ 2·32896·128 + 64 heads × (scores·x 2·32896·64 + state and output 4·256·64·128)
    chunk = 2 * 32896 * 128 + 64 * (2 * 32896 * 64 + 4 * 256 * 64 * 128)
    assert chunk == 814_776_320
    assert flops.ssd_flops_per_token(m, 4096) == 48 * 16 * chunk / 4096
    assert flops.mamba2_train_flops_per_token(m, 4096) == 6 * 1_342_390_272 + 3 * 48 * 16 * chunk / 4096
    assert flops.mamba2_train_flops_per_token(m, 4096) / 1e9 == pytest.approx(8.5127, abs=0.0001)
    # a ragged row: chunks of 256, 256 and 88
    ragged = 2 * 88 * 89 // 2 * 128 + 64 * (2 * 88 * 89 // 2 * 64 + 4 * 88 * 64 * 128)
    assert flops.ssd_flops_per_token(m, 600) == pytest.approx(48 * (2 * chunk + ragged) / 600)
    assert flops.ssd_chunk_lengths(600, 256) == [256, 256, 88] and flops.ssd_chunk_lengths(100, 256) == [100]


@pytest.mark.parametrize("shape, nbytes", [
    # PERF.md's kernel table: b 1, t 1024, h 64, p 64, n 128, chunk 256, bf16
    ((1, 1024, 64, 64, 1, 128, 256, 2), (2 * 1024 * 64 * 64 + 2 * 1024 * 128) * 2 + 4 * (1024 * 64 + 64 * 64 * 128)),
    # the mamba2 cell's call: 4 rows of 4096
    ((4, 4096, 64, 64, 1, 128, 256, 2), (2 * 4 * 4096 * 64 * 64 + 2 * 4 * 4096 * 128) * 2
     + 4 * (4 * 4096 * 64 + 4 * 64 * 64 * 128)),
])
def test_ssd_bounds_match_the_kernel_table(shape, nbytes):
    """A forward SSD call is bounded by its own inputs and outputs and its
    model products, which lie under what the port's two kernels move
    between them (the table's bounds, 0.01025 and 0.01017 ms)."""
    f, b = flops.ssd_scan_cost(*shape)
    assert b == nbytes
    bt, t, h, p, g, n, chunk, _ = shape
    assert f == bt * t // 256 * 814_776_320  # whole chunks of 256 (test_mamba2_flops_by_hand)
    assert b / flops.PEAKS["hbm_bytes_per_s"] > f / flops.PEAKS["bf16_flops_per_s"]  # bytes bound it
    assert flops.ssd_scan_bound_s(*shape) == flops.bound_s(f, b, 2) == b / flops.PEAKS["hbm_bytes_per_s"]
    if shape[:2] == (1, 1024):
        assert flops.ssd_scan_bound_s(*shape) * 1e3 == pytest.approx(0.005869, abs=0.000001)
        assert flops.ssd_scan_bound_s(*shape) * 1e3 < 0.01025 + 0.01017
