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
