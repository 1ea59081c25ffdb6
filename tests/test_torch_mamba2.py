"""The port's Mamba2LM against the reference on CPU: the reduced mamba2-1.3b
with the reference's init converted by ``convert.params_from_jax``; logits
of forward, prefill (and both caches) and 4 teacher-forced decode steps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.convert import flatten, params_from_jax
from repro_torch.models import build_model
from repro_torch.models.mamba2 import Mamba2LM

torch.set_num_threads(1)

ARCH = "mamba2-1.3b"
# fp32: the two frameworks differ only in summation order
FP32_ATOL = 2e-5
# bf16: each matmul, conv tap and SSD einsum rounds to bf16, at slightly
# different points in the two frameworks (XLA fuses some casts), so a
# one-ulp difference in an early activation reaches the logits (|logit| ~ 3,
# bf16 ulp 2^-6 there): the bound is a few ulps. Inputs are teacher-forced.
BF16_ATOL = 6e-2


def _pair(dtype, seed=0, **over):
    rcfg = ref_get_config(ARCH).reduced(dtype=dtype, **over)
    tcfg = get_config(ARCH).reduced(dtype=dtype, **over)
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.key(seed))
    model = build_model(tcfg, "cpu")
    model.load_state_dict(flatten(params_from_jax(jax.tree.map(np.asarray, params))))
    return rcfg, ref, params, model


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(), atol=atol, rtol=rtol)


def _close_conv(a, b, atol):
    """The conv cache is bf16 in both packages: a last-ulp fp32 difference
    can round an entry to the neighbouring bf16 value, one ulp (≤ 2^-7
    relative) apart."""
    _close(a.astype(jnp.float32), b, atol, rtol=2**-7)


def test_config_matches_reference():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(ref_get_config(ARCH))
    r, t = ref_get_config(ARCH).reduced(dtype="float32"), get_config(ARCH).reduced(dtype="float32")
    assert dataclasses.asdict(t) == dataclasses.asdict(r)


def test_registry_builds_mamba2_with_reference_parameter_names():
    cfg, ref, params, model = _pair("float32")
    assert isinstance(model, Mamba2LM)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in params.items()}


@pytest.mark.parametrize("dtype,atol", [("float32", FP32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("T", [12, 70])  # under one chunk of 32; ragged over three
def test_forward_logits(dtype, atol, T):
    cfg, ref, params, model = _pair(dtype)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, T)).astype(np.int32)
    ref_logits, _ = ref.forward(params, jnp.asarray(tokens))
    logits, aux = model(torch.from_numpy(tokens).long())
    assert logits.shape == (2, T, cfg.padded_vocab) and logits.dtype == torch.float32
    assert float(aux) == 0.0
    _close(ref_logits[..., :cfg.vocab], logits[..., :cfg.vocab], atol)


@pytest.mark.parametrize("dtype,atol", [("float32", FP32_ATOL), ("bfloat16", BF16_ATOL)])
def test_prefill_and_decode(dtype, atol):
    cfg, ref, params, model = _pair(dtype)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab, size=(2, 45)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab, size=(4, 2, 1)).astype(np.int32)
    rl, rc = ref.prefill(params, jnp.asarray(prompt), pad_to=64)
    with torch.no_grad():
        tl, tc = model.prefill(torch.from_numpy(prompt).long(), pad_to=64)
    assert tc["length"] == 45 and tc["conv"].dtype == torch.bfloat16 and tc["ssm"].dtype == torch.float32
    _close(rl[:, :cfg.vocab], tl[:, :cfg.vocab], atol)
    _close_conv(rc["conv"], tc["conv"], atol)
    _close(rc["ssm"], tc["ssm"], atol)
    for i in range(4):
        rl, rc = ref.decode_step(params, rc, jnp.asarray(feed[i]))
        with torch.no_grad():
            tl, tc = model.decode_step(tc, torch.from_numpy(feed[i]).long())
        assert tc["length"] == 46 + i
        _close(rl[:, :cfg.vocab], tl[:, :cfg.vocab], atol)
        _close(rc["ssm"], tc["ssm"], atol)
    _close_conv(rc["conv"], tc["conv"], atol)


def test_init_matches_reference_statistics():
    """Same shapes, stds and constants as the reference's init (the draws
    differ: torch and JAX generators)."""
    cfg = get_config(ARCH).reduced(dtype="float32")
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    _, _, params, _ = _pair("float32")
    for k, v in model.state_dict().items():
        ref = np.asarray(params[k])
        assert v.shape == ref.shape, k
        if k in ("A_log", "dt_bias", "D", "ln", "ln_f", "norm", "conv_b"):
            np.testing.assert_allclose(v.numpy(), ref, rtol=1e-6, err_msg=k)
        else:
            assert abs(v.float().std().item() / ref.std() - 1) < 0.1, k
    assert (model.embed[cfg.vocab:] == 0).all()
