"""The port's TransformerLM against the reference on CPU: same parameters
(reference init, converted), same tokens, logits of forward, prefill and a
teacher-forced decode loop."""
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
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.whisper import WhisperModel

torch.set_num_threads(1)

# fp32: the two frameworks differ only in summation order
FP32_ATOL = 1e-4
# bf16: each matmul output rounds to bf16 (2^-8 relative), and the two
# frameworks round at slightly different points (XLA fuses some casts), so a
# one-ulp difference in an early activation reaches the logits. The logits
# here are of magnitude ~3, where a bf16 ulp is 2^-6: the bound is ~4 ulps.
# Inputs are teacher-forced, so a flipped argmax cannot make the sequences
# diverge.
BF16_ATOL = 6e-2

VARIANTS = {
    "qwen3-4b": ("qwen3-4b", {}),
    "llama3-8b": ("llama3-8b", {}),
    "qwen3-4b-padded-vocab": ("qwen3-4b", {"vocab": 250}),
    "llama3-8b-bias-parallel-learned": (
        "llama3-8b", {"attention_bias": True, "parallel_block": True, "pos_emb": "learned"}),
    "llama3-8b-gelu-layernorm": ("llama3-8b", {"activation": "gelu", "norm_type": "layernorm"}),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
    "phi3-medium-14b": ("phi3-medium-14b", {}),
    "command-r-plus-104b": ("command-r-plus-104b", {}),
    "internvl2-76b": ("internvl2-76b", {}),
}
NEW_ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b", "phi3-medium-14b", "command-r-plus-104b", "internvl2-76b"]


def _pair(variant, dtype, seed=0):
    arch, over = VARIANTS[variant]
    rcfg = ref_get_config(arch).reduced(dtype=dtype, **over)
    tcfg = get_config(arch).reduced(dtype=dtype, **over)
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.key(seed))
    model = build_model(tcfg, "cpu")
    model.load_state_dict(flatten(params_from_jax(jax.tree.map(np.asarray, params))))
    return rcfg, ref, params, model


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-4b", "llama3-8b", *NEW_ARCHS])
def test_config_matches_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
    r, t = ref_get_config(arch).reduced(dtype="float32"), get_config(arch).reduced(dtype="float32")
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert (t.padded_vocab, t.resolved_head_dim) == (r.padded_vocab, r.resolved_head_dim)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_logits_fp32(variant):
    cfg, ref, params, model = _pair(variant, "float32")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    ref_logits, ref_aux = ref.forward(params, jnp.asarray(tokens))
    logits, aux = model(torch.from_numpy(tokens).long())
    assert logits.shape == (2, 12, cfg.padded_vocab) and logits.dtype == torch.float32
    _close(ref_logits, logits, FP32_ATOL)
    _close(ref_aux, aux, 2e-5)  # the MoE layers' summed aux loss; 0 in the other families
    assert aux.dtype == torch.float32 and (aux.item() > 0) == (cfg.family == "moe")
    if cfg.padded_vocab != cfg.vocab:
        assert (logits[..., cfg.vocab:] == -1e30).all()


@pytest.mark.parametrize("variant", ["qwen3-4b", "internvl2-76b"])
def test_forward_with_vision_embeds(variant):
    cfg, ref, params, model = _pair(variant, "float32")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, size=(2, 10)).astype(np.int32)
    vis = rng.normal(size=(2, cfg.n_vision_patches or 4, cfg.d_model)).astype(np.float32)
    ref_logits, _ = ref.forward(params, jnp.asarray(tokens), jnp.asarray(vis))
    logits, _ = model(torch.from_numpy(tokens).long(), torch.from_numpy(vis))
    _close(ref_logits, logits, FP32_ATOL)


def test_hidden_states_collects_kv():
    cfg, ref, params, model = _pair("qwen3-4b", "float32")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 9)).astype(np.int32)
    rx, _, (rk, rv) = ref.hidden_states(params, jnp.asarray(tokens), collect_kv=True)
    x, aux, (k, v) = model.hidden_states(torch.from_numpy(tokens).long(), collect_kv=True)
    assert k.shape == rk.shape == (cfg.n_layers, 2, 9, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert aux.item() == 0.0 and model.hidden_states(torch.from_numpy(tokens).long())[2] is None
    for r, t in ((rx, x), (rk, k), (rv, v)):
        _close(r, t, FP32_ATOL)


def _prefill_decode(cfg, ref, params, model, atol, steps=4, T=10, pad_to=24):
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab, size=(2, T)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab, size=(steps, 2, 1)).astype(np.int32)
    r_logits, r_cache = ref.prefill(params, jnp.asarray(prompt), pad_to=pad_to)
    logits, cache = model.prefill(torch.from_numpy(prompt).long(), pad_to=pad_to)
    _close(r_logits, logits, atol)
    assert cache["k"].shape == r_cache["k"].shape and cache["k"].dtype == torch.bfloat16
    assert cache["length"] == int(r_cache["length"]) == T
    for i in range(steps):
        r_logits, r_cache = ref.decode_step(params, r_cache, jnp.asarray(feed[i]))
        logits, cache = model.decode_step(cache, torch.from_numpy(feed[i]).long())
        _close(r_logits, logits, atol)
        assert cache["length"] == int(r_cache["length"]) == T + i + 1
    # the cache holds bf16: an fp32 key within summation noise of a rounding
    # boundary may land on the neighbouring bf16 value, one ulp (≤ 2^-7 relative)
    np.testing.assert_allclose(np.asarray(r_cache["k"], np.float32), cache["k"].float().numpy(),
                               atol=atol, rtol=2**-7)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_decode_fp32(variant):
    _prefill_decode(*_pair(variant, "float32"), FP32_ATOL)


@pytest.mark.parametrize("variant", ["qwen3-4b", "granite-moe-1b-a400m", "qwen2-moe-a2.7b"])
def test_prefill_decode_bf16(variant):
    _prefill_decode(*_pair(variant, "bfloat16"), BF16_ATOL)


def test_init_shapes_and_stds():
    cfg = get_config("qwen3-4b").reduced(dtype="float32", vocab=250, d_model=256, d_ff=512)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    ref_shapes = jax.eval_shape(ref_build_model(ref_get_config("qwen3-4b").reduced(
        dtype="float32", vocab=250, d_model=256, d_ff=512)).init, jax.random.key(0))
    shapes = {k: tuple(v.shape) for k, v in flatten(jax.tree.map(lambda s: s, ref_shapes)).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    w = model.attn["wq"]
    assert abs(w.std().item() - 0.88 * 256**-0.5) < 0.05 * 256**-0.5  # trunc(-2,2) std = 0.88·std
    assert w.abs().max().item() <= 2 * 256**-0.5
    assert (model.embed[cfg.vocab:] == 0).all() and (model.ln1 == 0).all()


def test_audio_family_builds_whisper_with_reference_tree():
    """The registry builds whisper-small as a WhisperModel whose state_dict
    keys and shapes are the reference's tree (at full size, on the meta
    device: no memory), and TransformerLM still refuses the audio family."""
    cfg = get_config("whisper-small")
    model = build_model(cfg, "meta")
    assert isinstance(model, WhisperModel)
    ref_shapes = jax.eval_shape(ref_build_model(ref_get_config("whisper-small")).init, jax.random.key(0))
    shapes = {k: tuple(v.shape) for k, v in flatten(ref_shapes).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    assert shapes["dec_pos"] == (40960, 768) and shapes["enc.attn.wq"] == (12, 768, 768)
    n = sum(v.numel() for v in model.state_dict().values())
    assert 0.26e9 < n < 0.28e9, n
    with pytest.raises(NotImplementedError):
        TransformerLM(cfg.reduced(), "cpu")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"])
def test_moe_builds_transformer_with_reference_tree(arch):
    """The registry builds the MoE family as a TransformerLM whose state_dict
    keys and shapes are the reference's tree (``moe.*`` in place of
    ``mlp.*``), and whose init draws every leaf."""
    cfg = get_config(arch).reduced(dtype="float32")
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert isinstance(model, TransformerLM) and not hasattr(model, "mlp")
    ref_shapes = jax.eval_shape(ref_build_model(ref_get_config(arch).reduced(dtype="float32")).init,
                                jax.random.key(0))
    shapes = {k: tuple(v.shape) for k, v in flatten(ref_shapes).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    assert all(model.moe[k].abs().sum() > 0 for k in model.moe)
