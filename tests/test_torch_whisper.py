"""The port's WhisperModel against repro.models.whisper on the CPU: one JAX
parameter tree (reference init, its zero leaves drawn small so that biases
and norm scales count) carried across by ``convert``, seeded numpy frame
embeddings, the reduced whisper-small in fp32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_transformer
from repro.models.whisper import sinusoid_pos as ref_sinusoid_pos
from repro_torch.configs import get_config
from repro_torch.convert import flatten, params_from_jax
from repro_torch.kernels import ref as kref
from repro_torch.launch import grad_check
from repro_torch.models import build_model, transformer
from repro_torch.models.whisper import MAX_DEC_POS, WhisperModel, sinusoid_pos
from repro_torch.training.train_step import make_prefill_step

torch.set_num_threads(1)

ATOL = 2e-5  # fp32: the two frameworks differ only in summation order
# bf16: each matmul output rounds to bf16, at slightly different points in
# the two frameworks; logits of magnitude ~3 (a bf16 ulp there is 2^-6), as
# tests/test_torch_transformer.py's BF16_ATOL
BF16_ATOL = 6e-2
B, T = 2, 10


def _pair(dtype="float32", seed=0):
    """(cfg, reference model, its params as numpy, the port's model with them)."""
    rcfg = ref_get_config("whisper-small").reduced(dtype=dtype)
    ref = ref_build_model(rcfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    # norms and biases are zero at init: draw them so that their paths count
    params = jax.tree.map(lambda a: a + rng.normal(0, 0.1, a.shape).astype(a.dtype) if not a.any() else a, params)
    model = build_model(get_config("whisper-small").reduced(dtype=dtype), "cpu")
    model.load_state_dict(flatten(params_from_jax(params)))
    return rcfg, ref, params, model


def _inputs(cfg, seed=1, T=T):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    frames = rng.normal(size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return tokens, frames


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.detach().float().numpy(), atol=atol, rtol=0)


def test_config_matches_reference():
    assert dataclasses.asdict(get_config("whisper-small")) == dataclasses.asdict(ref_get_config("whisper-small"))
    r, t = ref_get_config("whisper-small").reduced(), get_config("whisper-small").reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert (t.enc_layers, t.enc_len, t.activation, t.norm_type) == (2, 16, "gelu", "layernorm")


@pytest.mark.parametrize("T,d", [(1500, 768), (16, 64), (40, 32)])
def test_sinusoid_pos_matches_reference(T, d):
    """Whisper-small's full table, the reduced one and a third width, within
    1e-6: the frequencies are bit-equal, the rest is fp32 sin/cos."""
    pos = sinusoid_pos(T, d)
    assert pos.shape == (T, d) and pos.dtype == torch.float32
    _close(ref_sinusoid_pos(T, d), pos, 1e-6)


def test_encode_matches_reference():
    cfg, ref, params, model = _pair()
    _, frames = _inputs(cfg)
    enc = model.encode(torch.from_numpy(frames))
    assert enc.shape == (B, cfg.enc_len, cfg.d_model)
    _close(ref.encode(params, jnp.asarray(frames)), enc)


@pytest.mark.parametrize("frames", ["given", "zeros"])
def test_forward_and_loss_match_reference(frames):
    """Logits and the masked loss, with seeded frames and with none (zero
    frames in the compute dtype, as the engine serves)."""
    cfg, ref, params, model = _pair()
    tokens, emb = _inputs(cfg)
    emb = emb if frames == "given" else None
    labels = np.roll(tokens, -1, axis=1)
    mask = (np.arange(T) < T - 2).astype(np.float32)[None].repeat(B, 0)
    r_logits, r_aux = ref.forward(params, jnp.asarray(tokens), None if emb is None else jnp.asarray(emb))
    logits, aux = model(torch.from_numpy(tokens).long(), None if emb is None else torch.from_numpy(emb))
    assert logits.shape == (B, T, cfg.padded_vocab) and logits.dtype == torch.float32 and aux.item() == 0.0
    _close(r_logits, logits)
    batch = {"tokens": tokens, "labels": labels, "mask": mask}
    if emb is not None:
        batch["enc_embeds"] = emb
    r_loss, r_metrics = ref.loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    _close(r_loss, loss)
    _close(r_metrics["accuracy"], metrics["accuracy"], 0)


@pytest.mark.parametrize("remat", [True, False])
def test_gradients_match_jax_grad(remat):
    """The loss and every leaf's gradient against ``jax.grad`` of the
    reference's loss (remat recomputes each layer in the backward)."""
    cfg, ref, params, model = _pair()
    tokens, emb = _inputs(cfg)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1), "enc_embeds": emb}
    (r_loss, _), r_grads = jax.value_and_grad(ref.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    model.requires_grad_()
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat)
    loss.backward()
    _close(r_loss, loss)
    grads = {n: p.grad for n, p in model.named_parameters()}
    r_flat = flatten(jax.tree.map(np.asarray, r_grads))
    assert grads.keys() == r_flat.keys()
    for name, g in r_flat.items():
        assert grads[name] is not None, name
        np.testing.assert_allclose(g, grads[name].numpy(), atol=ATOL, rtol=0, err_msg=name)


def test_grad_check_reads_key_biases_against_the_model_scale():
    """``launch/grad_check.compare`` with the reference's gradients in the
    card's place: the key biases' gradients are rounding noise on both sides
    (their exact value is zero), so they, and no other leaf, fall under
    ``NOISE_FLOOR`` and are read over the model's largest gradient, and the
    fp32 gate passes; read over their own scale they would be off by more
    than 100%."""
    cfg, ref, params, model = _pair()
    tokens, emb = _inputs(cfg)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1), "enc_embeds": emb}
    (r_loss, _), r_grads = jax.value_and_grad(ref.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    reference = (float(r_loss), flatten(params_from_jax(jax.tree.map(np.asarray, r_grads))))
    port = grad_check.gradients(model.requires_grad_(), {k: torch.from_numpy(v) for k, v in batch.items()})
    reading = grad_check.compare(reference, port)
    assert grad_check.passes(reading, "float32") and not reading["zero"], reading
    top = max(g.abs().max() for g in port[1].values())
    quiet = {n for n, g in port[1].items() if g.abs().max() < grad_check.NOISE_FLOOR * top}
    assert quiet == {"enc.attn.bk", "dec.attn.bk", "dec.cross.bk"}
    bk = port[1]["dec.cross.bk"]
    assert (reference[1]["dec.cross.bk"] - bk).abs().max() > bk.abs().max()


@pytest.mark.parametrize("T,S", [*grad_check.WHISPER_SHAPES, (77, 300)])
def test_shifted_inputs_show_a_key_past_s_left_unmasked(T, S):
    """What phase 3 of ``chip_smoke.py`` holds the bf16 flash kernel to at
    whisper's shapes, on ``grad_check.shifted_qkv`` inputs. The tensor-core
    kernel zero-fills the keys of its last 64-key tile past S; a fault that
    left them unmasked (``grad_check.MUTANTS``) would add keys of score 0
    and value 0. Here that moves the output by more than 10 bf16
    tolerances, while rounding the exact output to bf16 moves it by less
    than half of one. From N(0, 1) inputs the same fault stays inside the
    tolerance."""
    atol, rtol = grad_check.FLASH_BF16_TOL
    pad = (-S) % 64

    def spread(q, k, v):
        q, k, v = q.float(), k.float(), v.float()
        want = kref.mha_reference(q, k, v, causal=False)
        unmasked = kref.mha_reference(q, torch.cat([k, k.new_zeros(1, pad, 12, 64)], 1),
                                      torch.cat([v, v.new_zeros(1, pad, 12, 64)], 1), causal=False)
        tol = atol + rtol * want.abs()
        return ((want.bfloat16().float() - want).abs() / tol).max(), ((unmasked - want).abs() / tol).max()

    rng = np.random.default_rng(0)
    rounding, fault = spread(*grad_check.shifted_qkv(rng, T, S, torch.bfloat16, "cpu"))
    assert rounding < 0.5 and fault > 10, (rounding, fault)
    qkv = (torch.from_numpy(rng.normal(size=(1, n, 12, 64)).astype(np.float32)).bfloat16() for n in (T, S, S))
    assert spread(*qkv)[1] < 1


def test_prefill_step_passes_the_frames():
    cfg, _, _, model = _pair()
    tokens, emb = _inputs(cfg)
    batch = {"tokens": torch.from_numpy(tokens).long(), "enc_embeds": torch.from_numpy(emb)}
    logits, cache = make_prefill_step(model)(batch)
    expect, _ = model.prefill(batch["tokens"], batch["enc_embeds"])
    assert torch.equal(logits, expect) and cache["length"] == T


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", BF16_ATOL)])
def test_prefill_and_decode_steps_match_reference(dtype, atol):
    """Prefill (logits and the whole cache: self K/V padded to 24 slots,
    cross K/V, length) and 4 teacher-forced decode steps."""
    cfg, ref, params, model = _pair(dtype)
    tokens, emb = _inputs(cfg)
    feed = np.random.default_rng(2).integers(0, cfg.vocab, size=(4, B, 1)).astype(np.int32)
    r_logits, r_cache = ref.prefill(params, jnp.asarray(tokens), jnp.asarray(emb), pad_to=24)
    logits, cache = model.prefill(torch.from_numpy(tokens).long(), torch.from_numpy(emb), pad_to=24)
    _close(r_logits, logits, atol)
    assert cache["length"] == int(r_cache["length"]) == T
    for key in ("k", "v", "ck", "cv"):
        assert cache[key].shape == r_cache[key].shape and cache[key].dtype == torch.bfloat16, key
        # an fp32 element within summation noise of a bf16 rounding boundary
        # may land on the neighbouring bf16 value: one ulp, ≤ 2^-7 relative
        np.testing.assert_allclose(np.asarray(r_cache[key], np.float32), cache[key].float().numpy(),
                                   atol=atol, rtol=2**-7, err_msg=key)
    for i in range(4):
        r_logits, r_cache = ref.decode_step(params, r_cache, jnp.asarray(feed[i]))
        logits, cache = model.decode_step(cache, torch.from_numpy(feed[i]).long())
        _close(r_logits, logits, atol)
        assert cache["length"] == int(r_cache["length"]) == T + i + 1
    np.testing.assert_allclose(np.asarray(r_cache["k"], np.float32), cache["k"].float().numpy(),
                               atol=atol, rtol=2**-7)


def test_prefill_without_frames_matches_reference():
    """The engine's call: no frame embeddings, so zero frames."""
    cfg, ref, params, model = _pair()
    tokens, _ = _inputs(cfg)
    r_logits, r_cache = ref.prefill(params, jnp.asarray(tokens), pad_to=16)
    logits, cache = model.prefill(torch.from_numpy(tokens).long(), pad_to=16)
    _close(r_logits, logits)
    np.testing.assert_allclose(np.asarray(r_cache["ck"], np.float32), cache["ck"].float().numpy(),
                               atol=ATOL, rtol=2**-7)


def test_gelu_mlp_matches_reference_bf16():
    """``apply_mlp``'s gelu branch (tanh approximation written op by op, as
    ``jax.nn.gelu(approximate=True)``) against the reference's in bf16: the
    products round at the same points, so the outputs differ by at most a
    bf16 ulp of an element's magnitude."""
    cfg = get_config("whisper-small").reduced(dtype="bfloat16")
    rng = np.random.default_rng(3)
    lp = {"w_up": rng.normal(0, cfg.d_model**-0.5, (cfg.d_model, cfg.d_ff)),
          "w_down": rng.normal(0, cfg.d_ff**-0.5, (cfg.d_ff, cfg.d_model))}
    h = rng.normal(size=(2, 7, cfg.d_model))
    r = ref_transformer.apply_mlp({k: jnp.asarray(v, jnp.bfloat16) for k, v in lp.items()},
                                  jnp.asarray(h, jnp.bfloat16), cfg)
    t = transformer.apply_mlp({k: torch.tensor(v, dtype=torch.bfloat16) for k, v in lp.items()},
                              torch.tensor(h, dtype=torch.bfloat16), cfg)
    assert t.dtype == torch.bfloat16
    r = np.asarray(r, np.float32)
    np.testing.assert_allclose(r, t.float().numpy(), atol=2**-8 * np.abs(r).max(), rtol=2**-7)


def test_init_matches_reference_statistics():
    """Every leaf of the port's init against the same leaf of the
    reference's: the same shape, zero where the reference's is zero (norms,
    biases, vocab padding rows), else a truncated normal of the same std
    (within 5%) and the same bound (2 std: the largest magnitude within 2%
    of the reference's)."""
    cfg = get_config("whisper-small").reduced(dtype="float32", d_model=128, d_ff=256, vocab=250)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rcfg = ref_get_config("whisper-small").reduced(dtype="float32", d_model=128, d_ff=256, vocab=250)
    r_flat = flatten(jax.tree.map(np.asarray, ref_build_model(rcfg).init(jax.random.key(0))))
    state = model.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: v.shape for k, v in r_flat.items()}
    assert state["dec_pos"].shape == (MAX_DEC_POS, cfg.d_model)
    for name, r in r_flat.items():
        t = state[name].numpy()
        if name == "embed":
            assert not t[cfg.vocab:].any() and not r[cfg.vocab:].any()
            t, r = t[:cfg.vocab], r[:cfg.vocab]
        if not r.any():
            assert not t.any(), name
            continue
        assert abs(t.std() - r.std()) < 0.05 * r.std(), name
        assert abs(np.abs(t).max() - np.abs(r).max()) < 0.02 * np.abs(r).max(), name


def test_model_refuses_other_families():
    with pytest.raises(NotImplementedError):
        WhisperModel(get_config("qwen3-4b").reduced(), "cpu")
