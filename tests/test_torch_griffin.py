"""The port's GriffinLM against the reference on CPU: the reduced
recurrentgemma-9b (one RRA group; with n_layers=5 also the RR remainder),
the reference's init converted by ``convert.params_from_jax``; the parameter
tree, logits of forward, prefill (and every cache) below and beyond the
attention window, and 4 teacher-forced decode steps that wrap the ring."""
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
from repro_torch.models.rglru import GriffinLM

torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"
# fp32: the two frameworks differ only in summation order (and the RG-LRU
# in the order of its scan: sequential here, associative there)
FP32_ATOL = 2e-5
# fp32 decode: the ring K/V and the conv tails are bf16 in both packages, so
# a last-ulp fp32 difference in prefill can round a cached element to the
# neighbouring bf16 value (2^-8 relative). The decode logits read the ring
# (up to 6.3e-5 seen); the RG-LRU state takes the conv tail times a conv tap
# (|x| ~ 4, |w| ≤ 0.4: up to ~6e-3 moved, 4.4e-4 seen)
DECODE_FP32_ATOL = 2e-4
DECODE_STATE_ATOL = 1e-3
# bf16: eager op for op, one layer of the port equals the reference's
# _apply_layer bit for bit (gelu and sigmoid are written op by op as JAX
# writes them). But the reference runs compiled (jit here, as its engine
# runs it, and lax.scan inside): XLA's fusions round bf16 at other points,
# and one jitted layer differs from the same layer run eagerly by one bf16
# ulp in ~45% of its outputs. Through 5 layers to logits of |logit| ≤ 4
# (bf16 ulp 2^-6 there) that is up to ~6 ulps (0.084 seen): the bound is 8
# ulps, wider than the mamba2 file's 6e-2 (no gates there)
BF16_ATOL = 8 * 2**-6
BF16_RTOL = 2**-7  # one bf16 ulp, for caches


def _pair(dtype, n_layers):
    rcfg = ref_get_config(ARCH).reduced(dtype=dtype, n_layers=n_layers)
    cfg = get_config(ARCH).reduced(dtype=dtype, n_layers=n_layers)
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.key(n_layers))
    model = build_model(cfg, "cpu")
    model.load_state_dict(flatten(params_from_jax(jax.tree.map(np.asarray, params))))
    return cfg, ref, params, model


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """5 layers: the RRA group (``slots``) and the RR remainder (``rem``)."""
    return _pair(request.param, 5)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(), atol=atol, rtol=rtol)


def _atol(cfg, decode=False):
    if cfg.dtype == "bfloat16":
        return BF16_ATOL
    return DECODE_FP32_ATOL if decode else FP32_ATOL


def _close_caches(cfg, rc, tc, decoded=False):
    """Every cache tensor: bf16 ones (conv tails, ring K/V) within one bf16
    ulp of a rounding flip, the fp32 RG-LRU state within the logits' atol
    after prefill and DECODE_STATE_ATOL once decode has read the bf16 conv
    tails."""
    for part in ("slots", "rem"):
        assert len(rc[part]) == len(tc[part])
        for rs, ts in zip(rc[part], tc[part]):
            assert set(rs) == set(ts)
            for name, t in ts.items():
                assert t.shape == rs[name].shape, (part, name)
                if name == "h":
                    assert t.dtype == torch.float32
                    _close(rs[name], t, max(_atol(cfg), DECODE_STATE_ATOL if decoded else 0.0))
                else:
                    assert t.dtype == torch.bfloat16
                    _close(rs[name].astype(jnp.float32), t, _atol(cfg), BF16_RTOL)


@pytest.mark.parametrize("n_layers", [3, 5])
def test_state_dict_matches_reference_tree(n_layers):
    cfg, ref, params, model = _pair("float32", n_layers)
    assert isinstance(model, GriffinLM)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    expect = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(v.shape)
              for path, v in leaves}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == expect
    assert len(model.rem) == cfg.n_layers - 3 and len(model.slots) == 3
    assert "slots.0.mix.w_in" in expect and "slots.2.mix.wq" in expect


@pytest.mark.parametrize("n_layers", [3, 5])
def test_list_tree_round_trip(n_layers):
    """Reference tree → ``params_from_jax`` → ``flatten`` → the model →
    ``state_dict``: every leaf comes back bit for bit, under its path."""
    cfg, ref, params, model = _pair("float32", n_layers)
    flat = flatten(jax.tree.map(np.asarray, params))
    sd = model.state_dict()
    assert set(sd) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(sd[k].float().numpy(), np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("T", [20, 45])  # below and beyond the window of 32
def test_forward_logits(pair, T):
    cfg, ref, params, model = pair
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, T)).astype(np.int32)
    ref_logits, _ = jax.jit(ref.forward)(params, jnp.asarray(tokens))
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(tokens).long())
    assert logits.shape == (2, T, cfg.padded_vocab) and logits.dtype == torch.float32
    assert float(aux) == 0.0
    _close(ref_logits[..., :cfg.vocab], logits[..., :cfg.vocab], _atol(cfg))


@pytest.mark.parametrize("T", [30, 45])  # 4 decode steps cross slot 32 / run on a wrapped ring
def test_prefill_and_decode(pair, T):
    cfg, ref, params, model = pair
    rng = np.random.default_rng(T)
    prompt = rng.integers(0, cfg.vocab, size=(2, T)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab, size=(4, 2, 1)).astype(np.int32)
    rl, rc = jax.jit(ref.prefill)(params, jnp.asarray(prompt))
    with torch.no_grad():
        tl, tc = model.prefill(torch.from_numpy(prompt).long(), pad_to=64)
    assert tc["length"] == T
    _close(rl[:, :cfg.vocab], tl[:, :cfg.vocab], _atol(cfg))
    _close_caches(cfg, rc, tc)
    decode = jax.jit(ref.decode_step)  # as the reference engine runs it
    for i in range(4):
        rl, rc = decode(params, rc, jnp.asarray(feed[i]))
        with torch.no_grad():
            tl, tc = model.decode_step(tc, torch.from_numpy(feed[i]).long())
        assert tc["length"] == T + 1 + i
        _close(rl[:, :cfg.vocab], tl[:, :cfg.vocab], _atol(cfg, decode=True))
    _close_caches(cfg, rc, tc, decoded=True)


def test_init_matches_reference_statistics():
    """Same shapes, stds and constants as the reference's init (the draws
    differ: torch and JAX generators). ``lam`` is ``torch.linspace(0.5, 4,
    w)``; the reference's ``jnp.linspace`` differs from it by at most one
    fp32 ulp (XLA rewrites its division by w − 1 as a product with the
    reciprocal)."""
    cfg = get_config(ARCH).reduced(dtype="float32", n_layers=5)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    params = ref_build_model(ref_get_config(ARCH).reduced(dtype="float32", n_layers=5)).init(jax.random.key(0))
    flat = flatten(jax.tree.map(np.asarray, params))
    for k, v in model.state_dict().items():
        ref = flat[k]
        assert v.shape == ref.shape, k
        if k.endswith(".lam"):
            assert torch.equal(v, torch.linspace(0.5, 4.0, cfg.rnn_width).expand_as(v)), k
            np.testing.assert_array_max_ulp(v.numpy(), ref, maxulp=1)
        elif k.endswith(("ln1", "ln2", "ln_f", "conv_b")):
            assert (v == 0).all() and (ref == 0).all(), k
        else:
            assert abs(v.float().std().item() / ref.std() - 1) < 0.15, k
    assert (model.embed[cfg.vocab:] == 0).all() and (model.out_embed[cfg.vocab:] == 0).all()
