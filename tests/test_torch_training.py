"""The port's training path against the reference on CPU: the data
pipeline, the loss, the optimizers and their schedule and clip, the
attention gradient of the flash kernel's autograd Function, the dense train
step (with and without gradient accumulation), and the losses of mamba2 and
recurrentgemma. Same seeded numpy inputs through both packages, fp32.

Tolerance: fp32 2e-5 (``tests/test_kernels.py::_tol``) unless a test says
why it differs; the two frameworks differ in summation order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.models import build_model as ref_build_model
from repro.models.attention import full_attention as ref_full_attention
from repro.models.common import softmax_cross_entropy as ref_softmax_cross_entropy
from repro.training import optimizer as ref_opt
from repro.training.train_step import TrainConfig as RefTrainConfig
from repro.training.train_step import init_state as ref_init_state
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import flatten, params_from_jax, state_from_jax, state_to_jax
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import TrainConfig, make_train_step
from repro_torch.tree import leaves_with_paths

torch.set_num_threads(1)

TOL = 2e-5  # fp32
# bf16 (the attention gradient): tests/test_kernels.py::_tol's 2e-2, with
# its relative 1e-2 for entries of magnitude > 1
BF16_TOL = (2e-2, 1e-2)
# tests/test_trainer.py's reduced config, in fp32
ARCH, REDUCED = "llama3-8b", dict(d_model=64, n_layers=2, vocab=512, vocab_pad_multiple=64, dtype="float32")


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(ref, got, atol=TOL, rtol=0.0):
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,host,num_hosts", [(3, 0, 1), (7, 1, 2), (0, 3, 4)])
def test_pipeline_batches_equal_reference_at_equal_state(seed, host, num_hosts):
    extra = {"vision_embeds": ((4, 8), np.float32)}
    ref = RefPipeline(512, 8, 16, seed=seed, host=host, num_hosts=num_hosts, extra_fields=extra)
    port = TokenPipeline(512, 8, 16, seed=seed, host=host, num_hosts=num_hosts, extra_fields=extra)
    for _ in range(3):
        a, b = ref.next_batch(), port.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert port.state_dict() == ref.state_dict()
    # resume at an equal cursor
    port2 = TokenPipeline(512, 8, 16, num_hosts=num_hosts, extra_fields=extra)
    port2.load_state_dict(ref.state_dict())
    a, b = ref.next_batch(), port2.next_batch()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_pipeline_token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(1000, dtype=np.int32).tofile(path)
    ref, port = RefPipeline(512, 4, 16, seed=5, token_file=str(path)), TokenPipeline(512, 4, 16, seed=5,
                                                                                     token_file=str(path))
    for _ in range(2):
        a, b = ref.next_batch(), port.next_batch()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 7, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, 7)).astype(np.int32)
    mask = (rng.uniform(size=(2, 7)) > 0.4).astype(np.float32) if masked else None
    rloss, rmet = ref_softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                            None if mask is None else jnp.asarray(mask))
    rgrad = jax.grad(lambda x: ref_softmax_cross_entropy(x, jnp.asarray(labels),
                                                         None if mask is None else jnp.asarray(mask))[0])(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss, met = softmax_cross_entropy(x, torch.from_numpy(labels), None if mask is None else torch.from_numpy(mask))
    loss.backward()
    assert met.keys() == rmet.keys() == {"loss", "accuracy", "tokens"}
    for k in met:
        _close(rmet[k], met[k])
    _close(rgrad, x.grad)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 500, 999, 1000, 1500])
def test_lr_schedule_matches_reference(step):
    cfg = dict(lr=1e-3, warmup_steps=100, total_steps=1000, min_lr_ratio=0.1)
    ref = float(ref_opt.lr_schedule(ref_opt.OptimizerConfig(**cfg), jnp.asarray(step, jnp.int32)))
    got = opt.lr_schedule(opt.OptimizerConfig(**cfg), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == pytest.approx(ref, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("scale", [3.0, 0.01])
def test_clip_by_global_norm_matches_reference(scale):
    rng = np.random.default_rng(1)
    g = {"a": (rng.normal(size=(10, 3)) * scale).astype(np.float32), "b": (rng.normal(size=5) * scale).astype(np.float32)}
    clipped, rnorm = ref_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    norm = opt.clip_by_global_norm(tg, 1.0)
    _close(rnorm, norm, atol=0, rtol=1e-6)
    for k in g:
        _close(clipped[k], tg[k])


def _opt_tree(rng):
    """A stacked matrix, a factored (≥ 128 × 128) one, a stacked factored
    one, a stacked norm (decayed: 2-D) and a bias (not decayed)."""
    shapes = {"stack": (3, 8, 16), "big": (128, 160), "stack_big": (2, 128, 128), "ln": (3, 16), "b": (16,)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_reference(name):
    cfg_kw = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    rcfg, cfg = ref_opt.OptimizerConfig(**cfg_kw), opt.OptimizerConfig(**cfg_kw)
    rng = np.random.default_rng(2)
    params = _opt_tree(rng)
    rparams = jax.tree.map(jnp.asarray, params)
    rstate = ref_opt.opt_init(rcfg, rparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.opt_init(cfg, tparams)
    assert [p for p, _ in leaves_with_paths(tstate)] == [jax.tree_util.keystr(k) for k, _ in
                                                       jax.tree_util.tree_flatten_with_path(rstate)[0]]
    for _ in range(4):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        rparams, rstate, rlr = ref_opt.opt_update(rcfg, jax.tree.map(jnp.asarray, grads), rstate, rparams)
        tparams, tstate, lr = opt.opt_update(cfg, {k: torch.from_numpy(v) for k, v in grads.items()},
                                             tstate, tparams)
        assert float(lr) == pytest.approx(float(rlr), rel=1e-6)
        for k in params:
            _close(rparams[k], tparams[k])
        for (path, r), (tpath, t) in zip(jax.tree_util.tree_flatten_with_path(rstate)[0],
                                         leaves_with_paths(tstate)):
            assert jax.tree_util.keystr(path) == tpath
            assert t.dtype == (torch.int32 if tpath.endswith("['count']") else torch.float32)
            _close(r, t, rtol=1e-5)


# ---------------------------------------------------------------------------
# the attention gradient
# ---------------------------------------------------------------------------

# (B, T, H, K, D, causal, window, q_chunk): GQA G = 2 and 4, T a multiple of
# q_chunk above it (the reference's chunked path), causal and windowed
ATTN_CASES = [(2, 96, 4, 2, 16, True, None, 32), (1, 128, 8, 2, 16, True, 40, 32),
              (2, 64, 4, 1, 32, False, None, 16), (1, 96, 4, 2, 16, False, 24, 48)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_function_gradient_matches_jax_grad(case, dtype):
    """ops.Attention (the flash kernel's forward, its gradient in torch ops)
    on CPU tensors, against jax.grad of the reference's jnp attention."""
    B, T, H, K, D, causal, window, q_chunk = case
    rng = np.random.default_rng(3)
    q, k, v, w = (rng.normal(size=s).astype(np.float32) for s in
                  ((B, T, H, D), (B, T, K, D), (B, T, K, D), (B, T, H, D)))
    jdt = jnp.dtype(dtype)

    def f(q, k, v):
        o = ref_full_attention(q, k, v, causal=causal, window=window, q_chunk=q_chunk)
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, ro), rg = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    o = ops.Attention.apply(tq, tk, tv, causal, window, q_chunk)
    (o.float() * torch.from_numpy(w)).sum().backward()
    tol = (TOL, 0.0) if dtype == "float32" else BF16_TOL
    _close(ro.astype(jnp.float32), o, *tol)
    for r, t in zip(rg, (tq, tk, tv)):
        assert t.grad.dtype == tdt
        _close(r.astype(jnp.float32), t.grad, *tol)


# ---------------------------------------------------------------------------
# the dense train step
# ---------------------------------------------------------------------------

def _dense_pair(seed=0):
    rcfg = ref_get_config(ARCH).reduced(**REDUCED)
    cfg = get_config(ARCH).reduced(**REDUCED)
    ref = ref_build_model(rcfg)
    model = build_model(cfg, "cpu")
    return rcfg, cfg, ref, model


@pytest.mark.parametrize("accum", [1, 2])
def test_dense_train_steps_match_reference(accum):
    """3 steps of AdamW with remat: loss and grad norm at each, then every
    leaf of the state."""
    rcfg, cfg, ref, model = _dense_pair()
    ropt = ref_opt.OptimizerConfig(warmup_steps=2, total_steps=100)
    rtrain = RefTrainConfig(opt=ropt, accum_steps=accum)
    rstate = ref_init_state(ref, jax.random.key(0), ropt)
    state = state_from_jax(jax.tree.map(np.asarray, rstate), model)
    model.requires_grad_(True)
    train = TrainConfig(opt=opt.OptimizerConfig(warmup_steps=2, total_steps=100), accum_steps=accum)
    rstep, step = jax.jit(ref_make_train_step(ref, rtrain)), make_train_step(model, train)
    pipe = RefPipeline(cfg.vocab, 4, 32, seed=1)
    for _ in range(3):
        batch = pipe.next_batch()
        rstate, rmet = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, met = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(met) == set(rmet)
        for k in ("loss", "grad_norm", "lr"):
            _close(rmet[k], met[k], rtol=1e-6)
    got = dict(leaves_with_paths(state_to_jax(state)))
    for path, r in jax.tree_util.tree_flatten_with_path(jax.device_get(rstate))[0]:
        _close(r, got[jax.tree_util.keystr(path)])


@pytest.mark.parametrize("remat", [True, False])
def test_dense_loss_and_gradients_match_reference(remat):
    """One loss and its gradient for every parameter, with and without remat;
    every parameter's gradient lands in its ``.grad`` (stacked ones through
    their per-layer slices)."""
    rcfg, cfg, ref, model = _dense_pair()
    params = ref.init(jax.random.key(1))
    model.load_state_dict(flatten(params_from_jax(jax.tree.map(np.asarray, params))))
    model.requires_grad_(True)
    batch = RefPipeline(cfg.vocab, 2, 24, seed=2).next_batch()
    (rloss, rmet), rgrad = jax.value_and_grad(
        lambda p: ref.loss(p, jax.tree.map(jnp.asarray, batch), remat=remat, q_chunk=8), has_aux=True)(params)
    loss, met = model.loss({k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat, q_chunk=8)
    loss.backward()
    for k in ("loss", "accuracy", "tokens"):
        _close(rmet[k], met[k])
    grads = flatten({k: v.grad for k, v in dict(model.named_parameters()).items()})
    for key, g in flatten(jax.tree.map(np.asarray, rgrad)).items():
        assert grads[key] is not None and grads[key].abs().sum() > 0, key
        _close(g, grads[key])


@pytest.mark.parametrize("remat", [True, False])
def test_stacked_gradients_land_layer_by_layer(remat):
    """When the backward reaches layer l's input, every later layer's slice
    of the stacked gradients is already written: no layer's gradient waits
    for the rest (``models/common.py::layer_view``)."""
    cfg = get_config(ARCH).reduced(**{**REDUCED, "n_layers": 4})
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0)).requires_grad_()
    wq, seen, block = model.attn["wq"], {}, model._block

    def spy(lp, x, *args):
        l = lp["ln1"].storage_offset() // cfg.d_model

        def hook(g):  # x's gradient is done: layer l's backward has run
            seen.setdefault(l, [wq.grad is not None and bool(wq.grad[j].abs().sum() > 0)
                                for j in range(cfg.n_layers)])

        x.register_hook(hook)
        return block(lp, x, *args)

    model._block = spy
    tokens = torch.from_numpy(RefPipeline(cfg.vocab, 2, 16, seed=0).next_batch()["tokens"])
    loss, _ = model.loss({"tokens": tokens, "labels": tokens}, remat=remat)
    loss.backward()
    assert sorted(seen) == list(range(cfg.n_layers))
    for l, filled in seen.items():
        assert filled[l + 1:] == [True] * (cfg.n_layers - l - 1), (l, filled)
    assert all(wq.grad[j].abs().sum() > 0 for j in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# the other families
# ---------------------------------------------------------------------------

# (arch, config overrides, T): both MoE configs reduced at B 2; then
# granite-moe at capacity_factor 0.3 and T 128 (N 256 against C 64: every
# expert overflows and loses its slot-0 token, tests/test_torch_moe.py)
MOE_CASES = {"granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}, 24),
             "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}, 24),
             "granite-moe-overflow": ("granite-moe-1b-a400m", {"capacity_factor": 0.3}, 128)}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_loss_and_gradients_match_reference(case):
    """The MoE family's loss (cross entropy + router_aux_coef · aux), its
    aux_loss metric, and every parameter's gradient, the router's through
    the gates and the aux loss, with remat."""
    arch, over, T = MOE_CASES[case]
    rcfg = ref_get_config(arch).reduced(dtype="float32", **over)
    cfg = get_config(arch).reduced(dtype="float32", **over)
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.key(5))
    model = build_model(cfg, "cpu")
    model.load_state_dict(flatten(params_from_jax(jax.tree.map(np.asarray, params))))
    model.requires_grad_(True)
    batch = RefPipeline(cfg.vocab, 2, T, seed=4).next_batch()
    (rloss, rmet), rgrad = jax.value_and_grad(
        lambda p: ref.loss(p, jax.tree.map(jnp.asarray, batch), remat=True), has_aux=True)(params)
    loss, met = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert set(met) == set(rmet) and met["aux_loss"].item() > 0
    for k in ("loss", "aux_loss", "accuracy", "tokens"):
        _close(rmet[k], met[k])
    grads = flatten({k: v.grad for k, v in dict(model.named_parameters()).items()})
    for key, g in flatten(jax.tree.map(np.asarray, rgrad)).items():
        assert grads[key] is not None and grads[key].abs().sum() > 0, key
        _close(g, grads[key])

@pytest.mark.parametrize("arch,n_layers", [("mamba2-1.3b", 2), ("recurrentgemma-9b", 5)])
def test_ssm_and_hybrid_loss_match_reference(arch, n_layers):
    """mamba2 and recurrentgemma (the RRA group and an RR remainder): loss,
    accuracy and the gradients' global norm. The RG-LRU runs sequentially
    here and as an associative scan in the reference: summation order only."""
    rcfg = ref_get_config(arch).reduced(dtype="float32", n_layers=n_layers)
    cfg = get_config(arch).reduced(dtype="float32", n_layers=n_layers)
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.key(4))
    model = build_model(cfg, "cpu")
    model.load_state_dict(flatten(params_from_jax(jax.tree.map(np.asarray, params))))
    model.requires_grad_(True)
    batch = RefPipeline(cfg.vocab, 2, 40, seed=3).next_batch()
    (rloss, rmet), rgrad = jax.value_and_grad(
        lambda p: ref.loss(p, jax.tree.map(jnp.asarray, batch), remat=True), has_aux=True)(params)
    loss, met = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    for k in ("loss", "accuracy", "tokens"):
        _close(rmet[k], met[k])
    gnorm = opt.global_norm([p.grad for p in model.parameters()])
    _close(ref_opt.global_norm(rgrad), gnorm, rtol=1e-5)
