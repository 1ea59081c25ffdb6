"""The gradients of the SSD and RG-LRU kernels' autograd Functions
(``ops.SSDScan``, ``ops.RGLRU``) against ``jax.grad`` of the reference, and
mamba2 and recurrentgemma train steps against the reference's jitted step,
on CPU tensors. Same seeded numpy inputs through both packages, fp32.

On the CPU each Function's forward is its kernel's plain version and its
backward is what the card runs: the kernels' decomposition recomputed in
fp32 and differentiated in torch ops.

Tolerance: ``tests/test_torch_training.py``'s fp32 ``TOL`` (2e-5), read over
each gradient's max|g| (max|Δ| ≤ TOL · max|g|): the two frameworks differ in
summation order only, and a gradient's scale is its own. The train steps
take ``test_dense_train_steps_match_reference``'s reading (absolute ``TOL``,
relative 1e-6 on loss, grad_norm and lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.models import build_model as ref_build_model
from repro.models.mamba2 import ssd_chunked as ref_ssd_chunked
from repro.models.rglru import rglru_scan as ref_rglru_scan
from repro.training import optimizer as ref_opt
from repro.training.train_step import TrainConfig as RefTrainConfig
from repro.training.train_step import init_state as ref_init_state
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import state_from_jax, state_to_jax
from repro_torch.kernels import ops
from repro_torch.models import attention, build_model, mamba2, rglru
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import TrainConfig, make_train_step
from repro_torch.tree import leaves_with_paths

torch.set_num_threads(1)

TOL = 2e-5  # tests/test_torch_training.py's fp32 TOL


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _close_scaled(ref, got, name):
    """max|Δ| within TOL of the reference gradient's max|g|; a gradient that
    is zero in the reference (the final state's with respect to C) is zero."""
    ref, got = np.asarray(ref, np.float32), _np(got)
    assert ref.shape == got.shape, name
    scale = np.abs(ref).max()
    if scale == 0:
        assert not got.any(), name
        return
    err = np.abs(got - ref).max()
    assert err <= TOL * scale, f"{name}: max|d| {err:.3e} over max|g| {scale:.3e} = {err / scale:.3e} > {TOL}"


# which outputs carry a cotangent: both, y only (training drops the final
# state), the final state only
OUTPUTS = {"y and state": (True, True), "y only": (True, False), "state only": (False, True)}


def _loss_weights(rng, y_shape, state_shape, outputs):
    wy, ws = OUTPUTS[outputs]
    return (rng.normal(size=y_shape).astype(np.float32) if wy else None,
            rng.normal(size=state_shape).astype(np.float32) if ws else None)


def _weighted(y, state, wy, ws, to):
    return sum(jnp.sum(o.astype(jnp.float32) * w) if to is jnp else (o.float() * torch.from_numpy(w)).sum()
               for o, w in ((y, wy), (state, ws)) if w is not None)


# ---------------------------------------------------------------------------
# ops.SSDScan
# ---------------------------------------------------------------------------

# (b, t, h, p, n, chunk): t a multiple of the chunk and ragged, chunks 16 and 32
SSD_CASES = [(2, 64, 4, 8, 16, 16), (1, 64, 3, 16, 8, 32), (2, 50, 4, 8, 16, 16), (1, 77, 2, 16, 24, 32)]


@pytest.mark.parametrize("outputs", list(OUTPUTS))
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_function_gradient_matches_jax_grad(case, outputs):
    """ops.SSDScan's outputs and its gradient into x, dA, B and C, against
    jax.grad of repro.models.mamba2.ssd_chunked, with random weights on y and
    on the final state."""
    b, t, h, p, n, chunk = case
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    dA = (-np.abs(rng.normal(size=(b, t, h))) * 0.3).astype(np.float32)
    B_, C_ = (rng.normal(size=(b, t, 1, n)).astype(np.float32) for _ in range(2))
    wy, ws = _loss_weights(rng, (b, t, h, p), (b, h, p, n), outputs)

    def f(*args):
        y, H = ref_ssd_chunked(*args, chunk)
        return _weighted(y, H, wy, ws, jnp), (y, H)

    (_, (ry, rH)), rgrads = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (x, dA, B_, C_)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dA, B_, C_)]
    y, H = ops.SSDScan.apply(*leaves, chunk)
    _weighted(y, H, wy, ws, torch).backward()
    _close_scaled(ry, y, "y")
    _close_scaled(rH, H, "final state")
    for name, r, leaf in zip(("x", "dA", "B", "C"), rgrads, leaves):
        assert leaf.grad.dtype == torch.float32
        _close_scaled(r, leaf.grad, f"d{name}")


# ---------------------------------------------------------------------------
# ops.RGLRU
# ---------------------------------------------------------------------------

# (B, T, W): T one chunk of ops.RGLRU_BACKWARD_CHUNK (64), ragged past one
# and past three chunks
RGLRU_CASES = [(2, 64, 24), (2, 100, 16), (1, 200, 32)]


@pytest.mark.parametrize("outputs", ["y and state", "y only"])
@pytest.mark.parametrize("given_h0", [False, True])
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_function_gradient_matches_jax_grad(case, given_h0, outputs):
    """ops.RGLRU's outputs and its gradient into x, r, i, λ and h0 (when
    given), against jax.grad of repro.models.rglru.rglru_scan (an
    associative scan), with random weights on y and on h_last."""
    B, T, W = case
    assert ops.RGLRU_BACKWARD_CHUNK == 64
    rng = np.random.default_rng(12)
    x = rng.normal(size=(B, T, W)).astype(np.float32)
    r, i = (rng.uniform(size=(B, T, W)).astype(np.float32) for _ in range(2))
    lam = rng.uniform(-1.0, 4.0, size=(W,)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32) if given_h0 else None
    wy, ws = _loss_weights(rng, (B, T, W), (B, W), outputs)
    args = (x, r, i, lam) + ((h0,) if given_h0 else ())

    def f(*a):
        y, h = ref_rglru_scan(*a)
        return _weighted(y, h, wy, ws, jnp), (y, h)

    (_, (ry, rh)), rgrads = jax.value_and_grad(f, argnums=tuple(range(len(args))), has_aux=True)(
        *map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = ops.RGLRU.apply(*leaves, *(() if given_h0 else (None,)))
    _weighted(y, h, wy, ws, torch).backward()
    _close_scaled(ry, y, "y")
    _close_scaled(rh, h, "h_last")
    for name, rg, leaf in zip(("x", "r", "i", "lam", "h0"), rgrads, leaves):
        assert leaf.grad.dtype == torch.float32
        _close_scaled(rg, leaf.grad, f"d{name}")


def test_functions_forward_is_the_entry_point_and_grads_keep_dtypes():
    """Each Function's forward gives its entry point's outputs bit for bit;
    bf16 inputs get bf16 gradients (λ keeps fp32), and on meta tensors the
    backward runs with shapes only."""
    g = torch.Generator().manual_seed(0)
    x, B_, C_ = (torch.randn(s, generator=g) for s in ((1, 40, 2, 8), (1, 40, 1, 16), (1, 40, 1, 16)))
    dA = -torch.rand(1, 40, 2, generator=g)
    rx, rr, ri = torch.randn(2, 30, 12, generator=g), torch.rand(2, 30, 12, generator=g), torch.rand(2, 30, 12,
                                                                                                      generator=g)
    lam = torch.rand(12, generator=g) + 0.5
    for got, want in ((ops.SSDScan.apply(x, dA, B_, C_, 16), ops.ssd_scan(x, dA, B_, C_, 16)),
                      (ops.RGLRU.apply(rx, rr, ri, lam, None), ops.rglru(rx, rr, ri, lam))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for dev in ("cpu", "meta"):
        xs, Bs, Cs = (t.to(dev, torch.bfloat16).requires_grad_() for t in (x, B_, C_))
        y, _ = ops.SSDScan.apply(xs, dA.to(dev), Bs, Cs, 16)
        gx, gB, gC = torch.autograd.grad(y.float().sum(), (xs, Bs, Cs))
        assert [(t.dtype, t.shape, t.device.type) for t in (gx, gB, gC)] == \
            [(torch.bfloat16, s.shape, dev) for s in (xs, Bs, Cs)]
        xr, lr_ = rx.to(dev, torch.bfloat16).requires_grad_(), lam.to(dev).requires_grad_()
        y, _ = ops.RGLRU.apply(xr, rr.to(dev, torch.bfloat16), ri.to(dev, torch.bfloat16), lr_, None)
        gx, gl = torch.autograd.grad(y.float().sum(), (xr, lr_))
        assert (gx.dtype, gx.shape, gl.dtype, gl.shape) == (torch.bfloat16, xr.shape, torch.float32, lr_.shape)


# ---------------------------------------------------------------------------
# the slice as a whole: train steps
# ---------------------------------------------------------------------------

# (arch, layers): mamba2-1.3b reduced; recurrentgemma-9b reduced at 5 layers,
# the RRA group and an RR remainder
TRAIN_CASES = {"mamba2-1.3b": 2, "recurrentgemma-9b": 5}
_REFERENCE = {}


def _reference_steps(arch):
    """The reference's jitted AdamW step with remat, 3 steps from seed 0 on
    TokenPipeline batches (B 4, T 40: ragged against the SSD chunk of 32):
    the initial state, the batches, each step's metrics and the last state."""
    if arch not in _REFERENCE:
        rcfg = ref_get_config(arch).reduced(dtype="float32", n_layers=TRAIN_CASES[arch])
        ref = ref_build_model(rcfg)
        ropt = ref_opt.OptimizerConfig(warmup_steps=2, total_steps=100)
        rstate = ref_init_state(ref, jax.random.key(0), ropt)
        init = jax.tree.map(np.asarray, rstate)
        rstep = jax.jit(ref_make_train_step(ref, RefTrainConfig(opt=ropt, remat=True)))
        pipe = RefPipeline(rcfg.vocab, 4, 40, seed=1)
        batches, metrics = [], []
        for _ in range(3):
            batches.append(pipe.next_batch())
            rstate, rmet = rstep(rstate, jax.tree.map(jnp.asarray, batches[-1]))
            metrics.append(jax.device_get(rmet))
        _REFERENCE[arch] = (init, batches, metrics, jax.device_get(rstate))
    return _REFERENCE[arch]


@pytest.mark.parametrize("route", ["plain", "functions"])
@pytest.mark.parametrize("arch", list(TRAIN_CASES))
def test_ssm_and_hybrid_train_steps_match_reference(arch, route, monkeypatch):
    """3 AdamW steps with remat against the reference's jitted step: loss,
    grad_norm and lr at each, then every leaf of the state. ``plain``: the
    CPU path (the jnp-body ports); ``functions``: the card's path on CPU
    tensors (``device.kernel_path`` taken as true), so the SSD, the RG-LRU
    and attention run through ops.SSDScan, ops.RGLRU and ops.Attention:
    their plain forwards and the backwards the card runs."""
    init, batches, rmetrics, rstate = _reference_steps(arch)
    if route == "functions":
        for module in (mamba2, rglru, attention):
            monkeypatch.setattr(module, "kernel_path", lambda t: True)
    cfg = get_config(arch).reduced(dtype="float32", n_layers=TRAIN_CASES[arch])
    model = build_model(cfg, "cpu")
    state = state_from_jax(init, model)
    model.requires_grad_(True)
    step = make_train_step(model, TrainConfig(opt=opt.OptimizerConfig(warmup_steps=2, total_steps=100), remat=True))
    calls = {"ssd": 0, "rglru": 0}
    for name, fn in (("ssd", "ssd_backward"), ("rglru", "rglru_backward")):
        monkeypatch.setattr(ops, fn, lambda *a, _f=getattr(ops, fn), _n=name: calls.__setitem__(_n, calls[_n] + 1)
                            or _f(*a))
    for batch, rmet in zip(batches, rmetrics):
        state, met = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(met) == set(rmet)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(_np(met[k]), np.float32(rmet[k]), atol=TOL, rtol=1e-6, err_msg=k)
    kind = "ssd" if arch.startswith("mamba2") else "rglru"
    n_kind = cfg.n_layers if kind == "ssd" else (cfg.layer_pattern * cfg.n_layers)[: cfg.n_layers].count("R")
    assert calls == {"ssd": 0, "rglru": 0, kind: 3 * n_kind if route == "functions" else 0}
    got = dict(leaves_with_paths(state_to_jax(state)))
    for path, r in jax.tree_util.tree_flatten_with_path(rstate)[0]:
        np.testing.assert_allclose(_np(got[jax.tree_util.keystr(path)]), np.asarray(r, np.float32), atol=TOL,
                                   rtol=0.0, err_msg=jax.tree_util.keystr(path))
