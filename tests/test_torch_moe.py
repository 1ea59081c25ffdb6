"""The port's MoE FFN (``repro_torch.models.moe``) on the CPU against the
reference's ``repro.models.moe._moe_tokens``: same layer parameters (the
reference's init, converted), same seeded inputs, y and the aux loss, at the
prefill and decode (N = 1) shapes of both MoE configs, reduced, in fp32 and
bf16; then an input that overflows the experts' capacity, where the
reference's dispatch also drops the token in slot 0 of every overflowing
expert, and the port must do the same."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import flatten, param_tree, params_from_jax, tensor_to_numpy
from repro_torch.models import build_model, moe
from repro_torch.tree import tree_map

torch.set_num_threads(1)

ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]
# tests/test_kernels.py::_tol: fp32 differs in summation order only; in bf16
# the expert products and the combine round to bf16 (relative 1e-2 above 1)
TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 1e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (B, T): a prefill of two sequences, the engine's B = 1 prefill, decode (N = 1)
SHAPES = [(2, 12), (1, 40), (1, 1)]


def _layer(arch, seed=0, **over):
    """The reduced config of both packages and layer 0 of the reference's
    MoE parameters, as JAX arrays and as torch tensors."""
    rcfg = ref_get_config(arch).reduced(dtype="float32", **over)
    cfg = get_config(arch).reduced(dtype="float32", **over)
    lp = jax.tree.map(lambda a: a[0], jmoe.init_moe(jax.random.key(seed), rcfg))
    return rcfg, cfg, lp, params_from_jax(jax.tree.map(np.asarray, lp))


def _run(arch, B, T, dtype, seed=0, **over):
    rcfg, cfg, jlp, tlp = _layer(arch, seed, **over)
    x = np.random.default_rng(seed + 1).normal(size=(B, T, cfg.d_model)).astype(np.float32)
    jd, td = DTYPES[dtype]
    ry, raux = jmoe._moe_tokens(jlp, jnp.asarray(x, jd), rcfg)
    y, aux = moe.moe_ffn(tlp, torch.from_numpy(x).to(td), cfg)
    return cfg, tlp, x, (ry, raux), (y, aux)


def _close(ref, got, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, B, T, dtype):
    cfg, _, _, (ry, raux), (y, aux) = _run(arch, B, T, dtype)
    assert y.shape == (B, T, cfg.d_model) and y.dtype == DTYPES[dtype][1]
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(ry, y, dtype)
    _close(raux, aux, "float32")  # routing and the aux loss are fp32 in both dtypes


@pytest.mark.parametrize("arch", ARCHS)
def test_params_match_reference_tree(arch):
    """``moe_params`` has the reference's key paths and shapes, and
    ``init_moe_`` draws each leaf with the reference's std."""
    rcfg = ref_get_config(arch).reduced(dtype="float32", d_model=256, d_ff=64)
    cfg = get_config(arch).reduced(dtype="float32", d_model=256, d_ff=64)
    ref_shapes = jax.eval_shape(lambda k: jmoe.init_moe(k, rcfg), jax.random.key(0))
    params = moe.moe_params(cfg, cfg.n_layers, lambda *s: torch.nn.Parameter(torch.zeros(s), requires_grad=False))
    assert {k: tuple(v.shape) for k, v in params.items()} == {k: v.shape for k, v in ref_shapes.items()}
    moe.init_moe_(params, cfg, torch.Generator().manual_seed(0))
    ffs = cfg.n_shared_experts * cfg.d_ff
    stds = {"we_down": cfg.d_ff**-0.5, "ws_down": ffs**-0.5 if ffs else None}
    for name, w in params.items():
        std = stds.get(name, cfg.d_model**-0.5)
        assert abs(w.std().item() - 0.88 * std) < 0.1 * std, name  # trunc(-2, 2) std = 0.88·std
        assert w.abs().max().item() <= 2 * std, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_moe_tree_both_ways(arch, dtype):
    """The reference's whole parameter tree (the ``moe`` subtree's 4-D
    expert leaves included) loads into the port's model and comes back out
    bit for bit, in fp32 and bf16."""
    params = ref_build_model(ref_get_config(arch).reduced(dtype="float32")).init(jax.random.key(2))
    params = jax.tree.map(lambda a: np.asarray(a.astype(jnp.dtype(dtype))), params)
    model = build_model(get_config(arch).reduced(dtype="float32"), "cpu", param_dtype=getattr(torch, dtype))
    model.load_state_dict(flatten(params_from_jax(params)))
    flat, back = flatten(params), flatten(tree_map(tensor_to_numpy, param_tree(model)))
    assert back.keys() == flat.keys() and flat["moe.we_gate"].ndim == 4
    for key, a in flat.items():
        np.testing.assert_array_equal(back[key].view(a.dtype), a, err_msg=key)


@pytest.mark.parametrize("N,k,E,cf", [(1, 4, 60, 1.25), (24, 2, 4, 1.25), (128, 8, 32, 1.25), (256, 2, 4, 0.3),
                                      (1024, 8, 32, 1.25), (5000, 4, 60, 1.25)])
def test_capacity_is_the_reference_expression(N, k, E, cf):
    C = int((N * k / E) * cf) + 1
    assert moe.capacity(N, k, E, cf) == min(max(64, -(-C // 64) * 64), N)


# capacity_factor 0.3 at T 256: N·k/E = 128 slots per expert on average
# against C = 64, so every expert overflows
OVERFLOW = dict(capacity_factor=0.3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_overflow_drops_slot_zero_as_the_reference(arch, dtype):
    """At capacity_factor 0.3 every expert overflows. In the reference each
    dropped slot overwrites its expert's slot 0 with the pad row, so the token
    sorted first for an overflowing expert loses it too. The port's table
    holds the pad there, the token's slots skip that expert, and y equals
    the reference's, while the lost expert's term is over 5× the
    tolerance: keeping it would fail this test."""
    B, T = 1, 256
    cfg, tlp, x, (ry, raux), (y, aux) = _run(arch, B, T, dtype, **OVERFLOW)
    _close(ry, y, dtype)
    _close(raux, aux, "float32")

    N, E, k = B * T, cfg.n_experts, cfg.top_k
    C = moe.capacity(N, k, E, cfg.capacity_factor)
    xt = torch.from_numpy(x).reshape(N, -1)
    probs = torch.softmax(xt @ tlp["router"], dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    table, gates, slots = moe.dispatch(top_i, top_p, E, C)
    lost = 0
    for e in range(E):
        routed = (top_i == e).any(dim=1).nonzero().flatten()  # in token order = the stable sort's order
        if len(routed) <= C:
            continue
        first = int(routed[0])
        assert table[e, 0] == N and gates[e, 0] == 0 and first not in table[e].tolist()
        assert table[e, 1:].tolist() == routed[1:C].tolist()  # the kept slots, positions 1..C-1
        assert (slots[first] != e * C).all()
        # the expert's term that the reference drops for this token
        j = int((top_i[first] == e).nonzero())
        w = {n: tlp[n][e] for n in ("we_gate", "we_up", "we_down")}
        h = torch.nn.functional.silu(xt[first] @ w["we_gate"]) * (xt[first] @ w["we_up"])
        term = (h @ w["we_down"]) * top_p[first, j]
        assert term.abs().max().item() > 5 * TOL[dtype][0]
        lost += 1
    assert lost == E  # every expert overflows here


def test_combine_is_bit_equal_across_calls():
    """The combine adds each token's outputs in a fixed order: two calls give
    the same bits (the overflowing input, bf16)."""
    _, cfg, _, tlp = _layer("qwen2-moe-a2.7b", **OVERFLOW)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 256, cfg.d_model)).astype(np.float32))
    a, b = moe.moe_ffn(tlp, x.bfloat16(), cfg), moe.moe_ffn(tlp, x.bfloat16(), cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
