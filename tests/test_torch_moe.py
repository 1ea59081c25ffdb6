"""The port's MoE FFN (``repro_torch.models.moe``) on the CPU against the
reference's ``repro.models.moe._moe_tokens``: same layer parameters (the
reference's init, converted), same seeded inputs, y and the aux loss, at the
prefill and decode (N = 1) shapes of both MoE configs, reduced, in fp32 and
bf16; then an input that overflows the experts' capacity, where the
reference's dispatch also drops the token in slot 0 of every overflowing
expert, and the port must do the same; and the dispatch and combine
Functions (``kernels.ops.MoEDispatch`` / ``MoECombine``) against the
advanced-indexing expressions they replaced, forward and backward, on the
meta device and under gradcheck."""
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
from repro_torch.kernels import ops
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


# ---------------------------------------------------------------------------
# the dispatch and combine Functions (kernels.ops.MoEDispatch / MoECombine)
# against the advanced-indexing expressions they replaced
# ---------------------------------------------------------------------------

# (N, k, E, capacity_factor): qwen2-moe's and granite-moe's routing at N 256,
# and capacity_factor 0.3, where every expert overflows and loses slot 0
ROUTING = [(256, 4, 60, 1.25), (256, 8, 32, 1.25), (256, 2, 4, 0.3)]
GATHER_D = 64


def _routing(N, k, E, C, seed=0):
    """table, slots of ``moe.dispatch`` over a skewed router (a few experts
    take most tokens, so some slots die and some entries drop)."""
    g = torch.Generator().manual_seed(seed)
    scores = torch.randn(N, E, generator=g) + torch.linspace(3.0, 0.0, E)
    top_p, top_i = torch.topk(torch.softmax(scores, -1), k, dim=-1)
    table, _, slots = moe.dispatch(top_i, top_p / top_p.sum(-1, keepdim=True), E, C)
    return table, slots


def _old_dispatch(xt, table):
    return torch.cat([xt, xt.new_zeros(1, xt.shape[1])])[table]


def _old_combine(ye, slots):
    E, C, d = ye.shape
    ye = torch.cat([ye.reshape(E * C, d), ye.new_zeros(1, d)])
    y = ye[slots[:, 0]]
    for j in range(1, slots.shape[1]):
        y = y + ye[slots[:, j]]
    return y


def _gather_inputs(N, k, E, cf, dtype, seed=0):
    C = moe.capacity(N, k, E, cf)
    table, slots = _routing(N, k, E, C, seed)
    g = torch.Generator().manual_seed(seed + 1)
    xt = torch.randn(N, GATHER_D, generator=g).to(DTYPES[dtype][1])
    ye = torch.randn(E, C, GATHER_D, generator=g).to(DTYPES[dtype][1])
    return table, slots, xt, ye


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("N,k,E,cf", ROUTING)
def test_dispatch_and_combine_forward_equal_advanced_indexing(N, k, E, cf, dtype):
    """The Functions' forwards give the bits of ``cat([xt, 0])[table]`` and of
    ``y = ye[slots[:, 0]]; y = y + ye[slots[:, j]]``; the routing has dead
    slots and dropped entries (and in the last case overflowing experts)."""
    table, slots, xt, ye = _gather_inputs(N, k, E, cf, dtype)
    C = table.shape[1]
    assert (table == N).any() and (slots == E * C).any()
    if cf < 1:
        assert (table[:, 0] == N).any()  # an expert overflowed and gave up slot 0
    xe = ops.MoEDispatch.apply(xt, table, slots)
    y = ops.MoECombine.apply(ye, slots, table)
    assert xe.shape == (E, C, GATHER_D) and y.shape == (N, GATHER_D)
    assert xe.dtype == y.dtype == xt.dtype
    assert torch.equal(xe, _old_dispatch(xt, table))
    assert torch.equal(y, _old_combine(ye, slots))


def _bf16_rounding(ref):
    """Half a bf16 ulp of each element of the fp32 ``ref``: one rounding."""
    exp = torch.floor(torch.log2(ref.abs().clamp(min=2.0**-126)))
    return 2.0 ** (exp - 8)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("N,k,E,cf", ROUTING)
def test_dispatch_and_combine_backward_match_autograd(N, k, E, cf, dtype):
    """The backwards (each the other Function's gather through the inverse
    map) against autograd through the old expressions (their ``index_put_``
    accumulation): within 1e-6 in fp32; in bf16 within one rounding of the
    old expressions' gradient taken in fp32, as the card's ``index_put_``
    sums in fp32 and rounds once (the CPU's rounds after every add)."""
    table, slots, xt, ye = _gather_inputs(N, k, E, cf, dtype)
    g = torch.Generator().manual_seed(7)
    d_xe = torch.randn(table.shape + (GATHER_D,), generator=g).to(xt.dtype)
    dy = torch.randn(N, GATHER_D, generator=g).to(xt.dtype)

    def grads(dispatch_fn, combine_fn, dt):
        a, b = (t.to(dt, copy=True).requires_grad_() for t in (xt, ye))
        torch.autograd.backward([dispatch_fn(a), combine_fn(b)], [d_xe.to(dt), dy.to(dt)])
        return a.grad, b.grad

    new_dx, new_dye = grads(lambda a: ops.MoEDispatch.apply(a, table, slots),
                            lambda b: ops.MoECombine.apply(b, slots, table), xt.dtype)
    old_dx, old_dye = grads(lambda a: _old_dispatch(a, table), lambda b: _old_combine(b, slots), torch.float32)
    assert new_dx.dtype == xt.dtype and new_dye.dtype == ye.dtype
    assert torch.equal(new_dye, old_dye.to(ye.dtype))  # a gather: no sum
    if dtype == "float32":
        torch.testing.assert_close(new_dx, old_dx, rtol=0, atol=1e-6)
    else:
        assert ((new_dx.float() - old_dx).abs() <= _bf16_rounding(old_dx)).all()
    live = slots < table.numel()
    assert (new_dx[~live.any(1)] == 0).all()  # a token that lost every expert gets no gradient


@pytest.mark.parametrize("which", ["dispatch", "combine", "both"])
def test_dispatch_and_combine_gradcheck(which):
    """``torch.autograd.gradcheck`` in fp64 on a small routing with dead
    slots, dropped entries and an overflowing expert (C 6 < its count)."""
    N, k, E, C = 16, 2, 3, 6
    table, slots = _routing(N, k, E, C, seed=4)
    assert (table == N).any() and (slots == E * C).any() and (table[:, 0] == N).any()
    g = torch.Generator().manual_seed(5)
    xt = torch.randn(N, 4, generator=g, dtype=torch.float64, requires_grad=True)
    ye = torch.randn(E, C, 4, generator=g, dtype=torch.float64, requires_grad=True)
    fns = {"dispatch": (lambda a: ops.MoEDispatch.apply(a, table, slots), (xt,)),
           "combine": (lambda b: ops.MoECombine.apply(b, slots, table), (ye,)),
           "both": (lambda a: ops.MoECombine.apply(ops.MoEDispatch.apply(a, table, slots).sin(), slots, table),
                    (xt,))}
    fn, inputs = fns[which]
    assert torch.autograd.gradcheck(fn, inputs)


def test_gathers_on_meta_give_shapes_and_count_bytes():
    """The meta route: outputs of the CPU route's shapes and dtypes, and one
    call of each kernel in the tally, forward and backward, with the bytes of
    ``cost.gather_rows`` / ``gather_sum_rows``."""
    from repro_torch.kernels import cost

    N, k, E, cf = ROUTING[0]
    table, slots, xt, ye = _gather_inputs(N, k, E, cf, "bfloat16")
    want_xe, want_y = ops.MoEDispatch.apply(xt, table, slots), ops.MoECombine.apply(ye, slots, table)
    m = {name: t.to("meta") for name, t in dict(table=table, slots=slots, xt=xt, ye=ye).items()}
    a, b = m["xt"].requires_grad_(), m["ye"].requires_grad_()
    with cost.tally() as tal:
        xe, y = ops.MoEDispatch.apply(a, m["table"], m["slots"]), ops.MoECombine.apply(b, m["slots"], m["table"])
        assert tal.calls == {"gather_rows": 1, "gather_sum_rows": 1}
        torch.autograd.backward([xe, y], [torch.empty_like(xe), torch.empty_like(y)])
    assert (xe.shape, xe.dtype, y.shape, y.dtype) == (want_xe.shape, want_xe.dtype, want_y.shape, want_y.dtype)
    assert xe.is_meta and y.is_meta and a.grad.shape == xt.shape and b.grad.shape == ye.shape
    assert tal.calls == {"gather_rows": 2, "gather_sum_rows": 2}
    C, row = table.shape[1], GATHER_D * 2
    rows_bytes = (N * row + E * C * 8 + E * C * row) + (N * row + E * C * 8 + E * C * row)  # xt → xe, dy → d_ye
    sum_bytes = 2 * ((E * C + N) * row + N * k * 8)  # ye → y, d_xe → d_xt
    assert (tal.bytes["gather_rows"], tal.bytes["gather_sum_rows"]) == (rows_bytes, sum_bytes)
    assert tal.flops == {"gather_rows": 0, "gather_sum_rows": 2 * N * (k - 1) * GATHER_D}
