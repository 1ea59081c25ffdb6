"""The port's distribution layer against the reference's ``repro.dist``.

In this process: the sharding rules on fake meshes, the placements they
give, ``constrain`` without a mesh, the logical-axes trees of every family
against the reference's, V4 against the reference's V4, and V6 and V1
against the flag off (outputs and gradients).

Across ranks, on the CPU: one subprocess runs the reference on a (2, 2) mesh
of 4 forced host devices (``XLA_FLAGS``), and four more run the port as 4
gloo ranks on a ``(2, 2)`` ``DeviceMesh`` (rendezvous through a file), each
from the same numpy inputs in an ``.npz``. They hold V3 (the flash-decode
over the ``model``-split cache: the new token in shard 0, in shard 1 and at
S − 1, and the dense path where 2 does not divide S, over a cache placed by
the model's axes too; decode loops over 32 and 31 slots: greedy tokens,
and each step teacher-forced from the reference's own cache) and V2 (the MoE FFN routed per data shard: its output,
aux loss and the model's loss) to the reference, and the placements of a
parameter tree on the real mesh.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.dist import Axes as RefAxes
from repro.dist import default_rules as ref_default_rules
from repro.dist import logical_to_spec as ref_logical_to_spec
from repro.dist.perf import PerfConfig as RefPerfConfig
from repro.dist.perf import perf_context as ref_perf_context
from repro.models import build_model as ref_build_model
from repro.models.attention import full_attention as ref_full_attention
from repro.training.optimizer import OptimizerConfig as RefOptimizerConfig
from repro.training.train_step import state_axes as ref_state_axes
from repro_torch import dist as rdist
from repro_torch.configs import get_config
from repro_torch.convert import param_tree
from repro_torch.dist.perf import PerfConfig, perf_context
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention, build_model
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import state_axes
from repro_torch.tree import leaves_with_paths

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5  # tests/test_kernels.py::_tol, fp32
RUN_TIMEOUT_S = 600


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


MESH = FakeMesh(data=16, model=16)
POD_MESH = FakeMesh(pod=2, data=16, model=16)
# (axes, shape, mesh): tests/test_dist.py's cases
SPEC_CASES = {
    "divisible batch": (("batch", "seq"), (256, 4096), MESH),
    "divisible params": (("layers", "param_embed", "heads"), (32, 4096, 4096), MESH),
    "fallback vocab 49155": (("vocab", "param_embed"), (49155, 1024), MESH),
    "first dim wins": (("experts", "param_embed", "mlp"), (32, 1024, 512), MESH),
    "60 experts fall through": (("experts", "param_embed", "mlp"), (60, 2048, 1408), MESH),
    "multi-pod batch": (("batch", "seq"), (256, 4096), POD_MESH),
    "multi-pod batch 1": (("batch", None), (1, 1), POD_MESH),
    "cache": (("layers", "cache_batch", "kv_seq", "act_kv", None), (36, 8, 256, 8, 128), POD_MESH),
    "short axes": (("batch",), (64, 128, 7), MESH),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_logical_to_spec_matches_reference(case):
    axes, shape, mesh = SPEC_CASES[case]
    want = tuple(ref_logical_to_spec(axes, shape, mesh, ref_default_rules()))
    assert rdist.logical_to_spec(axes, shape, mesh, rdist.default_rules()) == want
    with rdist.mesh_context(None):  # the default rules when none is installed
        assert rdist.logical_to_spec(axes, shape, mesh) == want


def test_rules_and_production_meshes_are_the_reference_s():
    assert rdist.default_rules() == ref_default_rules()
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh(data=2, model=2)
    spec = rdist.logical_to_spec(("layers", "param_embed", "heads"), (2, 64, 32), mesh)
    assert spec == (None, "data", "model")
    assert rdist.to_placements(spec, mesh) == (Shard(1), Shard(2))
    assert rdist.to_placements((("pod", "data"), None), POD_MESH) == (Shard(0), Shard(0), Replicate())
    assert rdist.to_placements((None, None), mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        rdist.to_placements((("data", "pod"),), POD_MESH)
    tree = {"a": torch.zeros(4, 6), "b": [torch.zeros(3)], "n": 5}
    axes = {"a": rdist.Axes("batch", "mlp"), "b": [rdist.Axes("batch")], "n": rdist.Axes()}
    assert rdist.tree_shardings(mesh, tree, axes) == {"a": (Shard(0), Shard(1)), "b": [(Replicate(), Replicate())],
                                                      "n": None}


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.ones(4, 4)
    tree = {"a": x, "b": [x]}
    with rdist.mesh_context(None):
        assert rdist.constrain(x, ("batch", "embed")) is x
        assert rdist.constrain_tree(tree, {"a": rdist.Axes("batch"), "b": [rdist.Axes(None)]}) is tree
    assert rdist.active_mesh() is None
    with rdist.mesh_context(MESH):  # a plain tensor is rank-local: the identity under a mesh too
        assert rdist.active_mesh() is MESH and rdist.constrain(x, ("batch", "embed")) is x


# every family, reduced; arch -> overrides of ``reduced``
FAMILIES = {
    "qwen3-4b": {},
    "llama3-8b-bias-parallel-learned": {"attention_bias": True, "parallel_block": True, "pos_emb": "learned"},
    "llama3-8b-gelu": {"activation": "gelu"},
    "granite-moe-1b-a400m": {},
    "qwen2-moe-a2.7b": {},
    "internvl2-76b": {},
    "mamba2-1.3b": {},
    "recurrentgemma-9b": {"n_layers": 4},  # one RRA group and a remainder R
    "whisper-small": {},
}


def _names(tree):
    """A tree of Axes (either package's) as nested dicts/lists of name tuples."""
    if isinstance(tree, dict):
        return {k: _names(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_names(v) for v in tree]
    assert isinstance(tree, (RefAxes, rdist.Axes)), tree
    return tree.t


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_axes_trees_match_reference(arch):
    name = arch.split("-bias")[0].split("-gelu")[0]
    rcfg = ref_get_config(name).reduced(**FAMILIES[arch])
    tcfg = get_config(name).reduced(**FAMILIES[arch])
    ref, model = ref_build_model(rcfg), build_model(tcfg, "cpu")
    assert _names(model.param_axes()) == _names(ref.param_axes())
    assert _names(model.cache_axes()) == _names(ref.cache_axes())
    # the trees are the port's own: one Axes per parameter and per cache entry, of its rank
    params = param_tree(model)
    ax = dict(leaves_with_paths(model.param_axes()))
    assert {p: len(ax[p]) for p, _ in leaves_with_paths(params)} == {p: t.ndim for p, t in leaves_with_paths(params)}
    cache = model.init_cache(2, 8)
    cax = dict(leaves_with_paths(model.cache_axes()))
    assert {p: len(cax[p]) for p, _ in leaves_with_paths(cache)} == \
        {p: getattr(t, "ndim", 0) for p, t in leaves_with_paths(cache)}
    shapes = jax.eval_shape(ref.init, jax.random.key(0))
    for opt in ("adamw", "adafactor"):
        want = ref_state_axes(ref, RefOptimizerConfig(name=opt), shapes)
        assert _names(state_axes(model, OptimizerConfig(name=opt), params)) == _names(want)


def _qkv(rng, B, T, H, K, hd):
    return (rng.normal(size=(B, T, H, hd)).astype(np.float32), rng.normal(size=(B, T, K, hd)).astype(np.float32),
            rng.normal(size=(B, T, K, hd)).astype(np.float32))


@pytest.mark.parametrize("window", [None, 100, 300])
def test_causal_chunk_growth_matches_reference(window):
    """V4 in the CPU body: the reference's V4 and the port's flag off."""
    q, k, v = _qkv(np.random.default_rng(0), 1, 512, 4, 2, 32)
    with ref_perf_context(RefPerfConfig(causal_chunk_growth=True)):
        want = np.asarray(ref_full_attention(*map(jnp.asarray, (q, k, v)), causal=True, window=window, q_chunk=128))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    base = attention.full_attention(tq, tk, tv, causal=True, window=window, q_chunk=128)
    with perf_context(PerfConfig(causal_chunk_growth=True)):
        opt = attention.full_attention(tq, tk, tv, causal=True, window=window, q_chunk=128)
    np.testing.assert_allclose(opt.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(opt.numpy(), base.numpy(), atol=TOL, rtol=0)


def _loss_and_grads(model, batch, flags):
    for p in model.parameters():
        p.grad = None
    with perf_context(flags):
        loss, _ = model.loss(batch, remat=True, q_chunk=8)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch,dtype", [("qwen3-4b", "float32"), ("qwen3-4b", "bfloat16"),
                                        ("granite-moe-1b-a400m", "float32")])
@pytest.mark.parametrize("flag", ["cast_weights_early", "save_dot_outputs", "causal_chunk_growth"])
def test_v1_v4_v6_loss_and_gradients_equal_the_flag_off(arch, dtype, flag):
    """V6 casts the stacked weights before the layer, V1 saves only
    attn_out and mlp_out under remat, V4 grows the causal key slices
    (T 32 in chunks of 8): the loss and every gradient as with the flag off."""
    cfg = get_config(arch).reduced(dtype=dtype)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0)).requires_grad_()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 32))).long()
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    base_loss, base = _loss_and_grads(model, batch, PerfConfig())
    loss, grads = _loss_and_grads(model, batch, PerfConfig(**{flag: True}))
    if flag == "causal_chunk_growth":  # a different summation: within the tolerance
        torch.testing.assert_close(loss, base_loss, atol=TOL, rtol=0)
        for n in base:
            torch.testing.assert_close(grads[n], base[n], atol=TOL, rtol=0)
    else:  # the same arithmetic: the same bits
        assert torch.equal(loss, base_loss)
        assert all(torch.equal(grads[n], base[n]) for n in base)


@pytest.fixture
def one_rank(tmp_path):
    """A 1-rank gloo group (file rendezvous) and its (1, 1) mesh, destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)
    try:
        yield make_host_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("path", ["V3 refuses", "V2 gives gradients", "V9 gives gradients"])
def test_explicit_paths_under_autograd(one_rank, path):
    """V3 (decode over a placed cache) stays forward only and raises under
    autograd; V2 and V9 have a backward: at one rank their gradients are
    the plain path's (4 ranks: ``test_v2_gradients_match_reference``,
    ``test_v9_function_gradients_match_the_plain_product``)."""
    from repro_torch.models.moe import _moe_tokens, moe_ffn_local
    from repro_torch.models.transformer import RowParallel

    mesh, g = one_rank, torch.Generator().manual_seed(0)
    if path == "V3 refuses":
        q, kn, vn = (torch.randn(2, 1, h, 8, generator=g) for h in (8, 4, 4))
        kc = rdist.distribute_tree(torch.zeros(2, 16, 4, 8), mesh, rdist.Axes("cache_batch", "kv_seq", "act_kv", None))
        q.requires_grad_()
        with rdist.mesh_context(mesh), pytest.raises(RuntimeError, match="no backward"):
            attention.sharded_decode_update_attend(q, kc, kc.clone(), kn, vn, 3)
        return
    if path == "V2 gives gradients":
        cfg = get_config("qwen2-moe-a2.7b").reduced(dtype="float32")
        model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0)).requires_grad_()
        lp = {k: v[0].detach().clone().requires_grad_() for k, v in model.moe.items()}
        x = torch.randn(4, 2, cfg.d_model, generator=g, requires_grad=True)

        def run(fn):
            y, aux = fn(lp, x, cfg)
            (y.square().sum() + aux).backward()
            grads = [t.grad.clone() for t in (x, *lp.values())]
            for t in (x, *lp.values()):
                t.grad = None
            return grads

        want = run(_moe_tokens)
        with rdist.mesh_context(mesh):
            got = run(moe_ffn_local)
    else:
        u = torch.randn(4, 8, 64, generator=g, requires_grad=True)
        w = torch.randn(64, 32, generator=g, requires_grad=True)
        dy = torch.randn(4, 8, 32, generator=g)
        (u @ w).backward(dy)
        want = [u.grad.clone(), w.grad.clone()]
        u.grad = w.grad = None
        RowParallel.apply(u, w, mesh).backward(dy)
        got = [u.grad, w.grad]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=TOL, rtol=0)


def test_sharded_decode_refuses_a_plain_cache_that_model_splits():
    """Where ``model`` divides S the cache must be placed on the mesh; a
    plain cache where it does not takes the dense path, as without a mesh."""
    g = torch.Generator().manual_seed(0)
    q, kn, vn = (torch.randn(2, 1, h, 8, generator=g) for h in (8, 4, 4))
    kc, vc = torch.randn(2, 16, 4, 8, generator=g), torch.randn(2, 16, 4, 8, generator=g)
    with rdist.mesh_context(FakeMesh(data=2, model=2)), pytest.raises(ValueError, match="placed on the mesh"):
        attention.sharded_decode_update_attend(q, kc, vc, kn, vn, 3)
    kc, vc = kc[:, :15].clone(), vc[:, :15].clone()
    want = attention.decode_attention(q, attention.update_cache(kc.clone(), kn, 3),
                                      attention.update_cache(vc.clone(), vn, 3), 4)
    with rdist.mesh_context(FakeMesh(data=2, model=2)):
        out, kc, vc = attention.sharded_decode_update_attend(q, kc, vc, kn, vn, 3)
    assert torch.equal(out, want) and torch.equal(kc[:, 3], kn[:, 0]) and torch.equal(vc[:, 3], vn[:, 0])


# ---------------------------------------------------------------------------
# across ranks: the reference on 4 host devices, the port on 4 gloo ranks
# ---------------------------------------------------------------------------

DENSE = dict(d_model=64, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=8, d_ff=128, vocab=256,
             vocab_pad_multiple=64, dtype="float32")  # tests/test_perf_variants.py's
# V3 at the function: (case, S, positions); S 16 splits in two shards of 8
V3_CASES = (("even", 16, (3, 11, 15)), ("odd", 15, (5,)))
# how the port's cache is placed: "placed" by the reference's own cache spec
# (batch over data, S over model), "act_kv" by the model's layer axes (where
# 2 does not divide S the KV heads take model), "plain" not at all
PLACEMENTS = {"placed": ("cache_batch", "kv_seq", None, None), "act_kv": ("cache_batch", "kv_seq", "act_kv", None),
              "plain": None}
V3_RUNS = [(c, p, "placed") for c, _, ps in V3_CASES for p in ps] + [("odd", 5, "act_kv"), ("odd", 5, "plain")]
# the decode loops' cache lengths: 2 divides 32 and not 31
B, H, K, D, T_PROMPT, PADS, STEPS = 4, 8, 4, 8, 16, (32, 31), 4

REF = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.dist import mesh_context, tree_shardings
    from repro.dist.perf import PerfConfig, perf_context
    from repro.launch.mesh import make_host_mesh
    from repro.models import build_model
    from repro.models.attention import sharded_decode_update_attend
    from repro.models.moe import moe_ffn

    d, dense = sys.argv[1], json.loads(sys.argv[2])
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    mesh = make_host_mesh((2, 2))
    out = {}

    def flat(tree):
        return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(x)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

    V3 = PerfConfig(sharded_decode_attn=True)
    with mesh_context(mesh), perf_context(V3):
        for case, S, poss in %(cases)r:
            for pos in poss:
                o, kc, vc = jax.jit(sharded_decode_update_attend)(
                    jnp.asarray(inp["q"]), jnp.asarray(inp["k_" + case], jnp.bfloat16),
                    jnp.asarray(inp["v_" + case], jnp.bfloat16), jnp.asarray(inp["k_new"]),
                    jnp.asarray(inp["v_new"]), jnp.int32(pos))
                for k, x in (("out", o), ("k", kc), ("v", vc)):
                    out[f"v3_{case}_{pos}_{k}"] = np.asarray(x, np.float32)

    cfg = get_config("llama3-8b").reduced(**dense)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    np.savez(os.path.join(d, "dense_params.npz"), **flat(params))
    specs = tree_shardings(mesh, params, model.param_axes())
    with open(os.path.join(d, "specs.json"), "w") as f:
        json.dump({jax.tree_util.keystr(p, simple=True, separator="."): [list(e) if isinstance(e, tuple) else e
                                                                         for e in s.spec]
                   for p, s in jax.tree_util.tree_flatten_with_path(specs)[0]}, f)
    for pad in %(pads)r:
        with mesh_context(mesh), perf_context(V3):
            logits, cache = jax.jit(lambda p, t: model.prefill(p, t, pad_to=pad))(params, jnp.asarray(inp["tokens"]))
            step = jax.jit(model.decode_step)
            steps, toks, caches = [logits], [], [cache]
            for _ in range(%(steps)d):
                tok = jnp.argmax(steps[-1][:, :cfg.vocab], axis=-1).astype(jnp.int32)
                toks.append(tok)
                logits, cache = step(params, cache, tok[:, None])
                steps.append(logits)
                caches.append(cache)
        out[f"v3_logits_{pad}"] = np.stack([np.asarray(x) for x in steps])
        out[f"v3_tokens_{pad}"] = np.stack([np.asarray(x) for x in toks])
        for k in ("k", "v"):  # the cache entering each step, and the last step's (bf16 values, exact in fp32)
            out[f"v3_cache_{k}_{pad}"] = np.stack([np.asarray(c[k], np.float32) for c in caches])
        out[f"v3_cache_length_{pad}"] = np.array([int(c["length"]) for c in caches])

    cfg = get_config("qwen2-moe-a2.7b").reduced(dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    np.savez(os.path.join(d, "moe_params.npz"), **flat(params))
    tokens = jnp.asarray(inp["moe_tokens"])
    lp = jax.tree.map(lambda a: a[0], params["moe"])
    with perf_context(PerfConfig(moe_local_dispatch=True)), mesh_context(mesh):
        loss, _ = jax.jit(lambda p, b: model.loss(p, b, remat=False))(params, {"tokens": tokens, "labels": tokens})
        y, aux = jax.jit(lambda lp, x: moe_ffn(lp, x, cfg))(lp, jnp.asarray(inp["moe_x"]))
    out.update(v2_loss=np.asarray(loss), v2_y=np.asarray(y), v2_aux=np.asarray(aux))
    batch = {"tokens": tokens, "labels": tokens}
    with perf_context(PerfConfig(moe_local_dispatch=True)), mesh_context(mesh):
        (loss, _), grads = jax.jit(jax.value_and_grad(lambda p: model.loss(p, batch, remat=True), has_aux=True))(params)
    out["v2_grad_loss"] = np.asarray(loss)
    out.update({"v2_grad|" + k: v for k, v in flat(grads).items()})
    np.savez(os.path.join(d, "ref.npz"), **out)
""") % dict(cases=V3_CASES, pads=PADS, steps=STEPS)

PORT = textwrap.dedent("""
    import json, os, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, d, dense = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
    dist.init_process_group("gloo", init_method="file://" + os.path.join(d, "rendezvous"), rank=rank, world_size=4)
    from torch.distributed.tensor import Replicate
    from repro_torch import dist as rdist
    from repro_torch.configs import get_config
    from repro_torch.convert import param_tree
    from repro_torch.dist.perf import PerfConfig, perf_context
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.attention import sharded_decode_update_attend
    from repro_torch.models.moe import moe_ffn
    from repro_torch.tree import leaves_with_paths

    mesh = make_host_mesh((2, 2), ("data", "model"), "cpu")
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    ref = dict(np.load(os.path.join(d, "ref.npz")))
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt)
    full = lambda x: (x.full_tensor() if rdist.is_dtensor(x) else x).float().numpy()
    out = {}

    def load(arch, path, **over):
        model = build_model(get_config(arch).reduced(**over), "cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in np.load(path).items()})
        return model

    V3 = PerfConfig(sharded_decode_attn=True)
    with torch.no_grad():
        for case, pos, placed in %(runs)r:
            kc, vc = t(inp["k_" + case], torch.bfloat16), t(inp["v_" + case], torch.bfloat16)
            axes = %(placements)r[placed]
            tag = f"v3_{case}_{pos}_{placed}"
            if axes is not None:
                pl = rdist.to_placements(rdist.logical_to_spec(axes, kc.shape, mesh), mesh)
                kc, vc = rdist.shard_tensor(kc, mesh, pl), rdist.shard_tensor(vc, mesh, pl)
                out[tag + "_placements"] = np.array(repr(pl))
            with rdist.mesh_context(mesh), perf_context(V3):
                o, kc, vc = sharded_decode_update_attend(t(inp["q"]), kc, vc, t(inp["k_new"]), t(inp["v_new"]), pos)
            out.update({tag + "_out": o.numpy(), tag + "_k": full(kc), tag + "_v": full(vc)})

        model = load("llama3-8b", os.path.join(d, "dense_params.npz"), **dense)
        for pad in %(pads)r:
            with rdist.mesh_context(mesh), perf_context(V3):
                logits, cache = model.prefill(t(inp["tokens"], torch.long), pad_to=pad)
                cache = rdist.distribute_tree(cache, mesh, model.cache_axes())
                steps, toks = [logits], []
                for _ in range(%(steps)d):
                    tok = steps[-1][:, :model.cfg.vocab].argmax(-1)
                    toks.append(tok)
                    logits, cache = model.decode_step(cache, tok[:, None])
                    steps.append(logits)
            out[f"v3_logits_{pad}"] = torch.stack(steps).numpy()
            out[f"v3_tokens_{pad}"] = torch.stack(toks).numpy()
            out[f"v3_cache_local_shape_{pad}"] = np.array(cache["k"].to_local().shape)
            logits, cache = model.prefill(t(inp["tokens"], torch.long), pad_to=pad)  # no mesh, the dense decode
            steps = [logits]
            for tok in toks:
                logits, cache = model.decode_step(cache, tok[:, None])
                steps.append(logits)
            out[f"dense_logits_{pad}"] = torch.stack(steps).numpy()
            # each step from the reference's own cache and token: V3 on the
            # cache placed by the model's axes, and the dense step beside it
            tf = {key: [] for key in ("v3_logits", "v3_k", "v3_v", "dense_logits")}
            for i in range(%(steps)d):
                pos = int(ref[f"v3_cache_length_{pad}"][i])
                tok = t(ref[f"v3_tokens_{pad}"][i], torch.long)[:, None]
                fresh = lambda: {"k": t(ref[f"v3_cache_k_{pad}"][i], torch.bfloat16),
                                 "v": t(ref[f"v3_cache_v_{pad}"][i], torch.bfloat16), "length": pos}
                with rdist.mesh_context(mesh), perf_context(V3):
                    logits, cache = model.decode_step(rdist.distribute_tree(fresh(), mesh, model.cache_axes()), tok)
                tf["v3_logits"].append(logits.numpy())
                tf["v3_k"].append(full(cache["k"])[:, :, pos])
                tf["v3_v"].append(full(cache["v"])[:, :, pos])
                tf["dense_logits"].append(model.decode_step(fresh(), tok)[0].numpy())
            out.update({f"tf_{key}_{pad}": np.stack(v) for key, v in tf.items()})

        params = param_tree(model)
        specs = {p: [list(e) if isinstance(e, tuple) else e for e in rdist.logical_to_spec(ax.t, x.shape, mesh)]
                 for (p, x), (_, ax) in zip(leaves_with_paths(params), leaves_with_paths(model.param_axes()))}
        placed = rdist.distribute_tree(params, mesh, model.param_axes())
        out["placed_equal"] = np.array(all(torch.equal(a.full_tensor(), b) for (_, a), (_, b)
                                           in zip(leaves_with_paths(placed), leaves_with_paths(params))))
        x = torch.arange(4 * 8 * 64, dtype=torch.float32).view(4, 8, 64)
        with rdist.mesh_context(mesh):
            y = rdist.constrain(rdist.shard_tensor(x, mesh, (Replicate(), Replicate())), ("batch", "seq", "embed"))
        lo = 2 * mesh.get_local_rank("data")
        out["constrain_ok"] = np.array(torch.equal(y.to_local(), x[lo:lo + 2]) and torch.equal(y.full_tensor(), x))

        model = load("qwen2-moe-a2.7b", os.path.join(d, "moe_params.npz"), dtype="float32")
        tokens = t(inp["moe_tokens"], torch.long)
        with perf_context(PerfConfig(moe_local_dispatch=True)), rdist.mesh_context(mesh):
            loss, _ = model.loss({"tokens": tokens, "labels": tokens}, remat=False)
            y, aux = moe_ffn(model._layer(0)["moe"], t(inp["moe_x"]), model.cfg)
        out.update(v2_loss=loss.numpy(), v2_y=y.numpy(), v2_aux=aux.numpy())

    # V2's gradients: the train step's, its rows of the batch on each data rank
    from repro_torch.models.transformer import RowParallel
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_step import TrainConfig, accumulate_grads, init_state, place_state
    from repro_torch.tree import leaves
    opt = OptimizerConfig()
    state = place_state(model, init_state(model, None, opt), opt, mesh)
    with perf_context(PerfConfig(moe_local_dispatch=True)), rdist.mesh_context(mesh):
        metrics = accumulate_grads(model, leaves(state["params"]), {"tokens": tokens, "labels": tokens}, TrainConfig())
    out["v2_grad_loss"] = metrics["loss"].numpy()
    out.update({"v2_grad|" + n: p.grad.full_tensor().numpy() for n, p in model.named_parameters()})
    # V9's Function on fp32 CPU tensors, F split over the model ranks
    u, w = t(inp["v9_u"]).requires_grad_(), t(inp["v9_w"]).requires_grad_()
    y = RowParallel.apply(u, w, mesh)
    y.backward(t(inp["v9_dy"]))
    out.update(v9_y=y.detach().numpy(), v9_du=u.grad.numpy(), v9_dw=w.grad.numpy())
    u, w = t(inp["v9_u"]).requires_grad_(), t(inp["v9_w"]).requires_grad_()
    y = u @ w  # the plain product
    y.backward(t(inp["v9_dy"]))
    out.update(plain_y=y.detach().numpy(), plain_du=u.grad.numpy(), plain_dw=w.grad.numpy())
    np.savez(os.path.join(d, f"port{rank}.npz"), **out)
    if rank == 0:
        with open(os.path.join(d, "port_specs.json"), "w") as f:
            json.dump({p[2:-2].replace("']['", "."): s for p, s in specs.items()}, f)
    dist.destroy_process_group()
""") % dict(runs=V3_RUNS, placements=PLACEMENTS, pads=PADS, steps=STEPS)


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs (one subprocess), then the port's from 4 gloo
    ranks: (ref, [port rank 0..3], ref specs, port specs)."""
    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    inputs = {"q": rng.normal(size=(B, 1, H, D)), "k_new": rng.normal(size=(B, 1, K, D)),
              "v_new": rng.normal(size=(B, 1, K, D)),
              "tokens": rng.integers(0, 256, size=(B, T_PROMPT)), "moe_tokens": rng.integers(0, 256, size=(4, 32)),
              "moe_x": rng.normal(size=(4, 32, 64)), "v9_u": rng.normal(size=(4, 8, 64)),
              "v9_w": rng.normal(size=(64, 32)), "v9_dy": rng.normal(size=(4, 8, 32))}
    for case, S, _ in V3_CASES:
        inputs["k_" + case], inputs["v_" + case] = rng.normal(size=(B, S, K, D)), rng.normal(size=(B, S, K, D))
    np.savez(d / "inputs.npz", **{k: v.astype(np.int32 if v.dtype.kind == "i" else np.float32)
                                  for k, v in inputs.items()})
    dense = json.dumps(DENSE)
    res = subprocess.run([sys.executable, "-c", REF, str(d), dense], capture_output=True, text=True, env=_env(),
                         cwd=str(ROOT), timeout=RUN_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    procs = [subprocess.Popen([sys.executable, "-c", PORT, str(r), str(d), dense], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=_env(), cwd=str(ROOT)) for r in range(4)]
    try:
        logs = [p.communicate(timeout=RUN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    return (dict(np.load(d / "ref.npz")), [dict(np.load(d / f"port{r}.npz")) for r in range(4)],
            json.loads((d / "specs.json").read_text()), json.loads((d / "port_specs.json").read_text()))


def _same_on_every_rank(ports, key):
    for p in ports[1:]:
        np.testing.assert_array_equal(p[key], ports[0][key])
    return ports[0][key]


@pytest.mark.parametrize("case,pos,placed", V3_RUNS)
def test_sharded_decode_matches_reference(runs, case, pos, placed):
    """pos 3 in shard 0, 11 in shard 1, 15 = S − 1; S 15: the dense path,
    over a cache placed with the batch on data (by the model's axes, the KV
    heads on model too) or not placed. The output within 2e-5; the caches,
    written by their owner, equal."""
    ref, ports, _, _ = runs
    tag = f"v3_{case}_{pos}_{placed}"
    if placed == "act_kv":
        assert str(ports[0][tag + "_placements"]) == "(Shard(dim=0), Shard(dim=2))"
    np.testing.assert_allclose(_same_on_every_rank(ports, tag + "_out"), ref[f"v3_{case}_{pos}_out"], atol=TOL,
                               rtol=0)
    for k in ("k", "v"):
        np.testing.assert_array_equal(_same_on_every_rank(ports, f"{tag}_{k}"), ref[f"v3_{case}_{pos}_{k}"])


def _bf16_ulps(a, b) -> np.ndarray:
    """Elementwise distance in bf16 ulps of two fp32 arrays holding bf16
    values (bits ordered through zero: one ulp apart across it too)."""
    def ordered(x):
        bits = (np.ascontiguousarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)

    return np.abs(ordered(a) - ordered(b))


def _decode_loop_matches_reference(runs, pad) -> tuple:
    """The loop: tokens equal to the reference's V3 loop, the prefill's
    logits within 2e-5 of its, the port's V3 logits within 2e-5 of its dense
    decode over the same tokens. Each step teacher-forced from the cache the
    reference's V3 loop had at that step: the slot the port's V3 step writes
    equals the reference's written slot, or differs from it by one bf16 ulp
    in some elements (fp32 K/V of another summation order on a rounding
    boundary); where bit-equal, the step's logits are within 2e-5 of the
    reference's; where not, the flipped elements are named and the logits
    held within 2e-5 of the port's dense step from the same cache (the flip
    moves both alike, by up to ~1e-4). Returns a rank's local cache shape."""
    ref, ports, _, _ = runs
    logits = _same_on_every_rank(ports, f"v3_logits_{pad}")
    np.testing.assert_array_equal(_same_on_every_rank(ports, f"v3_tokens_{pad}"), ref[f"v3_tokens_{pad}"])
    np.testing.assert_allclose(logits, ports[0][f"dense_logits_{pad}"], atol=TOL, rtol=0)
    np.testing.assert_allclose(logits[0], ref[f"v3_logits_{pad}"][0], atol=TOL, rtol=0)
    tf_logits = _same_on_every_rank(ports, f"tf_v3_logits_{pad}")
    for i in range(STEPS):
        pos = int(ref[f"v3_cache_length_{pad}"][i])
        flipped = []
        for k in ("k", "v"):
            got, want = _same_on_every_rank(ports, f"tf_v3_{k}_{pad}")[i], ref[f"v3_cache_{k}_{pad}"][i + 1][:, :, pos]
            ulps = _bf16_ulps(got, want)
            assert ulps.max() <= 1, f"step {i}: written {k} slot {pos} is {ulps.max()} bf16 ulps from the reference's"
            flipped += [(k, *map(int, e)) for e in np.argwhere(ulps == 1)]
        if not flipped:
            np.testing.assert_allclose(tf_logits[i], ref[f"v3_logits_{pad}"][i + 1], atol=TOL, rtol=0,
                                       err_msg=f"step {i}, written slot bit-equal to the reference's")
        else:
            print(f"pad {pad} step {i}: elements (k/v, layer, sequence, kv head, dim) one bf16 ulp from the "
                  f"reference's: {flipped}")
            np.testing.assert_allclose(tf_logits[i], ports[0][f"tf_dense_logits_{pad}"][i], atol=TOL, rtol=0,
                                       err_msg=f"step {i}, flipped elements {flipped}")
    return tuple(ports[0][f"v3_cache_local_shape_{pad}"])


def test_sharded_decode_loop_matches_reference(runs):
    """A greedy decode loop of the dense model with the cache placed on the
    mesh by its ``cache_axes`` (each rank holds 2 sequences × 16 of the 32
    slots)."""
    assert _decode_loop_matches_reference(runs, 32) == (DENSE["n_layers"], B // 2, 32 // 2, 4, 8)


def test_sharded_decode_loop_over_an_odd_cache_matches_reference(runs):
    """The same loop over 31 slots: 2 does not divide S, so the KV heads take
    ``model`` (each rank holds 2 sequences × 2 of the 4 heads) and V3 takes
    its dense path on them, as the reference's does."""
    assert _decode_loop_matches_reference(runs, 31) == (DENSE["n_layers"], B // 2, 31, 4 // 2, 8)


def test_moe_local_dispatch_matches_reference(runs):
    """V2 on the (2, 2) mesh: each data rank routes its 2 sequences, capacity
    from its own 64 tokens; output gathered, aux averaged, model loss."""
    ref, ports, _, _ = runs
    for key in ("v2_y", "v2_aux", "v2_loss"):
        np.testing.assert_allclose(_same_on_every_rank(ports, key), ref[key], atol=TOL, rtol=0)


def test_v2_gradients_match_reference(runs):
    """V2 in the train step on the (2, 2) mesh: each data rank runs its 2
    sequences, routes them with its own capacity, and averages the aux loss
    (its backward the same mean); the loss and every parameter's gradient,
    gathered, against ``jax.value_and_grad`` of the reference's loss under
    its V2 (remat on in both)."""
    ref, ports, _, _ = runs
    np.testing.assert_allclose(_same_on_every_rank(ports, "v2_grad_loss"), ref["v2_grad_loss"], atol=TOL, rtol=0)
    keys = [k for k in ref if k.startswith("v2_grad|")]
    assert keys and set(keys) == {k for k in ports[0] if k.startswith("v2_grad|")}
    for k in keys:
        np.testing.assert_allclose(_same_on_every_rank(ports, k), ref[k], atol=TOL, rtol=0, err_msg=k)


def test_v9_function_gradients_match_the_plain_product(runs):
    """V9's autograd Function called directly on the (2, 2) mesh with fp32
    CPU tensors (each ``model`` rank multiplies its half of F; the wrapper
    takes this path on CUDA tensors only): y, dU and dW against ``u @ w``
    and its autograd gradients."""
    _, ports, _, _ = runs
    for key in ("y", "du", "dw"):
        np.testing.assert_allclose(_same_on_every_rank(ports, "v9_" + key), ports[0]["plain_" + key], atol=TOL,
                                   rtol=0, err_msg=key)


def test_placements_on_a_gloo_mesh_match_reference(runs):
    """The dense model's parameter specs on the real (2, 2) mesh equal the
    reference's ``tree_shardings`` on its 4 devices; ``distribute_tree``
    places every parameter (its shards make the whole again), and
    ``constrain`` redistributes a replicated DTensor to its axes."""
    _, ports, ref_specs, port_specs = runs
    assert port_specs == ref_specs
    assert all(bool(p["placed_equal"]) and bool(p["constrain_ok"]) for p in ports)
