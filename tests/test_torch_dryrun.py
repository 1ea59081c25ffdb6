"""The port's dry run (``repro_torch.launch.specs``, ``analytic``, ``dryrun``)
and the kernels' meta route and counts, against the reference.

The configs' shape cells and parameter counts, the analytic model, the
accumulation rule and every input leaf's placement are held equal to the
reference's for every arch × shape × layout (the two production layouts and
one rank), on fake meshes of the layouts' shapes as ``tests/test_dist.py``
does. The meta route of each kernel gives its plain version's shapes and
dtypes and counts the closed forms of ``PERF.md`` §6. The CLI runs a cell of
each family and a skip, and ``benchmarks/roofline.py`` renders what it
writes.
"""
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.dist import logical_to_spec as ref_logical_to_spec
from repro.launch.analytic import analytic_memory_bytes as ref_analytic_memory_bytes
from repro.launch.analytic import cache_bytes as ref_cache_bytes
from repro.launch.analytic import model_flops as ref_model_flops
from repro.launch.specs import auto_accum_steps as ref_auto_accum_steps
from repro.launch.specs import batch_specs as ref_batch_specs
from repro.models import build_model as ref_build_model
from repro.training.optimizer import OptimizerConfig as RefOptimizerConfig
from repro.training.train_step import abstract_cache as ref_abstract_cache
from repro.training.train_step import abstract_state as ref_abstract_state
from repro.training.train_step import state_axes as ref_state_axes
from repro_torch import dist as rdist
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels import cost, ops
from repro_torch.launch import analytic, dryrun, specs
from repro_torch.launch.mesh import MeshLayout, make_production_mesh
from repro_torch.models import build_model
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import TrainConfig, init_state, make_train_step
from repro_torch.tree import leaves_with_paths

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = {"pod16x16": make_production_mesh(), "pod2x16x16": make_production_mesh(multi_pod=True),
           "one rank": MeshLayout((1, 1), ("data", "model"))}


class FakeMesh:  # the reference reads only ``mesh.shape``
    def __init__(self, shape):
        self.shape = shape


def _cells(arch):
    cfg = get_config(arch)
    return [s for s in SHAPES if cfg.shape_supported(SHAPES[s])[0]]


# ---------------------------------------------------------------------------
# configs, analytic model, accumulation
# ---------------------------------------------------------------------------

def test_shape_cells_are_the_reference_s():
    assert list(SHAPES) == list(REF_SHAPES)
    for name, cell in SHAPES.items():
        r = REF_SHAPES[name]
        assert (cell.name, cell.seq_len, cell.global_batch, cell.kind) == (r.name, r.seq_len, r.global_batch, r.kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_counts_and_support_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert cfg.params_count() == rcfg.params_count()
    assert cfg.active_params_count() == rcfg.active_params_count()
    assert (cfg.attention_free, cfg.sub_quadratic) == (rcfg.attention_free, rcfg.sub_quadratic)
    assert [cfg._layer_kind(i) for i in range(cfg.n_layers)] == [rcfg._layer_kind(i) for i in range(rcfg.n_layers)]
    for name in SHAPES:
        assert cfg.shape_supported(SHAPES[name]) == rcfg.shape_supported(REF_SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_model_matches_reference(arch):
    """model_flops, analytic_memory_bytes (at accumulation 1, 4 and the
    cell's own) and cache_bytes, equal for every shape and layout."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name, cell in SHAPES.items():
        rcell = REF_SHAPES[name]
        assert analytic.model_flops(cfg, cell) == ref_model_flops(rcfg, rcell)
        for mesh in LAYOUTS.values():
            shape = mesh.shape
            for accum in {1, 4, specs.auto_accum_steps(mesh, cell.global_batch, cell.seq_len, cfg=cfg)}:
                assert analytic.analytic_memory_bytes(cfg, cell, shape, accum=accum) == \
                    ref_analytic_memory_bytes(rcfg, rcell, shape, accum=accum)
            assert analytic.cache_bytes(cfg, cell, shape) == ref_cache_bytes(rcfg, rcell, shape)


def test_auto_accum_bounds_microbatch_tokens():
    """tests/test_system.py::test_auto_accum_bounds_microbatch_tokens's cases."""
    mesh = FakeMesh({"data": 16, "model": 16})
    assert specs.auto_accum_steps(mesh, 256, 4096) == ref_auto_accum_steps(mesh, 256, 4096) == 8
    assert specs.auto_accum_steps(mesh, 256, 8192) == ref_auto_accum_steps(mesh, 256, 8192) == 16
    assert specs.auto_accum_steps(mesh, 16, 512) == ref_auto_accum_steps(mesh, 16, 512) == 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_auto_accum_matches_reference_for_every_arch(layout):
    mesh = LAYOUTS[layout]
    fake = FakeMesh(mesh.shape)
    for arch in ARCH_IDS:
        for cell in SHAPES.values():
            for cfg_port, cfg_ref in ((None, None), (get_config(arch), ref_get_config(arch))):
                assert specs.auto_accum_steps(mesh, cell.global_batch, cell.seq_len, cfg=cfg_port) == \
                    ref_auto_accum_steps(fake, cell.global_batch, cell.seq_len, cfg=cfg_ref)


# ---------------------------------------------------------------------------
# every input leaf's placement against the reference's spec
# ---------------------------------------------------------------------------

def _ref_inputs(rcfg, rcell):
    """The reference's (arg trees, axes trees) of ``build_cell``, by kind."""
    model = ref_build_model(rcfg)
    b_sds, b_ax = ref_batch_specs(rcfg, rcell)
    if rcell.kind == "train":
        st = ref_abstract_state(model, RefOptimizerConfig())
        return (st, b_sds), (ref_state_axes(model, RefOptimizerConfig(), st), b_ax)
    params = jax.eval_shape(model.init, jax.random.key(0))
    if rcell.kind == "prefill":
        b_sds.pop("labels")
        b_ax.pop("labels")
        return (params, b_sds), (model.param_axes(), b_ax)
    cache = ref_abstract_cache(model, rcell.global_batch, rcell.seq_len)
    from repro.dist import Axes

    return ((params, cache, {"t": jax.ShapeDtypeStruct((rcell.global_batch, 1), np.int32)}),
            (model.param_axes(), model.cache_axes(), {"t": Axes("batch", None)}))


def _ref_placements(args, axes, mesh):
    """{keystr: placements} from the reference's ``logical_to_spec``, turned
    into placements by the port's ``to_placements``."""
    fake = FakeMesh(mesh.shape)
    out = {}
    flat_ax = dict((jax.tree_util.keystr(p), a) for p, a in
                   jax.tree_util.tree_flatten_with_path(axes, is_leaf=lambda x: hasattr(x, "t"))[0])
    for p, sds in jax.tree_util.tree_flatten_with_path(args)[0]:
        key = jax.tree_util.keystr(p)
        spec = tuple(ref_logical_to_spec(flat_ax[key].t, sds.shape, fake))
        out[key] = rdist.to_placements(spec + (None,) * (len(sds.shape) - len(spec)), mesh)
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_placements_match_reference(arch, layout):
    """Train, prefill and decode: the placements ``build_cell`` gives every
    input leaf (state or parameters, batch, cache, tokens) equal those of
    the reference's spec for the same leaf, shape and layout; the leaves'
    shapes equal; tokens are ``torch.long`` where the reference's are
    int32."""
    mesh = LAYOUTS[layout]
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    kinds = set()
    for name in _cells(arch):
        cell, rcell = SHAPES[name], REF_SHAPES[name]
        if cell.kind in kinds:
            continue
        kinds.add(cell.kind)
        recipe = specs.build_cell(cfg, cell, mesh)
        rargs, raxes = _ref_inputs(rcfg, rcell)
        want = {}
        for i, (a, ax) in enumerate(zip(rargs, raxes)):
            want.update({f"[{i}]{k}": v for k, v in _ref_placements(a, ax, mesh).items()})
        got, shapes = {}, {}
        for i, (a, pl) in enumerate(zip(recipe.args, recipe.placements)):
            for path, x, p in dryrun.placed_leaves(a, pl):
                if isinstance(x, torch.Tensor):
                    key = f"[{i}]{path}" if path else f"[{i}]['t']"
                    got[key], shapes[key] = p, tuple(x.shape)
        ref_shapes = {f"[{i}]{jax.tree_util.keystr(p)}": tuple(s.shape) for i, a in enumerate(rargs)
                      for p, s in jax.tree_util.tree_flatten_with_path(a)[0]}
        ref_shapes = {k: v for k, v in ref_shapes.items() if not k.endswith("['length']")}
        want = {k: v for k, v in want.items() if not k.endswith("['length']")}
        assert shapes == ref_shapes, (name, set(shapes) ^ set(ref_shapes))
        assert got == want, name
        tokens = recipe.args[2] if cell.kind == "decode" else recipe.args[1]["tokens"]
        assert tokens.dtype == torch.long and tokens.is_meta
    assert kinds == {"train", "prefill", "decode"}


def test_input_specs_contract():
    """tests/test_system.py::test_input_specs_contract, on meta tensors."""
    for arch in ("llama3-8b", "whisper-small", "internvl2-76b", "mamba2-1.3b"):
        cfg = get_config(arch)
        for cell in SHAPES.values():
            if not cfg.shape_supported(cell)[0]:
                continue
            t = specs.input_specs(cfg, cell)["tokens"]
            assert t.is_meta and t.dtype == torch.long
            assert t.shape == ((cell.global_batch, 1) if cell.kind == "decode" else (cell.global_batch, cell.seq_len))
            if cell.kind != "decode":
                extra = {"audio": "enc_embeds", "vlm": "vision_embeds"}.get(cfg.family)
                assert extra is None or extra in specs.batch_specs(cfg, cell)[0]


# ---------------------------------------------------------------------------
# the kernels' meta route and counts
# ---------------------------------------------------------------------------

def _rand(g, shape, dtype=torch.float32):
    return torch.randn(shape, generator=g).to(dtype)


def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    q, k, v = _rand(g, (2, 40, 8, 16)), _rand(g, (2, 40, 4, 16)), _rand(g, (2, 40, 4, 16))
    pq, pk, pv = _rand(g, (2, 8, 16)), _rand(g, (6, 16, 4, 16)), _rand(g, (6, 16, 4, 16))
    table = torch.tensor([[0, 2, 4], [1, 3, 5]], dtype=torch.int32)
    lengths = torch.tensor([48, 20], dtype=torch.int32)
    x, B_, C_ = _rand(g, (1, 40, 4, 8)), _rand(g, (1, 40, 1, 16)), _rand(g, (1, 40, 1, 16))
    dA = -_rand(g, (1, 40, 4)).abs()
    rx, rr, ri = _rand(g, (2, 30, 24)), torch.rand(2, 30, 24, generator=g), torch.rand(2, 30, 24, generator=g)
    lam = torch.rand(24, generator=g) + 0.5
    return {
        "attention causal": (ops.attention, (q, k, v), {"causal": True}),
        "attention window": (ops.attention, (q, k, v), {"causal": True, "window": 9}),
        "attention bidirectional": (ops.attention, (q, k[:, :33], v[:, :33]), {"causal": False}),
        "paged_decode": (ops.paged_decode, (pq, pk, pv, table, lengths), {}),
        "ssd_scan": (ops.ssd_scan, (x, dA, B_, C_, 16), {}),
        "ssd_scan bf16": (ops.ssd_scan, (x.bfloat16(), dA, B_.bfloat16(), C_.bfloat16(), 16), {}),
        "rglru": (ops.rglru, (rx, rr, ri, lam), {}),
        "rglru h0 bf16": (ops.rglru, (rx.bfloat16(), rr.bfloat16(), ri.bfloat16(), lam, _rand(g, (2, 24))), {}),
    }


def _meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("case", list(_kernel_cases()))
def test_meta_route_gives_the_plain_version_s_shapes(case):
    """Each kernel's entry point on meta inputs: outputs of the plain
    version's shapes and dtypes (the CUDA kernels'), on the meta device; its
    count in the tally, and none outside one."""
    fn, args, kw = _kernel_cases()[case]
    want = fn(*args, **kw)
    with cost.tally() as tal:
        got = fn(*map(_meta, args), **kw)
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.is_meta for t in got)
    kernels = {"attention": ["flash_attention"], "paged_decode": ["paged_decode"],
               "ssd_scan": ["ssd_states", "ssd_output"], "rglru": ["rglru_scan"]}[case.split()[0]]
    assert tal.calls == {k: 1 for k in kernels} and all(tal.flops[k] > 0 and tal.bytes[k] > 0 for k in kernels)
    assert not cost.counting()
    fn(*map(_meta, args), **kw)  # outside a tally: counts nothing, raises nothing


def test_kernel_counts_are_the_closed_forms():
    """kernels/cost.py against PERF.md §6's closed forms: flash 4·hd·H·B·
    T(T+1)/2 causal, 4·hd·H·B·T·S not, (2·|q| + |k| + |v|)·es bytes; paged
    decode 4·H·hd·L FLOPs and 2·L·K·hd·es + 2·|q|·es + table + lengths
    bytes; the SSD kernels' and RG-LRU's formulas; and §6's bytes at the
    serving shapes (2.62 MB for qwen3-4b's flash at T 128, 67.1 MB for
    RG-LRU at B 1, T 2048, W 4096 in bf16)."""
    m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    B, T, H, K, hd = 2, 512, 32, 8, 128
    q, k = m(B, T, H, hd), m(B, T, K, hd)
    c = cost.flash_attention(q, k, k)
    assert c == cost.Cost(4 * hd * H * B * T * (T + 1) // 2, (2 * q.numel() + 2 * k.numel()) * 2)
    assert cost.flash_attention(q, k, k, causal=False).flops == 4 * hd * H * B * T * T
    assert cost.flash_attention(m(1, 2048, 16, 256), m(1, 2048, 1, 256), m(1, 2048, 1, 256), window=2048).flops \
        == 4 * 256 * 16 * 2048 * 2049 // 2  # window = T: every causal pair
    assert cost.attention_pairs(5, 5, True, 2) == 9 and cost.attention_pairs(3, 7, False, None) == 21
    assert cost.attention_pairs(4, 4, True, None) == 10
    assert cost.flash_attention(m(1, 128, 32, 128), m(1, 128, 8, 128), m(1, 128, 8, 128)).bytes == 2_621_440
    L = 160
    pq, pk = m(1, 32, 128), m(4, 64, 8, 128)
    table = torch.arange(4, dtype=torch.int32).view(1, 4)
    c = cost.paged_decode(pq, pk, pk, table, torch.tensor([L], dtype=torch.int32))
    assert c == cost.Cost(4 * 32 * 128 * L, 2 * L * 8 * 128 * 2 + 2 * pq.numel() * 2 + 4 * 4 + 4)
    meta_len = torch.empty(1, dtype=torch.int32, device="meta")
    assert cost.paged_decode(pq, pk, pk, table, meta_len).flops == 4 * 32 * 128 * 256  # the table's capacity
    b, t, h, p, n, cs = 1, 1024, 64, 64, 128, 256
    x, dA, Bc = m(b, t, h, p), m(b, t, h, dt=torch.float32), m(b, t, 1, n)
    nc, tri = t // cs, cs * (cs + 1) // 2
    assert cost.ssd_states(x, dA, Bc, Bc, cs) == cost.Cost(
        b * nc * (2 * tri * n + h * (2 * tri * p + 2 * cs * p * n)),
        x.numel() * 2 + dA.numel() * 4 + 2 * Bc.numel() * 2 + 4 * b * nc * h * (cs * p + p * n))
    assert cost.ssd_output(x, dA, Bc, cs) == cost.Cost(
        2 * b * nc * h * cs * p * n, 4 * (b * nc * h * cs * p + dA.numel() + b * nc * h * p * n) + Bc.numel() * 2
        + x.numel() * 2)
    xr = m(1, 2048, 4096)
    c = cost.rglru_scan(xr, xr, xr, m(4096, dt=torch.float32))
    assert c == cost.Cost(6 * 2048 * 4096, 4 * 2048 * 4096 * 2 + 4 * 4096 + 4 * 4096)
    assert round(c.bytes / 1e6, 1) == 67.1


# ---------------------------------------------------------------------------
# the step on meta
# ---------------------------------------------------------------------------

def test_step_probe_tracks_live_bytes():
    a = torch.empty(1000, device="meta")
    with dryrun.StepProbe([a]) as probe:
        b = a + 1  # 4000 B
        c = b.view(10, 100)  # a view: no new bytes
        d = torch.empty(250, device="meta")  # 1000 B
        del b, c, d
        e = a[:10]  # a view of an argument
        f = torch.empty(500, device="meta")  # 2000 B
        assert probe.live == 2000
    assert probe.peak == 5000 and probe.ops["add"] == 1 and e.is_meta and f.numel() == 500


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m", "whisper-small"])
def test_meta_train_step_counts_accum_microsteps(arch):
    """A whole meta train step at 2 microbatches counts exactly twice the
    dry run's microstep (the optimizer adds no counted FLOP), each flash call
    of the forward and of the remat recompute counted once, and a MoE
    layer's gathers in the backward too."""
    cfg = get_config(arch).reduced()
    cell = ShapeCell("t", 64, 4, "train")
    mesh = MeshLayout((1, 1), ("data", "model"))
    tc = TrainConfig(opt=OptimizerConfig(), accum_steps=2, remat=True)
    rec = dryrun.analyze(specs.build_cell(cfg, cell, mesh, tc), cfg, cell, mesh, dryrun.VARIANTS["baseline"])
    model = build_model(cfg, "meta")
    state = init_state(model, None, tc.opt)
    batch, _ = specs.batch_specs(cfg, cell)
    whole = dryrun.count_step(lambda: make_train_step(model, tc)(state, batch))
    assert rec["cost"]["flops_per_device"] == whole["flops"] > 0
    n_attn = cfg.n_layers + (cfg.enc_layers + cfg.n_layers if cfg.family == "audio" else 0)
    # a MoE layer's two gathers: forward, recompute, and each the other's backward
    gathers = {"gather_rows": cfg.n_layers * 3 * 2, "gather_sum_rows": cfg.n_layers * 3 * 2}
    assert whole["kernel_calls"] == {"flash_attention": n_attn * 2 * 2, **(gathers if cfg.family == "moe" else {})}
    params = sum(p.numel() * 4 for _, p in leaves_with_paths(state["params"]))
    assert rec["memory"]["argument_bytes"] == 3 * params + 4 + 4 + 2 * 4 * 64 * 8 + (
        4 * cfg.enc_len * cfg.d_model * 2 if cfg.family == "audio" else 0)
    assert rec["collectives"]["per_op"] == [] and rec["roofline"]["collective_s"] == 0


# the configs of chip_smoke.py phase 6b's runs, reduced (remat and not), and
# qwen3-4b at full size and phase 6b's shape, whose step the card counted at
# 144 flash calls (phase dryrun)
LAUNCH_CASES = [(arch, remat, False) for arch in ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "whisper-small",
                                                  "mamba2-1.3b", "recurrentgemma-9b") for remat in (True, False)]
LAUNCH_CASES += [("qwen3-4b", True, False), ("qwen3-4b", True, True)]


@pytest.mark.parametrize("arch,remat,full", LAUNCH_CASES)
def test_train_step_launches_are_the_meta_step_s(arch, remat, full):
    """``cost.train_step_launches`` (what phase 6b holds the card's launch
    counts to) equals the kernel calls that a whole train step of 2
    microbatches counts on the meta device, which takes the card's route:
    whisper's encoder, self- and cross-attention each once in a forward and
    once in a remat recompute, the backwards none but the MoE's, whose two
    gathers are each other's backward."""
    cfg = get_config(arch) if full else get_config(arch).reduced()
    cell = ShapeCell("t", 512 if full else 64, 4, "train")
    tc = TrainConfig(opt=OptimizerConfig(), accum_steps=2, remat=remat)
    model = build_model(cfg, "meta")
    state = init_state(model, None, tc.opt)
    batch, _ = specs.batch_specs(cfg, cell)
    whole = dryrun.count_step(lambda: make_train_step(model, tc)(state, batch))
    expect = cost.train_step_launches(cfg, tc.accum_steps, remat)
    assert whole["kernel_calls"] == expect
    if full:
        assert expect == {"flash_attention": 144}


def test_launches_per_call_by_family():
    """One launch per layer of the kernel's kind: recurrentgemma-9b's 38
    layers are 26 RG-LRU and 12 local attention; whisper-small prefills
    through its 12 encoder and 2 × 12 decoder attention layers and decodes
    over the self and cross caches; a MoE layer gathers and sums rows in
    every call, and once more each in a train step's backward."""
    assert cost.launches_per_call(get_config("recurrentgemma-9b")) == {
        "rglru_scan": (26, 0), "flash_attention": (12, 0), "paged_decode": (0, 12)}
    assert cost.launches_per_call(get_config("whisper-small")) == {"flash_attention": (36, 0),
                                                                   "paged_decode": (0, 24)}
    assert cost.launches_per_call(get_config("mamba2-1.3b")) == {"ssd_states": (48, 0), "ssd_output": (48, 0)}
    assert cost.launches_per_call(get_config("qwen2-moe-a2.7b")) == {"flash_attention": (24, 0),
                                                                     "paged_decode": (0, 24),
                                                                     "gather_rows": (24, 24),
                                                                     "gather_sum_rows": (24, 24)}
    assert cost.train_step_launches(get_config("qwen2-moe-a2.7b"), 2, True) == {
        "flash_attention": 96, "gather_rows": 144, "gather_sum_rows": 144}
    assert cost.train_step_launches(get_config("whisper-small"), 2, True) == {"flash_attention": 144}


# (arch, layers, fits): phase 6b's cuts fit one card, the full depths do not
FIT_CASES = [("recurrentgemma-9b", 9, True), ("qwen2-moe-a2.7b", 6, True), ("recurrentgemma-9b", 38, False),
             ("qwen2-moe-a2.7b", 24, False)]


@pytest.mark.parametrize("arch,layers,fits", FIT_CASES)
def test_one_rank_step_judges_fit_at_80_gb(arch, layers, fits, tmp_path, capsys):
    """``--one-rank-step 4 512 2`` (phase 6b's step on one card) records
    whether a rank's total fits the H100's 80 GB, and says so on its line."""
    assert dryrun.main(["--arch", arch, "--layers", str(layers), "--one-rank-step", "4", "512", "2",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / f"{arch}__step4x512a2__data1xmodel1.json").read_text())
    mem = rec["memory"]
    assert mem["device_bytes"] == 80e9
    assert mem["fits"] is fits and (mem["total_per_device"] <= 80e9) is fits
    assert f"fits 80 GB: {'yes' if fits else 'NO'}" in capsys.readouterr().out


def _backward_flops(fn, inputs, needs_grad) -> int:
    """FlopCounterMode's count of ``fn``'s backward on meta ``inputs`` (the
    forward runs outside the counter), the cotangent on its first output
    only, as a train step's loss gives it."""
    leaves = [t.requires_grad_() if need else t for t, need in zip(inputs, needs_grad)]
    out = fn(*leaves)
    fc = dryrun.FlopCounterMode(display=False)
    with fc:
        torch.autograd.grad(out[0], [t for t in leaves if t.requires_grad], torch.empty_like(out[0]))
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_meta_train_step_counts_the_ssm_and_hybrid_backward(arch, monkeypatch):
    """A reduced ``ssm`` and ``hybrid`` train cell counts the SSD / RG-LRU
    gradient. Against the same step with ``ops.ssd_backward`` /
    ``ops.rglru_backward`` giving zeros uncounted, its FLOPs rise by exactly
    accum × (layers of the kind) × FlopCounterMode's count of
    ``ops.SSDScan`` / ``ops.RGLRU``'s backward on meta tensors of the cell's
    shapes (the RG-LRU's is elementwise, which FlopCounterMode counts as 0).
    Against the bare entry points (the kernels without a gradient, as before
    the Functions) they rise by that and, in the hybrid, by the backward of
    the matmuls that feed the RG-LRU and got no gradient then (``w_in``:
    4·b·T·d·W; ``w_a``, ``w_x``: 8·b·T·W²). The kernels' forward calls
    (forward and remat recompute) are the same in all three, and the record
    says nothing of a missing gradient."""
    cfg = get_config(arch).reduced()
    cell = ShapeCell("t", 64, 4, "train")
    mesh = MeshLayout((1, 1), ("data", "model"))
    tc = TrainConfig(opt=OptimizerConfig(), accum_steps=2, remat=True)
    b, T, d = cell.global_batch // tc.accum_steps, cell.seq_len, cfg.d_model

    def flops():
        rec = dryrun.analyze(specs.build_cell(cfg, cell, mesh, tc), cfg, cell, mesh, dryrun.VARIANTS["baseline"])
        assert rec["cost"]["kernel_calls_microstep"] == kernels
        assert "backward" not in rec["cost"]["flops_basis"] and "Queue A" not in rec["cost"]["flops_basis"]
        return rec["cost"]["flops_per_device"]

    m = lambda *s, dt=getattr(torch, cfg.dtype): torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    if cfg.family == "ssm":
        nh, n, chunk = cfg.ssm_expand * d // cfg.ssm_head_dim, cfg.ssm_state, min(cfg.ssm_chunk, T)
        per_call = _backward_flops(lambda *a: ops.SSDScan.apply(*a, chunk),
                                   (m(b, T, nh, cfg.ssm_head_dim), m(b, T, nh, dt=torch.float32), m(b, T, 1, n),
                                    m(b, T, 1, n)), (True,) * 4)
        calls, fn, helper, n_in, upstream = cfg.n_layers, "SSDScan", "ssd_backward", 4, 0
        kernels = {"ssd_states": 2 * calls, "ssd_output": 2 * calls}
        assert per_call > 0
    else:
        W = cfg.rnn_width or d
        per_call = _backward_flops(lambda *a: ops.RGLRU.apply(*a, None),
                                   (m(b, T, W), m(b, T, W), m(b, T, W), m(W, dt=torch.float32)), (True,) * 4)
        calls = (cfg.layer_pattern * cfg.n_layers)[: cfg.n_layers].count("R")
        fn, helper, n_in, upstream = "RGLRU", "rglru_backward", 5, 4 * b * T * d * W + 8 * b * T * W * W
        kernels = {"rglru_scan": 2 * calls, "flash_attention": 2 * (cfg.n_layers - calls)}
        assert per_call == 0
    full = flops()
    with monkeypatch.context() as mp:
        mp.setattr(ops, helper, lambda *a: tuple(None if t is None or not t.requires_grad else torch.zeros_like(t)
                                                 for t in a[:n_in]))
        stub = flops()
    with monkeypatch.context() as mp:
        bare = ops.ssd_scan if fn == "SSDScan" else ops.rglru
        mp.setattr(ops, fn, type(fn, (), {"apply": staticmethod(bare)}))
        old = flops()
    assert full - stub == tc.accum_steps * calls * per_call
    assert full - old == tc.accum_steps * calls * (per_call + upstream)


def test_collective_links():
    pod = make_production_mesh()
    assert dryrun.link(pod, ("model",))[0] == dryrun.link(pod, ("data",))[0] == "ib"
    small = MeshLayout((2, 4), ("data", "model"))
    assert dryrun.link(small, ("model",))[0] == dryrun.link(small, ("data",))[0] == "nvlink"
    assert dryrun.link(MeshLayout((2, 8), ("data", "model")), ("data",))[0] == "ib"


# ---------------------------------------------------------------------------
# the CLI, rendered by benchmarks/roofline.py
# ---------------------------------------------------------------------------

CLI_CELLS = [("qwen3-4b", "train_4k"), ("granite-moe-1b-a400m", "prefill_32k"), ("internvl2-76b", "decode_32k"),
             ("mamba2-1.3b", "long_500k"), ("recurrentgemma-9b", "decode_32k"), ("whisper-small", "train_4k"),
             ("llama3-8b", "long_500k")]


def test_cli_cells_render_in_roofline(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location("roofline", ROOT / "benchmarks" / "roofline.py")
    roofline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roofline)
    for arch, shape in CLI_CELLS:
        assert dryrun.main(["--arch", arch, "--shape", shape, "--out", str(tmp_path)]) == 0
    recs = roofline.load(str(tmp_path))
    assert {(r["arch"], r["shape"]) for r in recs} == set(CLI_CELLS)
    for r in recs:
        if r["arch"] == "llama3-8b":
            assert r["status"] == "skip" and r["reason"] == ref_get_config("llama3-8b").shape_supported(
                REF_SHAPES["long_500k"])[1]
            continue
        assert r["status"] == "ok" and r["mesh"] == "pod16x16" and r["variant"] == "baseline"
        assert r["memory"]["argument_bytes"] > 0 and r["memory"]["temp_bytes"] > 0
        assert r["cost"]["flops_per_device"] > 0 and 0 < r["cost"]["useful_flops_ratio"] < 1.5
        assert r["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
        assert len(r["aten_ops"]) == 15 and r["collectives"]["basis"] == "analytic"
    kernels = {r["arch"]: r["cost"]["kernel_calls_microstep"] for r in recs if r["status"] == "ok"}
    assert set(kernels["mamba2-1.3b"]) == set() and set(kernels["recurrentgemma-9b"]) == {"paged_decode"}
    assert set(kernels["granite-moe-1b-a400m"]) == {"flash_attention", "gather_rows", "gather_sum_rows"}
    table = roofline.render(recs)
    assert all(arch in table for arch, _ in CLI_CELLS) and "ERR" not in table and "skip" in table
    rec = json.loads((tmp_path / "qwen3-4b__train_4k__pod16x16.json").read_text())
    assert rec["accum_steps"] == specs.auto_accum_steps(make_production_mesh(), 256, 4096, cfg=get_config("qwen3-4b"))


def test_dry_run_tree_placements_use_variant_rules():
    """A rule override (V7: attention replicated over ``model``) reaches the
    placements, through ``default_rules().override``."""
    cfg = get_config("qwen3-4b")
    mesh = make_production_mesh()
    base = specs.build_cell(cfg, SHAPES["prefill_32k"], mesh)
    v7 = specs.build_cell(cfg, SHAPES["prefill_32k"], mesh, rules=dryrun.variant_rules("v7_attn_dp"))
    from torch.distributed.tensor import Replicate, Shard

    assert base.placements[0]["attn"]["wq"] == (Shard(1), Shard(2))
    assert v7.placements[0]["attn"]["wq"] == (Shard(1), Replicate())
