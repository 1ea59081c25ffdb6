"""Multi-pod dry run over meta tensors: every (arch × shape × mesh) cell's
memory per rank, FLOPs, collectives and roofline terms, with no device.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out artifacts/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch recurrentgemma-9b --layers 9 --one-rank-step 4 512 2

``--layers`` cuts every arch's depth. ``--one-rank-step B T A`` runs, in
place of the shape cells on the production layouts, one rank's train step
at global batch B × T in A microbatches (AdamW, remat): the step
``chip_smoke.py`` phase 6b runs on one card.

Every record and its line say whether a rank's ``total_per_device`` fits
one H100's memory (``memory.fits`` against ``memory.device_bytes``,
``launch/mesh.py::H100["hbm_bytes"]``, 80 GB); ``benchmarks/roofline.py``'s
own ``fits`` column reads its 16 GiB limit.

Each cell writes ``<out>/<arch>__<shape>__<mesh>[__variant].json`` in the
reference's record layout, which ``benchmarks/roofline.py --dir <out>``
renders. The port's counterpart of the reference's ``launch/dryrun.py``:
where that one compiles with XLA for 512 placeholder devices and reads the
HLO, this one runs one rank's step on the meta device (shapes only) under
``FlopCounterMode``, the kernels' tally (:mod:`repro_torch.kernels.cost`)
and a dispatch mode that tracks live bytes, and takes the placements from
the production layout's dim sizes (:class:`.mesh.MeshLayout`). The meta
route follows the card's path op for op (``repro_torch.device.kernel_path``).
No ``DeviceMesh`` is installed, so the explicit-collective paths (V2, V3,
V9) take their no-mesh route; every collective is counted analytically from
the placements (:func:`collectives`).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from collections import Counter
from dataclasses import replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeCell, cut, get_config
from repro_torch.dist import default_rules, mesh_shape
from repro_torch.dist.perf import PerfConfig, perf_context
from repro_torch.kernels import cost as kcost
from repro_torch.launch.analytic import analytic_memory_bytes, model_flops
from repro_torch.launch.mesh import H100, MeshLayout, make_production_mesh
from repro_torch.launch.specs import batch_specs, build_cell, decode_cache
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import TrainConfig, make_train_step
from repro_torch.tree import keystr, leaves, leaves_with_paths

# each variant: (PerfConfig, logical-rule overrides or None), the reference's
RULE_OVERRIDES = {
    # V7: attention fully data-parallel: replicate attn weights over `model`
    "v7_attn_dp": {"heads": [], "kv": [], "act_heads": [], "act_kv": []},
    # V5: decode weight-stationary layout: activations shard over `data` on
    # the embed dim (batch replicated)
    "v5_decode_layout": {"batch": [], "embed": [("data",)], "act_vocab": [("model",)]},
    # V8: pure FSDP data parallelism: batch over both mesh dims
    "v8_fsdp_dp": {
        "batch": [("pod", "data", "model"), ("data", "model"), ("pod", "data"), ("data",)],
        "act_heads": [], "act_kv": [], "act_mlp": [], "act_vocab": [],
    },
}

VARIANTS = {
    "baseline": PerfConfig(),
    "v1_save_ar": PerfConfig(save_dot_outputs=True),
    "v2_moe_local": PerfConfig(moe_local_dispatch=True),
    "v3_sharded_decode": PerfConfig(sharded_decode_attn=True),
    "v4_causal_chunks": PerfConfig(causal_chunk_growth=True),
    "v6_cast_early": PerfConfig(cast_weights_early=True),
    "v1_v6": PerfConfig(save_dot_outputs=True, cast_weights_early=True),
    "optimized": PerfConfig(sharded_decode_attn=True, causal_chunk_growth=True, moe_local_dispatch=True),
    "optimized_v1": PerfConfig(sharded_decode_attn=True, causal_chunk_growth=True, moe_local_dispatch=True,
                               save_dot_outputs=True),
    "v7_attn_dp": PerfConfig(),
    "v5_decode_layout": PerfConfig(sharded_decode_attn=True),
    "v1_v7": PerfConfig(save_dot_outputs=True),
    "v5_v3": PerfConfig(sharded_decode_attn=True),
    "v8_fsdp_dp": PerfConfig(cast_weights_early=True),
    "v8_noearly": PerfConfig(),
    "v9_bf16_rowparallel": PerfConfig(bf16_rowparallel=True),
    "v9_v1": PerfConfig(bf16_rowparallel=True, save_dot_outputs=True),
}

DATA_DIMS = ("pod", "data")
TEMP_BASIS = ("peak of the live bytes above the arguments while one rank's step runs on the meta device at its local "
              "microbatch (b_local / accum), at the model's full width (activations not split over `model`: an "
              "upper bound where `model` > 1){grads}; output_bytes: the donated arguments at their placed size "
              "(alias_bytes) and the other outputs as the step returns them, at the local batch")
FLOPS_BASIS = ("(FlopCounterMode's aten count + the kernels' count from kernels/cost.py) of one microstep at the local "
               "microbatch, x accum, / the `model` dim's size (the tensor-parallel split, assumed even)")


def variant_rules(variant: str):
    """The logical-rule table of ``variant`` (None: the default rules)."""
    ov = {}
    if variant in ("v7_attn_dp", "v1_v7"):
        ov.update(RULE_OVERRIDES["v7_attn_dp"])
    if variant in ("v5_decode_layout", "v5_v3"):
        ov.update(RULE_OVERRIDES["v5_decode_layout"])
    if variant in ("v8_fsdp_dp", "v8_noearly"):
        ov.update(RULE_OVERRIDES["v8_fsdp_dp"])
    return default_rules().override(**ov) if ov else None


# ---------------------------------------------------------------------------
# bytes of a placed tree
# ---------------------------------------------------------------------------

def local_shape(shape, placements, mesh) -> tuple:
    """One rank's shard of a tensor of ``shape`` under ``placements`` (the
    rules shard only dims their mesh dims divide)."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for size, p in zip(mesh_shape(mesh).values(), placements):
        if isinstance(p, Shard):
            out[p.dim] //= size
    return tuple(out)


def placed_leaves(tree, placements, path: tuple = ()) -> list[tuple[str, object, tuple]]:
    """``[(keystr, leaf, its placements), …]`` in :func:`leaves` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in placed_leaves(tree[k], placements[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in placed_leaves(v, placements[i], path + (i,))]
    return [(keystr(path), tree, placements)]


def local_bytes(tree, placements, mesh) -> list[int]:
    """Per leaf of ``tree`` (in :func:`leaves` order), one rank's bytes of it."""
    out = []
    for _, x, pl in placed_leaves(tree, placements):
        n = 0
        if isinstance(x, torch.Tensor):
            n = x.element_size()
            for d in local_shape(x.shape, pl, mesh):
                n *= d
        out.append(n)
    return out


def sharded_dims(placements, mesh) -> set:
    from torch.distributed.tensor import Shard

    return {name for name, p in zip(mesh_shape(mesh), placements) if isinstance(p, Shard)}


# ---------------------------------------------------------------------------
# the step on meta: FLOPs, live bytes, aten ops
# ---------------------------------------------------------------------------

class StepProbe(TorchDispatchMode):
    """Live bytes and aten ops of what runs under it. Each output storage not
    seen before (and not an argument's) adds its bytes, which come off when
    the storage dies; ``peak`` is the most that was live at once."""

    def __init__(self, known=()):
        super().__init__()
        self.live = self.peak = 0
        self.ops: Counter = Counter()
        self._refs: dict[int, weakref.ref] = {}
        self._known = {t.untyped_storage()._cdata for t in known if isinstance(t, torch.Tensor)}

    def _free(self, key, nbytes, _ref) -> None:
        self._refs.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops[func.overloadpacket.__name__] += 1
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st._cdata
                if key in self._known or key in self._refs:
                    continue
                n = st.nbytes()
                self._refs[key] = weakref.ref(st, lambda r, k=key, n=n: self._free(k, n, r))
                self.live += n
                self.peak = max(self.peak, self.live)
        return out


def count_step(run, known=()) -> dict:
    """Run ``run()`` under the FLOP counter, the kernels' tally and a
    :class:`StepProbe`: {flops (aten + kernels), aten_flops, kernel_flops,
    kernel_calls, peak_bytes, ops, out}."""
    fc = FlopCounterMode(display=False)
    with kcost.tally() as tal, fc:
        probe = StepProbe(known)
        with probe:
            out = run()
    aten = fc.get_total_flops()
    return {"flops": aten + tal.total_flops, "aten_flops": aten, "kernel_flops": dict(tal.flops),
            "kernel_calls": dict(tal.calls), "peak_bytes": probe.peak, "ops": probe.ops, "out": out}


def microbatch(recipe, cfg, cell) -> tuple[int, int]:
    """(accumulation steps, one rank's rows per microstep). A rank
    accumulates no more microsteps than it has rows (V8 puts one sequence
    on each rank)."""
    local = recipe.static_info["local_batch"]
    accum = min(recipe.static_info["train_cfg"].accum_steps, local) if recipe.kind == "train" else 1
    return accum, max(local // accum, 1)


def meta_step(recipe, cfg, cell) -> dict:
    """One rank's microstep on meta, at its local microbatch and the model's
    full width. Train: the step at accumulation 1 on the microbatch, the
    gradients allocated beforehand (an FSDP rank keeps only its shard, added
    from the placements by :func:`run_cell`). Prefill: the local batch.
    Decode: the local cache."""
    model = recipe.static_info["model"]
    _, b = microbatch(recipe, cfg, cell)
    if recipe.kind == "train":
        state = recipe.args[0]
        tcfg = replace(recipe.static_info["train_cfg"], accum_steps=1)
        batch, _ = batch_specs(cfg, cell, batch=b)
        for p in leaves(state["params"]):
            p.grad = torch.zeros_like(p)
        step = make_train_step(model, tcfg)
        args = (state, batch)
        res = count_step(lambda: step(state, batch), leaves(args) + [p.grad for p in leaves(state["params"])])
        for p in leaves(state["params"]):
            p.grad = None
        return {**res, "args": args}
    if recipe.kind == "prefill":
        batch, _ = batch_specs(cfg, cell, batch=b)
        batch.pop("labels")
        args = (recipe.args[0], batch)
        return {**count_step(lambda: recipe.fn(batch), leaves(args)), "args": args}
    cache = decode_cache(model, b, cell.seq_len)
    tokens = torch.empty((b, 1), dtype=torch.long, device="meta")
    args = (recipe.args[0], cache, tokens)
    return {**count_step(lambda: recipe.fn(cache, tokens), leaves(args)), "args": args}


# ---------------------------------------------------------------------------
# collectives, from the placements
# ---------------------------------------------------------------------------

def link(mesh, axes) -> tuple[str, float]:
    """The link a collective over ``axes`` runs on: NVLink when every peer is
    in the rank's node of ``H100["node_gpus"]`` (the ranks laid out
    row-major over the mesh dims, a node holding consecutive ranks), else
    InfiniBand."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    for a in axes:
        stride = 1
        for b in names[names.index(a) + 1:]:
            stride *= sizes[b]
        if a == "pod" or sizes[a] * stride > H100["node_gpus"]:
            return "ib", H100["ib_bw"]
    return "nvlink", H100["nvlink_bw"]


def _ranks(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh_shape(mesh)[a]
    return n


def collectives(recipe, cfg, cell, mesh, flags: PerfConfig) -> list[dict]:
    """Per step, each collective one rank takes part in, with its wire bytes
    per rank (all-gather and reduce-scatter (n−1)/n of the whole, all-reduce
    twice that) and its time at its link's rate:

    * the FSDP all-gather of every parameter sharded over data dims, in the
      compute dtype: forward, remat recompute and backward per microstep in
      training, the forward once in serving;
    * training: each gradient reduce-scatter over the data dims that shard
      its parameter and all-reduce over the batch's other data dims, fp32,
      per microstep;
    * one all-reduce over ``model`` per row-parallel product (a weight that
      contracts a ``model``-sharded dim into ``param_embed``) per layer and
      pass, of the (b, T, d) activation in the compute dtype;
    * V3's combine (all-reduce of m, l and acc, fp32, per attention layer),
      V2's gather of the MoE FFN's output over the data dims, where their
      flags are on.
    """
    sizes = mesh_shape(mesh)
    accum, b = microbatch(recipe, cfg, cell)
    train = recipe.kind == "train"
    passes = 3 if train else 1
    es = getattr(torch, cfg.dtype).itemsize
    params = recipe.args[0]["params"] if train else recipe.args[0]
    p_pl = recipe.placements[0]["params"] if train else recipe.placements[0]
    batch_pl = recipe.placements[1]["tokens"] if recipe.kind != "decode" else recipe.placements[2]
    batch_axes = [a for a in sharded_dims(batch_pl, mesh) if a in DATA_DIMS]
    ops: list[dict] = []

    def add(op, what, axes, count, nbytes):
        n = _ranks(mesh, axes)
        if n <= 1 or count == 0 or nbytes == 0:
            return
        wire = nbytes * (n - 1) / n * (2 if op == "all-reduce" else 1)
        name, rate = link(mesh, axes)
        ops.append({"op": op, "what": what, "axes": list(axes), "count": count, "bytes_per_rank": wire,
                    "link": name, "seconds": count * wire / rate})

    ax = dict(leaves_with_paths(recipe.static_info["model"].param_axes()))
    gather, rs, ar = Counter(), Counter(), Counter()
    rowpar = []
    for path, p, pl in placed_leaves(params, p_pl):
        shd = sharded_dims(pl, mesh)
        data = tuple(a for a in sizes if a in shd and a in DATA_DIMS)
        local = 1
        for d in local_shape(p.shape, pl, mesh):
            local *= d
        if data:
            gather[data] += local * _ranks(mesh, data) * es
            rs[data] += local * _ranks(mesh, data) * 4
        rest = tuple(a for a in sizes if a in batch_axes and a not in data)
        if rest:
            ar[rest] += local * 4
        names = ax[path].t
        if names and names[-1] == "param_embed" and "model" in shd and len(names) >= 3:
            from torch.distributed.tensor import Shard

            mdim = pl[list(sizes).index("model")]
            if isinstance(mdim, Shard) and mdim.dim < len(names) - 1:
                layers = p.shape[0] if names[0] == "layers" else 1
                rowpar.append((path, layers))
    for data, nbytes in gather.items():
        add("all-gather", "FSDP parameters" + (" (forward, remat, backward)" if train else " (forward)"), data,
            passes * accum, nbytes)
    if train:
        for data, nbytes in rs.items():
            add("reduce-scatter", "gradients over the data dims that shard them", data, accum, nbytes)
        for rest, nbytes in ar.items():
            add("all-reduce", "gradients over the batch's other data dims", rest, accum, nbytes)
    d = cfg.d_model
    for path, layers in rowpar:
        if path.startswith("['enc']"):
            if recipe.kind == "decode":
                continue  # decode reads the cached cross K/V: the encoder does not run
            T = cfg.enc_len
        else:
            T = 1 if recipe.kind == "decode" else cell.seq_len
        add("all-reduce", f"row-parallel product {path}", ("model",), layers * passes * accum, b * T * d * es)
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg._layer_kind(i) == "A") if cfg.family != "ssm" else 0
    if flags.sharded_decode_attn and recipe.kind == "decode" and n_attn and cell.seq_len % sizes.get("model", 1) == 0:
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        add("all-reduce", "V3 combine: m, l, acc (fp32)", ("model",), n_attn, b * H * (hd + 2) * 4)
    if flags.moe_local_dispatch and cfg.family == "moe" and batch_axes:
        T = 1 if recipe.kind == "decode" else cell.seq_len
        add("all-gather", "V2 MoE FFN output over the data dims", tuple(a for a in sizes if a in batch_axes),
            cfg.n_layers * passes * accum, b * _ranks(mesh, batch_axes) * T * d * es)
    return ops


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def analyze(recipe, cfg, cell, mesh, flags: PerfConfig) -> dict:
    """The record's measured part for a built cell."""
    accum, _ = microbatch(recipe, cfg, cell)
    sizes = mesh_shape(mesh)
    model_n = sizes.get("model", 1)
    n_chips = 1
    for s in sizes.values():
        n_chips *= s
    arg_bytes = sum(sum(local_bytes(a, pl, mesh)) for a, pl in zip(recipe.args, recipe.placements))
    res = meta_step(recipe, cfg, cell)
    temp = res["peak_bytes"]
    grads = ""
    if recipe.kind == "train":  # the rank's fp32 gradient shard
        shard = sum(local_bytes(recipe.args[0]["params"], recipe.placements[0]["params"], mesh))
        temp += shard
        grads = f"; plus the rank's gradient shard ({shard} B, fp32 as the parameters, allocated before the step)"
    # donated arguments come back as outputs in place: output = alias = their bytes
    donated = {t.untyped_storage()._cdata: n for i in recipe.donate_argnums
               for t, n in zip(leaves(res["args"][i]), local_bytes(recipe.args[i], recipe.placements[i], mesh))
               if isinstance(t, torch.Tensor)}
    out_bytes = alias = 0
    for t in tree_leaves(res["out"]):
        if isinstance(t, torch.Tensor):
            key = t.untyped_storage()._cdata
            if key in donated:
                alias += donated.pop(key)
            else:
                out_bytes += t.untyped_storage().nbytes()
    out_bytes += alias
    total = arg_bytes + temp + out_bytes - alias
    flops = res["flops"] * accum / model_n
    mflops = model_flops(cfg, cell)
    mem_bytes = analytic_memory_bytes(cfg, cell, sizes, accum=accum)
    coll = collectives(recipe, cfg, cell, mesh, flags)
    terms = {"compute_s": flops / H100["peak_flops_bf16"], "memory_s": mem_bytes / H100["hbm_bw"],
             "collective_s": sum(c["seconds"] for c in coll)}
    return {
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "total_per_device": total,
            "device_bytes": H100["hbm_bytes"],
            "fits": total <= H100["hbm_bytes"],
            "temp_bytes_basis": TEMP_BASIS.format(grads=grads),
        },
        "cost": {
            "flops_per_device": flops,
            "aten_flops_microstep": res["aten_flops"],
            "kernel_flops_microstep": res["kernel_flops"],
            "kernel_calls_microstep": res["kernel_calls"],
            "analytic_bytes_per_device": mem_bytes,
            "model_flops_global": mflops,
            "useful_flops_ratio": mflops / max(flops * n_chips, 1.0),
            "flops_basis": FLOPS_BASIS,
        },
        "collectives": {
            "wire_nvlink": sum(c["count"] * c["bytes_per_rank"] for c in coll if c["link"] == "nvlink"),
            "wire_ib": sum(c["count"] * c["bytes_per_rank"] for c in coll if c["link"] == "ib"),
            "per_op": coll,
            "basis": "analytic",
        },
        "roofline": {**terms, "dominant": max(terms, key=terms.get)},
        "aten_ops": res["ops"].most_common(15),
    }


def run_cell(arch: str, shape: str, multi_pod: bool = False, rules=None, variant: str = "baseline",
             mesh=None, cell: ShapeCell | None = None, train_cfg: TrainConfig | None = None,
             quiet: bool = False, n_layers: int | None = None) -> dict:
    """One cell's record. ``mesh`` (a ``MeshLayout``) replaces the production
    layout, ``cell`` the shape cell named ``shape``, and ``train_cfg`` the
    auto-accumulating AdamW default, where given; ``n_layers`` cuts the
    depth (an encoder's too)."""
    cfg = get_config(arch) if n_layers is None else cut(arch, n_layers)
    cell = cell or SHAPES[shape]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    mesh_name = mesh_label(mesh)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name, "kind": cell.kind, "variant": variant,
                 "params": cfg.params_count(), "active_params": cfg.active_params_count()}
    ok, why = cfg.shape_supported(cell)
    if not ok:
        rec["status"] = "skip"
        rec["reason"] = why
        return rec
    if rules is None:
        rules = variant_rules(variant)
    t0 = time.time()
    flags = VARIANTS[variant]
    with perf_context(flags):
        recipe = build_cell(cfg, cell, mesh, train_cfg or TrainConfig(opt=OptimizerConfig(), accum_steps=0), rules)
        rec["accum_steps"] = microbatch(recipe, cfg, cell)[0]
        rec.update(analyze(recipe, cfg, cell, mesh, flags))
    rec["status"] = "ok"
    rec["t_trace_s"] = round(time.time() - t0, 2)
    if not quiet:
        mem, rf = rec["memory"], rec["roofline"]
        print(f"[{arch} × {shape} × {mesh_name} × {variant}] OK  "
              f"args={mem['argument_bytes'] / 2**30:.2f}GiB temp={mem['temp_bytes'] / 2**30:.2f}GiB "
              f"total={mem['total_per_device'] / 1e9:.2f}GB fits {mem['device_bytes'] / 1e9:.0f} GB: "
              f"{'yes' if mem['fits'] else 'NO'} "
              f"flops/dev={rec['cost']['flops_per_device']:.3e} dominant={rf['dominant']} "
              f"(c={rf['compute_s'] * 1e3:.1f}ms m={rf['memory_s'] * 1e3:.1f}ms "
              f"coll={rf['collective_s'] * 1e3:.1f}ms) {rec['t_trace_s']:.1f}s", flush=True)
    return rec


def mesh_label(mesh) -> str:
    sizes = mesh_shape(mesh)
    if sizes == {"data": 16, "model": 16}:
        return "pod16x16"
    if sizes == {"pod": 2, "data": 16, "model": 16}:
        return "pod2x16x16"
    return "x".join(f"{k}{v}" for k, v in sizes.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--layers", type=int, default=None, help="cut every arch to this many layers")
    ap.add_argument("--one-rank-step", type=int, nargs=3, metavar=("BATCH", "SEQ", "ACCUM"), default=None,
                    help="one rank's AdamW train step (remat) at BATCH x SEQ in ACCUM microbatches, in place of "
                         "the shape cells and production layouts")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    one_rank = {}
    if args.one_rank_step:
        b, t, a = args.one_rank_step
        shapes, meshes = [f"step{b}x{t}a{a}"], [False]
        one_rank = dict(mesh=MeshLayout((1, 1), ("data", "model")), cell=ShapeCell(shapes[0], t, b, "train"),
                        train_cfg=TrainConfig(opt=OptimizerConfig(), accum_steps=a, remat=True))

    failures, counts = [], Counter()
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                mesh_name = mesh_label(one_rank.get("mesh") or make_production_mesh(multi_pod=multi_pod))
                suffix = "" if args.variant == "baseline" else f"__{args.variant}"
                path = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}{suffix}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[{arch} × {shape} × {mesh_name}] cached", flush=True)
                    continue
                try:
                    rec = run_cell(arch, shape, multi_pod, variant=args.variant, n_layers=args.layers, **one_rank)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append((arch, shape, mesh_name))
                counts[rec["status"]] += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2, default=str)
    print(f"\ncells: {dict(counts)}")
    if failures:
        print(f"FAILURES ({len(failures)}):")
        for f_ in failures:
            print("  ", f_)
        return 1
    print("All requested dry-run cells ran.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
