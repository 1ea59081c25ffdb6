"""Where a training step's time goes on the card: ``torch.profiler`` over one
train step of a model at full width, after a warm-up step.

    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch qwen3-4b \
        --batch 4 --seq 512 --accum 2
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch recurrentgemma-9b --layers 9
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch granite-moe-1b-a400m
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch whisper-small
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch qwen2-moe-a2.7b --layers 6

fp32 masters, ``cfg.dtype`` compute, AdamW, remat, the training entry's
allocator (``launch/train.py::train_allocator``), random weights from seed
0 and TokenPipeline batches with the inputs beside the tokens that the
trainer gives the config (``trainer.extra_fields``: whisper's frame
embeddings). Prints the step's wall time (timed once without the profiler,
then run again under it), the device's busy time (the sum of its kernel
and copy times: one stream, so they do not overlap) and busy share, the
device time by kernel group and of the top kernels (as ``profile_serve``)
and by part of the step, each a set of the program's spans
(:mod:`repro_torch.trace`): the kernels launched inside the optimizer
update, the gradient clip, the attention, SSD and RG-LRU backwards (the
torch ops of ``ops.Attention``, ``ops.SSDScan`` and ``ops.RGLRU``), the
loss's forward (the recompute in the backward is outside it), and a MoE
model's FFN and its dispatch and whisper's encoder, as ``profile_serve``
names them: the FFN and the dispatch run again in each layer's remat
recompute, inside the backward, and open their spans there too; the
encoder's layers recompute outside its span. The last line is the same as
one JSON object. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import cut, get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.profile_serve import PARTS as SERVE_PARTS
from repro_torch.launch.profile_serve import device_time, top_kernels
from repro_torch.launch.train import train_allocator
from repro_torch.models import build_model
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import TrainConfig, init_state, make_train_step
from repro_torch.training.trainer import extra_fields

PARTS = {  # part of the step: the program's spans whose launches it covers
    "optimizer update": ("optimizer",),
    "gradient clip": ("clip",),
    "attention backward": ("attention.backward",),
    "SSD backward": ("ssd.backward",),
    "RG-LRU backward": ("rglru.backward",),
    "loss forward": ("forward",),
    **SERVE_PARTS,  # "moe ffn", "moe dispatch", "whisper encoder"
}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--accum", type=int, default=2)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    with train_allocator(dev):  # as launch/train.py trains
        return profile_step(args, dev)


def profile_step(args, dev: torch.device) -> dict:
    """The module's reading for the parsed ``args``, on ``dev``."""
    cfg = cut(args.arch, args.layers) if args.layers else get_config(args.arch)
    model = build_model(cfg, dev)
    opt = OptimizerConfig(warmup_steps=2, total_steps=100)
    state = init_state(model, torch.Generator(device=dev).manual_seed(0), opt)
    pipe = TokenPipeline(cfg.vocab, args.batch, args.seq, seed=0, extra_fields=extra_fields(cfg))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()} for _ in range(3)]
    step = make_train_step(model, TrainConfig(opt=opt, accum_steps=args.accum))
    state, _ = step(state, batches[0])  # warm-up: kernel builds, cuBLAS, allocator, gradient buffers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, batches[1])  # the step without the profiler
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batches[2])
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0

    by_group, parts = device_time(prof, PARTS)
    by_part = {name: sum(groups.values()) for name, groups in parts.items()}
    busy = sum(by_group.values()) / 1e3
    out = {
        "device": torch.cuda.get_device_name(0), "arch": cfg.name, "layers": cfg.n_layers,
        "batch": args.batch, "seq": args.seq, "accum": args.accum, "loss": float(metrics["loss"]),
        "wall_s": wall, "wall_profiled_s": wall_profiled, "device_busy_s": busy, "busy_share": busy / wall,
        "groups_ms": {g: v for g, v in sorted(by_group.items(), key=lambda kv: -kv[1])},
        "parts_ms": by_part,
        "top_kernels_ms": top_kernels(prof),
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"train step: {wall:.3f} s wall ({wall_profiled:.3f} s profiled), device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%), {args.batch} x {args.seq} tokens in {args.accum} microbatches")
    for g, v in out["groups_ms"].items():
        print(f"  {g:24s} {v:10.3f} ms")
    for g, v in by_part.items():
        print(f"  part: {g:18s} {v:10.3f} ms")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
