"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --reduced \
        --device cpu --steps 20 --batch 8 --seq 128

Runs on ``cuda`` unless ``--device cpu`` is given, with the caching
allocator's segments growing in place while it trains there
(:func:`train_allocator`). ``--reduced`` runs the smoke-scale config.
:func:`run` takes the checkpoint store, any ``KVStore`` (the trainer
resumes from it: params, optimizer, step, data cursor). The
port has no storage engine of its own, so :func:`main` has no store to open
and trains with checkpoints off, and says so.
"""
from __future__ import annotations

import argparse
import contextlib

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import TrainConfig
from repro_torch.training.trainer import Trainer, TrainerConfig


def build(*, steps: int = 100, batch: int = 8, seq: int = 128, lr: float = 3e-4, accum: int = 1,
          ckpt_interval: int = 50) -> TrainerConfig:
    """The trainer's config, with the reference launcher's schedule: 20
    warmup steps, cosine over ``max(steps, 100)``."""
    return TrainerConfig(
        steps=steps,
        global_batch=batch,
        seq_len=seq,
        ckpt_interval=ckpt_interval,
        train=TrainConfig(opt=OptimizerConfig(lr=lr, warmup_steps=20, total_steps=max(steps, 100)),
                          accum_steps=accum),
    )


@contextlib.contextmanager
def train_allocator(device=None):
    """On the card, the caching allocator's segments grow in place
    (``expandable_segments``) while the block runs; fixed-size segments come
    back after it. recurrentgemma-9b at 9 layers, global batch 4 × 512 in 2
    microbatches, holds 74.0 GB allocated at its peak on an H100 80GB HBM3
    (700 W): fixed-size segments reserved 83.1 GB around its 4.2 GB
    embedding gradients and 1 GB logits, growing ones 76.9 GB. On another
    device it does nothing."""
    if resolve_device(device).type != "cuda":
        yield
        return
    torch.cuda.empty_cache()
    torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        torch._C._accelerator_setAllocatorSettings("expandable_segments:False")


def run(cfg, tcfg: TrainerConfig, store=None, device=None):
    """Train ``cfg`` on ``device``, checkpointing into ``store`` (None: no
    checkpoints), under :func:`train_allocator`. Returns ``(trainer,
    result)``; the caller closes the trainer, which closes the store."""
    with train_allocator(device):
        trainer = Trainer(cfg, tcfg, store, device=device)
        return trainer, trainer.run()


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--d-model", type=int, default=0, help="override reduced d_model")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(**({"d_model": args.d_model} if args.d_model else {}))
    tcfg = build(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, accum=args.accum)
    print("checkpoints: off (the port has no storage engine to open; launch.train.run takes a store)")
    trainer, result = run(cfg, tcfg, None, args.device)
    try:
        print("result:", {k: v for k, v in result.items() if k != "metrics"})
        if result["metrics"]:
            first, last = result["metrics"][0], result["metrics"][-1]
            print(f"loss: {first['loss']:.4f} -> {last['loss']:.4f}")
    finally:
        trainer.close()
    return result


if __name__ == "__main__":
    main()
