"""Serving launcher: continuous batching over the BVLSM-style paged KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --requests 8 --prompt-len 128 --max-new 32 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --prompt-len 1024 --max-len 1280
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --prompt-len 2048 --max-new 32 --max-len 2112
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --reduced --device cpu --prompt-len 40 --max-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
        --requests 8 --prompt-len 128 --max-new 32 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        --requests 8 --prompt-len 128 --max-new 32 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small --reduced --device cpu

whisper-small serves from zero frame embeddings (the engine passes none),
as the reference engine does.

Runs on ``cuda`` unless ``--device cpu`` is given. Weights are random, drawn
from seed 0, in bf16 on the device one tensor at a time.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServingEngine

MAX_LEN = 256
SEED = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cfg, device=None):
    """``cfg`` with random bf16 weights drawn from ``SEED`` on ``device``."""
    dev = resolve_device(device)
    model = build_model(cfg, dev, param_dtype=torch.bfloat16)
    return model.init(torch.Generator(device=dev).manual_seed(SEED))


def run(model, *, requests: int, prompt_len: int, max_new: int, max_batch: int, max_len: int = MAX_LEN):
    """Serve ``requests`` random prompts to completion in an engine of
    ``max_len`` positions per sequence; returns ``(engine, metrics)`` with
    the wall time of the whole run."""
    engine = ServingEngine(model, max_batch=max_batch, max_len=max_len)
    rng = np.random.default_rng(SEED)
    _sync(model.device)
    t0 = time.perf_counter()
    for rid in range(requests):
        prompt = rng.integers(1, model.cfg.vocab, size=prompt_len).astype(np.int32)
        engine.submit(Request(rid, prompt, max_new_tokens=max_new))
    engine.run_until_drained()
    _sync(model.device)
    wall = time.perf_counter() - t0
    m = engine.metrics()
    m.update(wall_s=wall, tokens_per_s=m["tokens"] / wall,
             prefill_calls=engine.prefill_calls, decode_calls=engine.decode_calls)
    return engine, m


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=MAX_LEN)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    engine, m = run(build(cfg, dev), requests=args.requests, prompt_len=args.prompt_len,
                    max_new=args.max_new, max_batch=args.max_batch, max_len=args.max_len)
    print("served:", m)
    for r in engine.finished[:3]:
        print(f"  req {r.req_id}: {len(r.tokens)} tokens, first 8 = {r.tokens[:8]}")
    return m


if __name__ == "__main__":
    main()
