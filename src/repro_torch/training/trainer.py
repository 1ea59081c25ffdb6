"""Fault-tolerant training loop, as the reference's.

* BVLSM checkpoint/restart: resume restores params, optimizer state, step
  and the data-pipeline cursor (from META ``extra``), for exact-batch
  resume.
* Preemption: SIGTERM sets a flag; after the step in flight the loop commits
  a checkpoint and returns ``status: preempted``.
* Stragglers: a step slower than ``straggler_factor`` × the median of the
  last 32 (once 8 are in) counts an event and calls ``straggler_cb(step,
  dt, median)``.
* Async checkpoints: the loop pays only the host snapshot
  (``CheckpointManager.stall_seconds``).

The store is injected (the port has no storage engine): any ``KVStore``,
which :class:`~repro_torch.checkpoint.bvstore.BVCheckpointStore` wraps and
owns. ``store=None`` trains with checkpoints off. The step is eager (the
reference's ``jit`` with donation becomes in-place updates), on ``cuda``
unless ``device`` names another.
"""
from __future__ import annotations

import signal
import statistics
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.checkpoint.bvstore import BVCheckpointStore
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.tree import tree_map
from .optimizer import OptimizerConfig
from .train_step import TrainConfig, init_state, make_train_step


def extra_fields(model_cfg) -> dict:
    """The pipeline's inputs beside the tokens, as the reference trainer's:
    a vlm model's patch embeddings, an audio model's frame embeddings."""
    d = model_cfg.d_model
    if model_cfg.family == "vlm":
        return {"vision_embeds": ((model_cfg.n_vision_patches, d), np.float32)}
    if model_cfg.family == "audio":
        return {"enc_embeds": ((model_cfg.enc_len, d), np.float32)}
    return {}


@dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_interval: int = 50
    ckpt_async: bool = True
    keep_last: int = 2
    seed: int = 0
    log_every: int = 10
    straggler_factor: float = 3.0
    train: TrainConfig = field(default_factory=lambda: TrainConfig(opt=OptimizerConfig(warmup_steps=10, total_steps=1000)))


class Trainer:
    def __init__(self, model_cfg, tcfg: TrainerConfig, store=None, *, device=None, straggler_cb=None):
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.model = build_model(model_cfg, self.device)
        self.store = BVCheckpointStore(store) if store is not None else None
        self.ckpt = (CheckpointManager(self.store, tcfg.ckpt_interval, tcfg.keep_last, tcfg.ckpt_async)
                     if self.store is not None else None)
        self.pipeline = TokenPipeline(model_cfg.vocab, tcfg.global_batch, tcfg.seq_len, seed=tcfg.seed,
                                      extra_fields=extra_fields(model_cfg))
        self.state = None
        self.step_times: list[float] = []
        self.straggler_events = 0
        self.straggler_cb = straggler_cb
        self._preempted = False
        self.metrics_log: list[dict] = []

    # ------------------------------------------------------------------
    def _init_or_restore(self) -> int:
        latest = self.store.latest_step() if self.store is not None else None
        if latest is None:
            gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
            self.state = init_state(self.model, gen, self.tcfg.train.opt)
            return 0
        self.state = init_state(self.model, None, self.tcfg.train.opt)
        loaded, meta = self.store.load(latest, template=self.state)
        with torch.no_grad():
            tree_map(lambda t, src: t.copy_(src), self.state, loaded)
        self.pipeline.load_state_dict(meta["extra"]["pipeline"])
        return int(meta["step"])

    def _handle_sigterm(self, signum, frame):
        self._preempted = True

    def _save(self, step: int, now: bool) -> None:
        if self.ckpt is None:
            return
        extra = {"pipeline": self.pipeline.state_dict()}
        if now:
            self.ckpt.save_now(step, self.state, extra)
            self.ckpt.wait()
        else:
            self.ckpt.maybe_save(step, self.state, extra)

    def _batch(self) -> dict:
        return {k: torch.from_numpy(v).to(self.device) for k, v in self.pipeline.next_batch().items()}

    # ------------------------------------------------------------------
    def run(self) -> dict:
        tcfg = self.tcfg
        prev_handler = signal.signal(signal.SIGTERM, self._handle_sigterm)
        step_fn = make_train_step(self.model, tcfg.train)
        try:
            start = self._init_or_restore()
            for step in range(start, tcfg.steps):
                t0 = time.monotonic()
                self.state, metrics = step_fn(self.state, self._batch())
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.monotonic() - t0
                self.step_times.append(dt)
                self._check_straggler(step, dt)
                metrics["step_s"] = dt
                metrics["step"] = step + 1
                self.metrics_log.append(metrics)
                if (step + 1) % tcfg.log_every == 0:
                    print(f"step {step + 1}: loss={metrics.get('loss', float('nan')):.4f} ({dt * 1e3:.0f} ms)",
                          flush=True)
                self._save(step + 1, now=False)
                if self._preempted:
                    self._save(step + 1, now=True)
                    print(f"preempted at step {step + 1}; checkpoint committed", flush=True)
                    return {"status": "preempted", "step": step + 1, "metrics": self.metrics_log}
            self._save(tcfg.steps, now=True)
            return {"status": "done", "step": tcfg.steps, "metrics": self.metrics_log}
        finally:
            signal.signal(signal.SIGTERM, prev_handler)

    def _check_straggler(self, step: int, dt: float) -> None:
        if len(self.step_times) < 8:
            return
        med = statistics.median(self.step_times[-32:])
        if dt > self.tcfg.straggler_factor * med:
            self.straggler_events += 1
            if self.straggler_cb is not None:
                self.straggler_cb(step, dt, med)

    def close(self) -> None:
        if self.ckpt is not None:
            self.ckpt.close()
            self.store.close()
