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

Checkpoints go, as the reference's, to a
:class:`~repro_torch.checkpoint.bvstore.BVCheckpointStore` over the port's
engine (:mod:`repro_torch.core`) at ``TrainerConfig.ckpt_dir``. Tests may
inject a store instead (``store=``, any ``KVStore``, which the checkpoint
store wraps and owns). With neither (``ckpt_dir=None``, the default) the
trainer keeps no checkpoints; no entry point runs it so (the timed steps of
``chip_smoke.py`` phase 6b and ``launch/profile_train.py`` call the train
step without the trainer). The step is eager (the reference's ``jit`` with
donation becomes in-place updates), on ``cuda`` unless ``device`` names
another.

Under a mesh (``mesh=``, a ``DeviceMesh`` over an initialised process
group; the reference's ``Trainer(mesh=…)``): the state is made as without
one, from the same seed, then placed by the reference's logical axes
(:func:`~repro_torch.training.train_step.place_state`); every rank draws the
global batch from its own pipeline (one cursor) and the step runs its rows
(:func:`~repro_torch.training.train_step.accumulate_grads`). Only global
rank 0 opens the store: it broadcasts the step to resume from, its META and
its leaves, which every rank places; a save gathers every leaf on every rank
and rank 0 writes the same checkpoint a run without a mesh writes, so either
resumes the other, on any mesh shape. A SIGTERM on any rank stops every
rank at the same step: the flag is all-reduced (MAX) before each step's
save. Straggler detection stays per rank.
"""
from __future__ import annotations

import contextlib
import signal
import statistics
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.checkpoint.bvstore import BVCheckpointStore
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch import dist as rdist
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.tree import leaves, tree_map
from .optimizer import OptimizerConfig
from .train_step import TrainConfig, init_state, make_train_step, place_state


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
    ckpt_dir: str | None = None  # None: no checkpoints, unless a store is injected
    ckpt_interval: int = 50
    ckpt_async: bool = True
    keep_last: int = 2
    seed: int = 0
    log_every: int = 10
    straggler_factor: float = 3.0
    train: TrainConfig = field(default_factory=lambda: TrainConfig(opt=OptimizerConfig(warmup_steps=10, total_steps=1000)))


class Trainer:
    def __init__(self, model_cfg, tcfg: TrainerConfig, store=None, *, device=None, mesh=None, straggler_cb=None):
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.rank = 0
        if mesh is not None:
            import torch.distributed as dist

            if not dist.is_initialized():
                raise RuntimeError("Trainer(mesh=...) needs an initialised process group (init_process_group)")
            if device is not None and torch.device(device).type != mesh.device_type:
                raise ValueError(f"device {device!r} is not the mesh's device type {mesh.device_type!r}")
            device = mesh.device_type
            self.rank = dist.get_rank()
            if self.rank != 0 and store is not None:
                raise ValueError("under a mesh only global rank 0 holds the store")
        self.device = resolve_device(device)
        self.model = build_model(model_cfg, self.device)
        if self.rank != 0:
            self.store = None
        elif store is not None:
            self.store = BVCheckpointStore(db=store)
        elif tcfg.ckpt_dir is not None:
            self.store = BVCheckpointStore(tcfg.ckpt_dir)
        else:
            self.store = None
        # under a mesh every rank holds a manager (rank 0's store decides, _init_or_restore)
        self.ckpt = (CheckpointManager(self.store, tcfg.ckpt_interval, tcfg.keep_last, tcfg.ckpt_async)
                     if self.store is not None or mesh is not None else None)
        self.pipeline = TokenPipeline(model_cfg.vocab, tcfg.global_batch, tcfg.seq_len, seed=tcfg.seed,
                                      extra_fields=extra_fields(model_cfg))
        self.state = None
        self.step_times: list[float] = []
        self.straggler_events = 0
        self.straggler_cb = straggler_cb
        self._preempted = False
        self.metrics_log: list[dict] = []
        self.restore_seconds: float | None = None  # reading the checkpoint resumed from

    # ------------------------------------------------------------------
    def _init_or_restore(self) -> int:
        """The state from the seed, or from the store's latest checkpoint.
        Under a mesh rank 0 alone reads the store: the step, its META and
        its leaves are broadcast, and every rank places the state."""
        opt = self.tcfg.train.opt
        latest = self.store.latest_step() if self.store is not None else None
        meta = None
        if self.mesh is not None:  # rank 0's store decides for every rank
            import torch.distributed as dist

            head = [(self.store is not None, latest, self.store.load_meta(latest) if latest is not None else None)]
            dist.broadcast_object_list(head, src=0)
            has_store, latest, meta = head[0]
            if not has_store:
                self.ckpt = None
        if latest is None:
            gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
            self.state = init_state(self.model, gen, opt)
        else:
            self.state = init_state(self.model, None, opt)
            t0 = time.monotonic()
            loaded = None
            if self.store is not None:
                loaded, meta = self.store.load(latest, template=self.state)
            with torch.no_grad():
                if self.mesh is None:
                    tree_map(lambda t, src: t.copy_(src), self.state, loaded)
                else:  # leaf by leaf on the mesh's device, rank 0's values
                    srcs = leaves(loaded) if loaded is not None else leaves(self.state)
                    for t, src in zip(leaves(self.state), srcs):
                        buf = src.to(self.device)
                        dist.broadcast(buf, src=0)
                        t.copy_(buf)
            self.restore_seconds = time.monotonic() - t0
            self.pipeline.load_state_dict(meta["extra"]["pipeline"])
        if self.mesh is not None:
            self.state = place_state(self.model, self.state, opt, self.mesh)
        return 0 if latest is None else int(meta["step"])

    def _handle_sigterm(self, signum, frame):
        self._preempted = True

    def _agreed_preemption(self) -> bool:
        """Whether any rank was asked to stop: under a mesh an all-reduce
        (MAX) of the flag, which every rank makes once a step."""
        if self.mesh is None:
            return self._preempted
        import torch.distributed as dist

        flag = torch.tensor([int(self._preempted)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        self._preempted = bool(flag.item())
        return self._preempted

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
        ctx = rdist.mesh_context(self.mesh) if self.mesh is not None else contextlib.nullcontext()
        try:
            with ctx:
                return self._loop(step_fn)
        finally:
            signal.signal(signal.SIGTERM, prev_handler)

    def _loop(self, step_fn) -> dict:
        tcfg = self.tcfg
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
            preempted = self._agreed_preemption()
            self._save(step + 1, now=False)
            if preempted:
                self._save(step + 1, now=True)
                print(f"preempted at step {step + 1}; checkpoint committed", flush=True)
                return {"status": "preempted", "step": step + 1, "metrics": self.metrics_log}
        self._save(tcfg.steps, now=True)
        return {"status": "done", "step": tcfg.steps, "metrics": self.metrics_log}

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
        if self.store is not None:
            self.store.close()
