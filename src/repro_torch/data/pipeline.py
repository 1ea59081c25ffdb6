"""Deterministic, checkpointable, host-sharded data pipeline (numpy only).

The port's own copy of the reference's pipeline: equal ``{seed, step, host,
num_hosts}`` give equal batches in both packages, ``extra_fields`` included.

State is {seed, step, host, num_hosts} — saving it in the checkpoint META
and restoring gives exact-batch resume (tested). Sources: synthetic token
stream (hash-counter PRNG, no global RNG state) or a memory-mapped token
file. Each host draws only its shard of the global batch; the trainer
forms global arrays from per-host shards (single-host here, but the
sharding math is the multi-host layout).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PipelineState:
    seed: int
    step: int
    host: int = 0
    num_hosts: int = 1

    def as_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step, "host": self.host, "num_hosts": self.num_hosts}

    @staticmethod
    def from_dict(d: dict) -> "PipelineState":
        return PipelineState(d["seed"], d["step"], d.get("host", 0), d.get("num_hosts", 1))


class TokenPipeline:
    def __init__(
        self,
        vocab: int,
        global_batch: int,
        seq_len: int,
        seed: int = 0,
        host: int = 0,
        num_hosts: int = 1,
        token_file: str | None = None,
        extra_fields: dict | None = None,
    ):
        assert global_batch % num_hosts == 0
        self.vocab = vocab
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.local_batch = global_batch // num_hosts
        self.state = PipelineState(seed, 0, host, num_hosts)
        self._tokens = None
        if token_file is not None:
            self._tokens = np.memmap(token_file, dtype=np.int32, mode="r")
        self.extra_fields = extra_fields or {}

    # counter-based PRNG → stateless, exactly resumable
    def _rng(self, step: int) -> np.random.Generator:
        key = (self.state.seed * 0x9E3779B1 + step * 0x85EBCA77 + self.state.host) & 0xFFFFFFFF
        return np.random.default_rng(key)

    def next_batch(self) -> dict:
        step = self.state.step
        rng = self._rng(step)
        B, S = self.local_batch, self.seq_len
        if self._tokens is not None:
            n = len(self._tokens) - (S + 1)
            starts = rng.integers(0, n, size=B)
            tok = np.stack([self._tokens[s : s + S + 1] for s in starts]).astype(np.int32)
        else:
            # zipf-flavored synthetic stream (bounded to vocab)
            tok = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
            tok = (tok % (self.vocab - 2)) + 1
            tok = tok.astype(np.int32)
        batch = {"tokens": tok[:, :S], "labels": tok[:, 1 : S + 1]}
        for name, spec in self.extra_fields.items():
            shape, dtype = spec
            batch[name] = rng.normal(0, 0.02, size=(B, *shape)).astype(dtype)
        self.state.step += 1
        return batch

    # -- checkpoint integration -------------------------------------------
    def state_dict(self) -> dict:
        return self.state.as_dict()

    def load_state_dict(self, d: dict) -> None:
        self.state = PipelineState.from_dict(d)
