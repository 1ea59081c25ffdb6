"""Async checkpoint manager, as the reference's: snapshots the state to the
host, hands the write to a background thread (its chunks flow through the
store's BValue writers), keeps the last N checkpoints, and gives the
trainer's SIGTERM handler ``save_now``, whose WAL-committed META record
makes the shutdown checkpoint crash-consistent.

The snapshot is a host copy made before the thread starts: ``.to("cpu")``
of a device tensor, ``clone()`` of a CPU one (whose ``.cpu()`` would be the
same tensor). The optimizer updates parameters in place, so a write that
held references would store the next step's weights.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.tree import tree_map
from .bvstore import BVCheckpointStore


def host_snapshot(leaf):
    """A host copy of ``leaf`` that later in-place updates do not reach."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.to("cpu") if t.device.type != "cpu" else t.clone()
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(
        self,
        store: BVCheckpointStore,
        interval_steps: int = 100,
        keep_last: int = 3,
        async_save: bool = True,
    ):
        self.store = store
        self.interval = interval_steps
        self.keep_last = keep_last
        self.async_save = async_save
        self._prev_hashes: dict | None = None
        self._pending: threading.Thread | None = None
        self._lock = threading.Lock()
        self.save_count = 0
        self.stall_seconds = 0.0  # time the train loop was blocked
        self.save_times: list[tuple[int, float]] = []  # (step, seconds in store.save) of each save

    def maybe_save(self, step: int, state, extra_meta: dict | None = None) -> bool:
        if step % self.interval != 0:
            return False
        self.save_now(step, state, extra_meta)
        return True

    def save_now(self, step: int, state, extra_meta: dict | None = None) -> None:
        t0 = time.monotonic()
        self.wait()  # one in-flight checkpoint at a time
        host_state = tree_map(host_snapshot, state)
        snapshot_s = time.monotonic() - t0

        def _write():
            t1 = time.monotonic()
            hashes = self.store.save(step, host_state, extra_meta, prev_hashes=self._prev_hashes)
            with self._lock:
                self._prev_hashes = hashes
                self.save_count += 1
                self.save_times.append((step, time.monotonic() - t1))
            self._retire()

        if self.async_save:
            self._pending = threading.Thread(target=_write, name=f"ckpt-{step}", daemon=True)
            self._pending.start()
            self.stall_seconds += snapshot_s  # the loop pays only the snapshot
        else:
            _write()
            self.stall_seconds += time.monotonic() - t0

    def _retire(self) -> None:
        """Deletes all but the last ``keep_last`` steps, sparing any step whose
        chunks a kept checkpoint reuses."""
        steps = self.store.steps()
        keep = set(steps[-self.keep_last:])
        referenced = set()
        for s in keep:
            for ent in self.store.load_meta(s)["manifest"]:
                if "reuse_step" in ent:
                    referenced.add(ent["reuse_step"])
        for s in steps[: -self.keep_last]:
            if s not in referenced:
                try:
                    self.store.delete_step(s)
                except KeyError:
                    pass

    def wait(self) -> None:
        if self._pending is not None and self._pending.is_alive():
            t0 = time.monotonic()
            self._pending.join()
            self.stall_seconds += time.monotonic() - t0
        self._pending = None

    def close(self) -> None:
        self.wait()
