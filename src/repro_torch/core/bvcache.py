"""BVCache — the paper's big-value read cache (§III-D).

A fixed-capacity in-memory structure with a hash index for O(1) key lookup.
New writes are admitted at the MRU end (Most-Recent-Write-First), so values
not yet persisted by the asynchronous BValue writers remain readable.
Eviction removes from the LRU end using a recency (LRU) or frequency (LFU)
policy, per the paper's "depending on system load conditions".

Un-persisted entries are *pinned* (dropping one would lose the only copy in
WAL-disabled mode). Pinned entries live in a separate ordered map so the
eviction path never scans them — O(1) eviction even when the cache is
pin-saturated; the BValue writer unpins (in batch) on flush completion.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

from .record import ValueOffset


@dataclass(slots=True)
class _Entry:
    voff: ValueOffset
    value: bytes
    freq: int
    ts: float


class BVCache:
    def __init__(self, capacity_bytes: int, policy: str = "lru"):
        assert policy in ("lru", "lfu")
        self.capacity = capacity_bytes
        self.policy = policy
        self._map: OrderedDict[bytes, _Entry] = OrderedDict()  # evictable
        self._pinned: OrderedDict[bytes, _Entry] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._map) + len(self._pinned)

    @property
    def size_bytes(self) -> int:
        return self._bytes

    # -- write path -----------------------------------------------------
    def insert(self, key: bytes, voff: ValueOffset, value: bytes, pinned: bool = False) -> None:
        with self._lock:
            old = self._map.pop(key, None) or self._pinned.pop(key, None)
            if old is not None:
                self._bytes -= len(key) + len(old.value)
            ent = _Entry(voff, value, (old.freq + 1 if old else 1), time.monotonic())
            (self._pinned if pinned else self._map)[key] = ent  # MRU end
            self._bytes += len(key) + len(value)
            self._evict_locked()

    def unpin(self, key: bytes, voff: ValueOffset) -> None:
        """BValue writer completed persisting `key`'s value at `voff`."""
        self.unpin_many(((key, voff),))

    def unpin_many(self, items) -> None:
        """Batch unpin — one lock acquisition per BValue flush batch. Matches
        on location (file/offset/size) only: the BValue writer does not carry
        the value CRC, so full ValueOffset equality would never unpin."""
        with self._lock:
            for key, voff in items:
                ent = self._pinned.get(key)
                if ent is not None and (
                    ent.voff.file_id == voff.file_id
                    and ent.voff.offset == voff.offset
                    and ent.voff.size == voff.size
                ):
                    del self._pinned[key]
                    self._map[key] = ent  # joins the evictable order at MRU
            self._evict_locked()

    # -- read path ------------------------------------------------------
    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            ent = self._map.get(key)
            if ent is not None:
                ent.freq += 1
                ent.ts = time.monotonic()
                self._map.move_to_end(key, last=True)
                self.hits += 1
                return ent.value
            ent = self._pinned.get(key)
            if ent is not None:
                ent.freq += 1
                self.hits += 1
                return ent.value
            self.misses += 1
            return None

    def get_if_unpersisted(self, key: bytes, voff: ValueOffset, pinned_only: bool = False) -> bytes | None:
        with self._lock:
            ent = self._pinned.get(key)
            if ent is None and not pinned_only:
                ent = self._map.get(key)
            if ent is not None and ent.voff == voff:
                return ent.value
            return None

    # -- eviction ---------------------------------------------------------
    def _evict_locked(self) -> None:
        if self.policy == "lfu":
            while self._bytes > self.capacity and self._map:
                # sampled-LFU: least-frequent among the 16 LRU-most entries
                candidates = []
                for i, (k, e) in enumerate(self._map.items()):
                    candidates.append((e.freq, e.ts, k))
                    if i >= 15:
                        break
                _, _, victim = min(candidates)
                ent = self._map.pop(victim)
                self._bytes -= len(victim) + len(ent.value)
        else:  # lru — pop from the LRU end; pinned entries are elsewhere
            while self._bytes > self.capacity and self._map:
                k, ent = self._map.popitem(last=False)
                self._bytes -= len(k) + len(ent.value)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self),
            "pinned": len(self._pinned),
            "bytes": self._bytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
        }
