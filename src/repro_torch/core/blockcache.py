"""Shared cache over decoded SSTable data blocks (2Q or plain LRU).

One cache instance is owned by the DB and handed to every
:class:`~repro_torch.core.sstable.SSTableReader` through the
:class:`~repro_torch.core.manifest.VersionSet`, so foreground gets, scans, and
compaction all read the same decoded blocks. Entries are keyed
``(file_no, block_idx)`` and charged by decoded payload bytes
(:attr:`Block.charge`) — the cache holds *decoded* blocks, so a hit skips
both the pread and the decompress/trailer parse.

Admission (``policy="2q"``, the default): a first-touch block enters a
probationary FIFO (**A1in**). It is promoted to the main LRU (**Am**) only
when it proves reuse — a second reference while still probationary, or
readmission while its key is remembered by the **A1out** ghost list (keys
of recently evicted probationary blocks, held at zero byte cost). One-shot
sequential sweeps (cursor scans, non-bypass compaction reads) therefore
churn only the A1in fraction of the budget and can never flush the
point-get working set out of Am. Eviction takes the A1in FIFO head while
A1in exceeds its fraction of the shard budget (its key moving to the
ghost), otherwise the Am LRU tail. ``policy="lru"`` restores the plain
LRU (everything lives in Am).

Lock sharding: the key hash picks one of ``shards`` independent shards, so
concurrent readers on different blocks never serialize on one mutex. Each
shard gets ``capacity / shards`` bytes.

Dropped files need no explicit invalidation: file numbers are never
reused (``VersionSet.next_file_no`` is monotonic), so a dead file's blocks
simply age out. ``evict_file`` exists to reclaim them eagerly after
compaction unlinks an input.

Accounting invariant: ``size_bytes`` is the sum of the remembered
per-entry charges, adjusted only under the owning shard's lock. A
``recharge`` (a resident block grew by materializing its parsed form)
re-checks, lock-held, that the SAME block object is still resident — a
block evicted or replaced by a concurrent ``evict_file``/``put`` must not
have its delta applied, or the shard's byte count would drift permanently.
"""
from __future__ import annotations

import threading
from collections import OrderedDict


class _Shard:
    __slots__ = (
        "lock", "am", "a1in", "ghost", "bytes", "a1_bytes", "capacity",
        "a1_capacity", "ghost_cap", "two_q", "hits", "misses", "evictions",
        "promotions", "ghost_hits",
    )

    def __init__(self, capacity: int, two_q: bool, a1_fraction: float):
        self.lock = threading.Lock()
        # value = [block, charged_bytes]: the charge is remembered at
        # insert/recharge time so accounting stays exact even though a
        # block's live charge grows when it materializes
        self.am: OrderedDict[tuple[int, int], list] = OrderedDict()
        self.a1in: OrderedDict[tuple[int, int], list] = OrderedDict()
        # ghost: key-only memory of recently evicted probationary blocks
        # (value unused); ~one slot per 8 KiB of budget. Kept proportional
        # to the shard's capacity measured in blocks: an oversized A1out
        # would remember an entire repeated sweep, readmitting every swept
        # block straight to Am and silently degrading 2Q back to LRU.
        self.ghost: OrderedDict[tuple[int, int], None] = OrderedDict()
        self.bytes = 0
        self.a1_bytes = 0
        self.capacity = capacity
        self.a1_capacity = int(capacity * a1_fraction)
        self.ghost_cap = max(16, capacity // 8192)
        self.two_q = two_q
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.promotions = 0
        self.ghost_hits = 0

    def _evict_locked(self) -> None:
        while self.bytes > self.capacity and (self.am or self.a1in):
            if self.a1in and (not self.am or self.a1_bytes > self.a1_capacity):
                key, (_, charged) = self.a1in.popitem(last=False)
                self.a1_bytes -= charged
                # remember the key so a prompt re-read earns Am directly
                self.ghost[key] = None
                if len(self.ghost) > self.ghost_cap:
                    self.ghost.popitem(last=False)
            else:
                _, (_, charged) = self.am.popitem(last=False)
            self.bytes -= charged
            self.evictions += 1


class BlockCache:
    """Sharded 2Q/LRU over decoded blocks; thread-safe; ``capacity_bytes
    <= 0`` disables caching entirely (every ``get`` misses, ``put`` is a
    no-op)."""

    def __init__(
        self,
        capacity_bytes: int,
        shards: int = 8,
        policy: str = "2q",
        a1_fraction: float = 0.25,
    ):
        if policy not in ("2q", "lru"):
            raise ValueError(f"unknown block cache policy {policy!r}")
        self.capacity = max(0, capacity_bytes)
        self.policy = policy
        n = max(1, shards)
        two_q = policy == "2q"
        self._shards = [
            _Shard(self.capacity // n, two_q, a1_fraction) for _ in range(n)
        ]
        self._n = n

    def _shard(self, key: tuple[int, int]) -> _Shard:
        return self._shards[hash(key) % self._n]

    def get(self, key: tuple[int, int]):
        s = self._shard(key)
        with s.lock:
            ent = s.am.get(key)
            if ent is not None:
                s.am.move_to_end(key)
                s.hits += 1
                return ent[0]
            ent = s.a1in.get(key)
            if ent is not None:
                # re-referenced while probationary → it has proven reuse;
                # promote to the protected main queue
                del s.a1in[key]
                s.a1_bytes -= ent[1]
                s.am[key] = ent
                s.promotions += 1
                s.hits += 1
                return ent[0]
            s.misses += 1
            return None

    def peek(self, key: tuple[int, int]):
        """Read-through lookup for bypass streams (compaction): returns the
        cached block WITHOUT promoting it (no A1in→Am, no MRU move) and
        without touching the hit/miss counters, so one-shot background
        sweeps neither reorder the foreground working set nor dilute the
        foreground hit rate."""
        s = self._shard(key)
        with s.lock:
            ent = s.am.get(key)
            if ent is None:
                ent = s.a1in.get(key)
            return None if ent is None else ent[0]

    def put(self, key: tuple[int, int], block) -> None:
        if self.capacity <= 0:
            return
        # the block will re-charge itself here when it materializes its
        # parsed form (Block._materialize), keeping the byte budget honest
        block._cache = self
        block._cache_key = key
        charge = block.charge
        s = self._shard(key)
        with s.lock:
            old = s.am.pop(key, None)
            if old is not None:
                s.bytes -= old[1]
            old = s.a1in.pop(key, None)
            if old is not None:
                s.bytes -= old[1]
                s.a1_bytes -= old[1]
            ent = [block, charge]
            if not s.two_q:
                s.am[key] = ent
            elif key in s.ghost:
                # evicted from probation recently and read again — that IS
                # the re-reference; admit straight to Am
                del s.ghost[key]
                s.ghost_hits += 1
                s.promotions += 1
                s.am[key] = ent
            else:
                s.a1in[key] = ent
                s.a1_bytes += charge
            s.bytes += charge
            s._evict_locked()

    def recharge(self, key: tuple[int, int], block) -> None:
        """Re-account one resident block whose live ``charge`` grew (it
        materialized its parsed entries); evicts if now over budget.
        No-op if the block was evicted or replaced in the meantime — the
        lock-held identity check below is what keeps a recharge racing an
        ``evict_file`` from permanently inflating ``size_bytes``."""
        s = self._shard(key)
        with s.lock:
            in_a1 = False
            ent = s.am.get(key)
            if ent is None:
                ent = s.a1in.get(key)
                in_a1 = ent is not None
            if ent is None or ent[0] is not block:
                return
            delta = block.charge - ent[1]
            s.bytes += delta
            if in_a1:
                s.a1_bytes += delta
            ent[1] = block.charge
            s._evict_locked()

    def evict_file(self, file_no: int) -> None:
        """Drop every cached block of one (just-unlinked) table."""
        for s in self._shards:
            with s.lock:
                for k in [k for k in s.am if k[0] == file_no]:
                    s.bytes -= s.am.pop(k)[1]
                for k in [k for k in s.a1in if k[0] == file_no]:
                    charged = s.a1in.pop(k)[1]
                    s.bytes -= charged
                    s.a1_bytes -= charged
                for k in [k for k in s.ghost if k[0] == file_no]:
                    del s.ghost[k]

    @property
    def size_bytes(self) -> int:
        return sum(s.bytes for s in self._shards)

    def stats(self) -> dict:
        hits = sum(s.hits for s in self._shards)
        misses = sum(s.misses for s in self._shards)
        total = hits + misses
        return {
            "block_cache_hits": hits,
            "block_cache_misses": misses,
            "block_cache_evictions": sum(s.evictions for s in self._shards),
            "block_cache_bytes": self.size_bytes,
            "block_cache_entries": sum(
                len(s.am) + len(s.a1in) for s in self._shards
            ),
            "block_cache_hit_rate": hits / total if total else 0.0,
            "block_cache_promotions": sum(s.promotions for s in self._shards),
            "block_cache_ghost_hits": sum(s.ghost_hits for s in self._shards),
            "block_cache_a1_bytes": sum(s.a1_bytes for s in self._shards),
        }
