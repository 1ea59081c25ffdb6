"""MemTable.

RocksDB uses a concurrent skip list; this engine is single-writer (DB-level
lock), so we keep a hash map of ``user_key -> (seq, type, value)`` holding
the *newest* version plus exact byte accounting, and materialize sorted
order at flush/scan time. Behaviourally equivalent for a single writer; the
paper's MemTable argument is about *capacity* (big values exhausting it),
which the byte accounting models exactly.

``approximate_size`` counts key+value+fixed overhead, mirroring RocksDB
arena accounting — this is what makes the paper's point measurable: with
WAL-time separation a 64 KiB value contributes only ~VOFF_SIZE bytes here.

Three write-pipeline optimizations:

* ``add_batch`` applies a whole group-commit batch with one pass (the
  leader calls it once per follower batch instead of per entry);
* ``add_group_sharded`` fans a huge commit group out across a worker pool,
  partitioned by key hash — each key lives entirely in one shard and each
  shard applies its entries in sequence order, so the result is
  bit-identical to the sequential apply (per-key last-writer-wins is a
  per-shard property). Individual dict get/set ops are GIL-atomic, so the
  shards can share ``_table`` without a lock;
* the sorted key view is cached and only rebuilt when a *new* key has been
  inserted — overwrites keep it — so repeated ``range_items`` /
  ``sorted_items`` calls (scans, flush) stop re-sorting the entire dict.

The cache is versioned because readers run WITHOUT the DB mutex (scan
iterates after releasing it): writers bump ``_version`` on every new-key
insert, and a reader publishes its sorted list tagged with the version it
started from — a list built while a write raced in carries a stale tag and
is simply rebuilt, it can never masquerade as fresh.

MVCC extensions:

* ``_history`` retains *superseded* versions (oldest-first per key) while a
  live snapshot could still read them — the apply paths take a
  ``retain_from`` watermark (the oldest live snapshot's seq) and keep the
  overwritten record iff ``prev_seq <= retain_from``. With no snapshots the
  fast newest-only path is byte-identical to before. History lists are
  append-only and the previous version is appended BEFORE the table slot is
  overwritten, so a lock-free reader that sees the new head always finds
  the superseded version in history (``reversed()`` captures its end index
  at creation — racing appends are invisible to it).
* ``range_tombstones`` holds ``(seq, start, end)`` range-delete records
  (end exclusive); point reads consult :meth:`covering_tombstone_seq`.
"""
from __future__ import annotations

from bisect import bisect_left

from .record import MAX_SEQ, kTypeDeletion, kTypeRangeDeletion

ENTRY_OVERHEAD = 24  # node/arena bookkeeping per entry (approximation)


class MemTable:
    __slots__ = ("_table", "_bytes", "_version", "_sorted_cache", "_history",
                 "range_tombstones", "first_seq", "last_seq", "wal_no",
                 "recovery_logs")

    def __init__(self) -> None:
        self._table: dict[bytes, tuple[int, int, bytes]] = {}
        self._bytes = 0
        self._version = 0  # bumped on new-key insert (key set changed)
        self._sorted_cache: tuple[int, list[bytes]] | None = None  # (version, keys)
        # superseded-but-snapshot-visible versions, oldest-first per key
        self._history: dict[bytes, list[tuple[int, int, bytes]]] = {}
        # (seq, start, end-exclusive) range tombstones, insertion order
        self.range_tombstones: list[tuple[int, bytes, bytes]] = []
        self.first_seq: int | None = None
        self.last_seq = 0
        self.wal_no: int | None = None  # WAL file backing this memtable
        # WAL files this memtable was rebuilt from at recovery; they are the
        # ONLY durable copy of its entries, so flush deletes them strictly
        # after the L0 manifest commit (see compaction.flush_memtable)
        self.recovery_logs: list[str] | None = None

    def __len__(self) -> int:
        return len(self._table)

    @property
    def approximate_size(self) -> int:
        return self._bytes

    def add(self, seq: int, type_: int, key: bytes, value: bytes,
            retain_from: int | None = None):
        """Returns the superseded (seq, type, value) record, if any.

        ``retain_from`` is the newest live snapshot's sequence number (None
        = no snapshots): a superseded version with ``seq <= retain_from``
        is still visible to some snapshot and moves into ``_history``
        instead of being dropped."""
        if type_ == kTypeRangeDeletion:
            self._add_range_tombstone(seq, key, value)
            return None
        prev = self._table.get(key)
        if prev is not None:
            if retain_from is not None and prev[0] <= retain_from:
                # append BEFORE overwriting the head (lock-free readers)
                self._history.setdefault(key, []).append(prev)
                self._bytes += len(key) + ENTRY_OVERHEAD  # history node cost
            self._bytes -= len(key) + len(prev[2]) + ENTRY_OVERHEAD
        self._table[key] = (seq, type_, value)
        self._bytes += len(key) + len(value) + ENTRY_OVERHEAD
        if prev is None:
            # bump AFTER the insert (like add_batch): a lock-free reader that
            # sorted between a bump and the insert could otherwise publish a
            # list missing this key under a fresh version tag.
            self._version += 1
        if self.first_seq is None:
            self.first_seq = seq
        self.last_seq = max(self.last_seq, seq)
        return prev

    def _add_range_tombstone(self, seq: int, start: bytes, end: bytes) -> None:
        self.range_tombstones.append((seq, start, end))
        self._bytes += len(start) + len(end) + ENTRY_OVERHEAD
        if self.first_seq is None:
            self.first_seq = seq
        self.last_seq = max(self.last_seq, seq)

    def add_batch(self, seq: int, entries, retain_from: int | None = None) -> list:
        """Apply a group-commit batch of (type, key, value) entries sharing
        one sequence number. Returns the superseded records (same contract
        as ``add``) for entries that overwrote an existing key."""
        table = self._table
        history = self._history
        nbytes = 0
        new_keys = 0
        prevs = []
        for type_, key, value in entries:
            if type_ == kTypeRangeDeletion:
                self._add_range_tombstone(seq, key, value)
                continue
            prev = table.get(key)
            if prev is not None:
                if retain_from is not None and prev[0] <= retain_from:
                    history.setdefault(key, []).append(prev)
                    nbytes += len(key) + ENTRY_OVERHEAD
                else:
                    # a retained version is still live (some snapshot reads
                    # it) — only non-retained supersessions are reported so
                    # the caller's dead-value accounting stays truthful
                    prevs.append(prev)
                nbytes -= len(key) + len(prev[2]) + ENTRY_OVERHEAD
            else:
                new_keys += 1
            table[key] = (seq, type_, value)
            nbytes += len(key) + len(value) + ENTRY_OVERHEAD
        if new_keys:
            self._version += 1
        self._bytes += nbytes
        if self.first_seq is None:
            self.first_seq = seq
        self.last_seq = max(self.last_seq, seq)
        return prevs

    def add_group_sharded(self, applies, pool, nshards: int,
                          retain_from: int | None = None) -> list:
        """Apply a whole commit group — ``applies`` is ``[(seq, entries),
        ...]`` in ascending seq order — sharded by key hash across ``pool``.

        Returns the combined superseded records (same contract as
        ``add_batch``). The version bump happens once, AFTER every shard has
        joined, preserving the lock-free reader protocol: a reader that
        sorted mid-apply publishes under a pre-bump tag and rebuilds.
        """
        buckets: list[list] = [[] for _ in range(nshards)]
        for seq, entries in applies:
            for entry in entries:
                if entry[0] == kTypeRangeDeletion:
                    # range tombstones span shards — the leader applies them
                    # directly (applies are in ascending seq order)
                    self._add_range_tombstone(seq, entry[1], entry[2])
                else:
                    buckets[hash(entry[1]) % nshards].append((seq, entry))
        futures = [
            pool.submit(self._apply_shard, b, retain_from) for b in buckets if b
        ]
        nbytes = 0
        new_keys = 0
        prevs: list = []
        for f in futures:
            b, n, p = f.result()
            nbytes += b
            new_keys += n
            prevs.extend(p)
        self._bytes += nbytes
        if new_keys:
            self._version += 1
        if applies:
            if self.first_seq is None:
                self.first_seq = applies[0][0]
            self.last_seq = max(self.last_seq, applies[-1][0])
        return prevs

    def _apply_shard(self, items, retain_from: int | None = None) -> tuple[int, int, list]:
        """One shard's slice of a group: ``[(seq, (type, key, value)), ...]``
        in seq order. Touches only this shard's keys; returns the byte
        delta, new-key count, and superseded records."""
        table = self._table
        history = self._history
        nbytes = 0
        new_keys = 0
        prevs = []
        for seq, (type_, key, value) in items:
            prev = table.get(key)
            if prev is not None:
                if retain_from is not None and prev[0] <= retain_from:
                    history.setdefault(key, []).append(prev)
                    nbytes += len(key) + ENTRY_OVERHEAD
                else:
                    prevs.append(prev)  # see add_batch: retained = still live
                nbytes -= len(key) + len(prev[2]) + ENTRY_OVERHEAD
            else:
                new_keys += 1
            table[key] = (seq, type_, value)
            nbytes += len(key) + len(value) + ENTRY_OVERHEAD
        return nbytes, new_keys, prevs

    def get(self, key: bytes):
        """Returns (found, type, value). found=False means fall through to
        older tables / SSTs; a found tombstone terminates the lookup.

        NOTE: does not consult range tombstones — the DB read path tracks
        the max covering tombstone seq across tables itself (a tombstone
        here may shadow a point hit in an older table)."""
        hit = self._table.get(key)
        if hit is None:
            return False, kTypeDeletion, b""
        seq, type_, value = hit
        return True, type_, value

    def get_at(self, key: bytes, read_seq: int):
        """Snapshot read: returns (found, seq, type, value) for the newest
        version of ``key`` with ``seq <= read_seq``."""
        hit = self._table.get(key)
        if hit is None:
            return False, 0, kTypeDeletion, b""
        if hit[0] <= read_seq:
            return True, hit[0], hit[1], hit[2]
        for rec in reversed(self._history.get(key, ())):
            if rec[0] <= read_seq:
                return True, rec[0], rec[1], rec[2]
        return False, 0, kTypeDeletion, b""

    def covering_tombstone_seq(self, key: bytes, read_seq: int = MAX_SEQ) -> int:
        """Max seq of a range tombstone covering ``key`` visible at
        ``read_seq`` (0 if none). The list is tiny per memtable, so a
        linear scan is fine."""
        best = 0
        for seq, start, end in self.range_tombstones:
            if seq <= read_seq and start <= key < end and seq > best:
                best = seq
        return best

    def _sorted(self) -> list[bytes]:
        while True:
            version = self._version
            cached = self._sorted_cache
            if cached is not None and cached[0] == version:
                return cached[1]
            try:
                keys = sorted(self._table)
            except RuntimeError:  # dict mutated mid-sort by a racing writer
                continue
            if self._version != version:
                continue  # key set changed while sorting — rebuild
            # a racing publish after this point carries its own (older or
            # equal) version tag, so readers can never see a fresh tag on a
            # stale list; tuple assignment is atomic under the GIL.
            self._sorted_cache = (version, keys)
            return keys

    def sorted_items(self):
        """Yield (key, seq, type, value) in (user-key asc, seq desc) order —
        every retained version, newest first per key (single-version when no
        snapshot history exists, identical to the pre-MVCC behaviour)."""
        table = self._table
        history = self._history
        for key in self._sorted():
            seq, type_, value = table[key]
            yield key, seq, type_, value
            if history:
                for hseq, htype, hvalue in reversed(history.get(key, ())):
                    yield key, hseq, htype, hvalue

    def range_items(self, start: bytes, end: bytes | None):
        """Newest version per key in [start, end) — the latest-read scan
        view (snapshot readers use :meth:`iter_versions_from`)."""
        keys = self._sorted()
        table = self._table
        for i in range(bisect_left(keys, start), len(keys)):
            key = keys[i]
            if end is not None and key >= end:
                break
            seq, type_, value = table[key]
            yield key, seq, type_, value

    def iter_versions_from(self, start: bytes):
        """Yield (key, seq, type, value) for EVERY retained version from
        ``start`` on, newest first per key — the cursor's memtable source."""
        keys = self._sorted()
        table = self._table
        history = self._history
        for i in range(bisect_left(keys, start), len(keys)):
            key = keys[i]
            seq, type_, value = table[key]
            yield key, seq, type_, value
            for hseq, htype, hvalue in reversed(history.get(key, ())):
                yield key, hseq, htype, hvalue

    def largest_key_below(self, bound: bytes | None) -> bytes | None:
        """Largest user key strictly below ``bound`` (reverse-cursor step).
        ``None`` bound means unbounded: the largest key overall."""
        keys = self._sorted()
        if bound is None:
            return keys[-1] if keys else None
        i = bisect_left(keys, bound)
        return keys[i - 1] if i else None
