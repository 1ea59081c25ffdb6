"""BVLSM DB facade — put/get/delete/scan/write(WriteBatch) + recovery.

One engine, three systems (see :mod:`.config`): ``separation_mode`` selects
where key–value separation happens. The BVLSM path (§III-B of the paper):

WAL-enabled::

    value --fsync--> BValue file            (multi-queue, parallel)
    Key-ValueOffset --append/fsync--> WAL   (tiny record)
    Key-ValueOffset --> MemTable --> SSTable

WAL-disabled / async::

    value --> BVCache (pinned) --> background batch write --> BValue file
    Key-ValueOffset --> MemTable (--> buffered WAL in async mode)

Write pipeline (pipelined group commit)
---------------------------------------

Commits run through a RocksDB-style leader/follower writer group
(JoinBatchGroup) with a two-stage pipelined handoff. Every commit — a
:class:`~.writebatch.WriteBatch` or the single-entry batches behind
``put``/``delete`` — performs WAL-time value separation *outside* the DB
mutex (big values fan out across the BValue queues via ``put_many``, one
fsync per queue per batch), then enqueues on the writer queue. Commit runs
in three stages:

1. **drain** (mutex held): the queue head becomes the leader, waits for a
   pipeline slot (bounded by ``wal_pipeline_depth``, and gated by
   ``wal_pipeline_min_fill`` so overlapped groups are worth their
   overhead), merges the head run of the queue into one group up to the
   adaptive byte cap / hard entry caps, assigns sequence numbers, and
   reserves a WAL write-order ticket.
2. **persist** (no mutex): frame encoding is lock-free; the file write
   happens strictly in ticket (= sequence) order while the group still
   heads the queue; then the group POPS itself — the **handoff** — and
   fsyncs outside the ordering barrier, so the next leader drains the
   now-refilled queue and encodes + writes its group while this fsync is
   in flight. A group whose ticket a later-started fsync already covered
   skips its own (at most one fsync runs at a time; piled-up groups ride
   the next one).
3. **publish** (mutex held, sequence order): groups apply to the MemTable
   oldest-first — in bulk (``add_batch``), or hash-sharded across a worker
   pool when the group is huge — then wake their followers. A group is
   never visible unless every earlier-sequence group is durable.

**Adaptive group sizing** replaces the fixed byte cap: a latency-target
controller grows/shrinks the effective cap from the persist-latency EWMA
(see ``DBConfig.wal_group_target_latency_s``).

``wal_pipelined_commit=False`` restores the single-outstanding-group
commit (pipeline depth 1); ``wal_group_commit=False`` restores the
pre-pipeline one-record-one-fsync path (the benchmark baseline).
``EngineStats`` exposes the group-size and pipeline-depth histograms,
``fsyncs_per_write``, and the adaptive-cap gauges so all three
optimizations are observable.

Background work (flush, compaction, GC) runs on the prioritized job
scheduler (:mod:`.scheduler`), with writer throttling handled by the
continuous delayed-write controller in :meth:`DB._maybe_stall_locked` and
background output bytes paced by the shared token bucket
(:mod:`.ratelimiter`). See ``docs/ARCHITECTURE.md`` §"Background jobs".
"""
from __future__ import annotations

import bisect
import os
import threading
import time
import warnings
from collections import deque

from repro_torch import _msgpack as msgpack

from .blockcache import BlockCache
from .bvalue import BValueManager
from .bvcache import BVCache
from .gc import DeadValueTracker
from .compaction import _merge_iters
from .config import DBConfig
from .env import DEFAULT_ENV
from .errors import CorruptionError, ErrorHandler, SnapshotUnstableError
from .manifest import MANIFEST_NAME, VersionSet
from .memtable import MemTable
from .ratelimiter import PRI_FG, PRI_LOW, RateLimiter
from .scheduler import BackgroundCoordinator, WriteController
from .record import (
    MAX_SEQ,
    ValueOffset,
    decode_entries,
    encode_entries,
    frame_record,
    iter_framed_records_ex,
    kTypeDeletion,
    kTypeRangeDeletion,
    kTypeValue,
    kTypeValuePtr,
)
from .sstable import table_path
from .stats import EngineStats
from .wal import WALWriter
from .writebatch import WriteBatch


class _Writer:
    """One queued commit: a batch's memtable-ready entries + ack state.

    ``user_bytes`` is the pre-separation payload (stats); ``entry_bytes`` is
    the post-separation size — what actually lands in the WAL record — and
    is what group formation charges against ``wal_group_max_bytes``, so a
    batch of separated big values (tiny ValueOffset entries) doesn't
    spuriously cap the group.

    ``precondition`` (RocksDB WriteCallback analogue) makes the commit
    conditional: the group leader evaluates it under the DB mutex at
    seq-assignment time and, if it fails — or an earlier batch in the same
    group writes one of this batch's keys — the batch is emptied and acked
    with ``skipped=True`` instead of being written. GC value rewrites use
    this so a concurrent foreground overwrite can never be shadowed by a
    resurrected stale value."""

    __slots__ = (
        "entries", "count", "user_bytes", "entry_bytes", "seq", "done", "error",
        "precondition", "skipped",
    )

    def __init__(
        self,
        entries: list[tuple[int, bytes, bytes]],
        user_bytes: int,
        precondition=None,
    ):
        self.entries = entries
        self.count = len(entries)
        self.user_bytes = user_bytes
        self.entry_bytes = sum(len(k) + len(v) for _, k, v in entries)
        self.seq = 0
        self.done = False
        self.error: BaseException | None = None
        self.precondition = precondition
        self.skipped = False


class _Group:
    """One in-flight commit group: the writers drained by a leader, plus
    the WAL write-order ticket that pins its position in the pipeline."""

    __slots__ = ("writers", "ticket")

    def __init__(self, writers: list[_Writer]):
        self.writers = writers
        self.ticket: int | None = None


class Snapshot:
    """A pinned read point (RocksDB ``GetSnapshot`` analogue).

    Reads through it (``db.get(key, snapshot=snap)``, ``db.iterator(snap)``)
    see exactly the state visible at creation: writes published later are
    invisible and deletes published later do not hide anything. While a
    snapshot is live the engine retains what it can still see — memtables
    keep superseded versions, compaction keeps shadowed versions and range
    tombstones alive (stripe dedup in :mod:`.compaction`), and BValue GC
    defers file unlinks. Always :meth:`release` (or use as a context
    manager): a leaked snapshot widens retention forever, and
    ``DBConfig.max_snapshots`` hard-caps the live count for that reason."""

    __slots__ = ("seq", "_db", "_released")

    def __init__(self, db: "DB", seq: int):
        self._db = db
        self.seq = seq
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._db._release_snapshot_seq(self.seq)

    def __enter__(self) -> "Snapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "released" if self._released else "live"
        return f"<Snapshot seq={self.seq} {state}>"


class Cursor:
    """Stable bidirectional iterator over one MVCC read point.

    The constructor captures (memtables, version, read_seq) under the DB
    mutex, registers the read point as a snapshot, and pins the version
    (``VersionSet.pin``), so concurrent flushes/compactions/GC cannot close
    or unlink anything the walk needs: dropped readers are parked and input
    unlinks are deferred until the cursor closes. Forward iteration is the
    same lazy heap merge as ``scan`` — a sorted level opens a file only
    when the merge reaches it — plus MVCC filtering: versions newer than
    the read point are skipped, the first visible version per user key
    decides it, and point-/range-deleted keys are elided.

    Range tombstones vs laziness: a sorted-level file's tombstone can span
    keys *below* its first point key — keys served by other sources before
    the lazy concat would ever open that file. Each sorted level therefore
    keeps a discovery pointer that advances whenever the merge cursor
    reaches a file's (tombstone-extended) smallest key, registering that
    file's tombstones before any key they could cover is emitted. A short
    scan still opens O(levels) files: the pointer only opens files whose
    range the cursor actually enters.

    ``prev()`` steps backward without materialized reverse iterators: take
    the max over all sources of ``largest_key_below(bound)``, resolve that
    candidate with a point lookup on the pinned state, and keep walking
    down while candidates turn out deleted at the read point."""

    __slots__ = (
        "_db", "_snap", "_own_snap", "read_seq", "_mems", "_version",
        "_pinned", "_tombs", "_tomb_files", "_lvl_files", "_lvl_ptr",
        "_merged", "_skip_key", "key", "value", "valid", "_closed",
    )

    def __init__(self, db: "DB", snapshot: Snapshot | None = None):
        self._db = db
        self._own_snap = snapshot is None
        self._snap = db.snapshot() if snapshot is None else snapshot
        self.read_seq = self._snap.seq
        with db.mutex:
            self._mems = [db.mem, *reversed(db.immutables)]
            # atomic capture+pin: a plain ``current`` read here could race
            # a compaction's edit + input unlink (versions have their own
            # lock — the DB mutex does not exclude background edits)
            self._version = db.versions.pin_current()
        self._pinned = True
        # range tombstones discovered from table files so far (pre-filtered
        # to seq <= read_seq); memtable tombstones are consulted live.
        self._tombs: list[tuple[int, bytes, bytes]] = []
        self._tomb_files: set[int] = set()
        # per-sorted-level discovery pointers (see class docstring)
        self._lvl_files = [
            self._version.levels[lvl]
            for lvl in range(1, len(self._version.levels))
        ]
        self._lvl_ptr = [0] * len(self._lvl_files)
        self._merged = None
        self._skip_key: bytes | None = None
        self.key: bytes | None = None
        self.value: bytes | None = None
        self.valid = False
        self._closed = False

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._merged = None
        self.valid = False
        if self._pinned:
            self._pinned = False
            self._db.versions.unpin()
        if self._own_snap:
            self._snap.release()

    def __enter__(self) -> "Cursor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- range-tombstone discovery --------------------------------------
    def _register_file_tombs(self, fmeta) -> None:
        if fmeta.file_no in self._tomb_files:
            return
        self._tomb_files.add(fmeta.file_no)
        for t in self._db.versions.reader(fmeta.file_no).range_tombstones:
            if t[0] <= self.read_seq:
                self._tombs.append(t)

    def _advance_tomb_ptrs(self, key: bytes) -> None:
        # register every sorted-level file whose (tombstone-extended) range
        # has started by ``key`` — before the merge can emit a covered key
        for li, files in enumerate(self._lvl_files):
            p = self._lvl_ptr[li]
            while p < len(files) and files[p].smallest <= key:
                self._register_file_tombs(files[p])
                p += 1
            self._lvl_ptr[li] = p

    def _tomb_seq(self, key: bytes) -> int:
        best = 0
        for m in self._mems:
            ts = m.covering_tombstone_seq(key, self.read_seq)
            if ts > best:
                best = ts
        for seq, start, end in self._tombs:
            if start <= key < end and seq > best:
                best = seq
        return best

    # -- forward iteration ----------------------------------------------
    def seek(self, target: bytes) -> bool:
        """Position on the first visible key >= ``target``; returns
        ``valid``."""
        self._build_merged(target)
        self._skip_key = None
        return self._advance()

    def seek_to_first(self) -> bool:
        return self.seek(b"")

    def _build_merged(self, start: bytes) -> None:
        db = self._db
        iters = [m.iter_versions_from(start) for m in self._mems]
        for f in self._version.levels[0]:
            if f.largest >= start:
                self._register_file_tombs(f)
                iters.append(db.versions.reader(f.file_no).iter_from(start))
        for li, files in enumerate(self._lvl_files):
            # reset the discovery pointer: files entirely below ``start``
            # are irrelevant (a tombstone's end bounds the file's largest)
            lo, hi = 0, len(files)
            while lo < hi:
                mid = (lo + hi) // 2
                if files[mid].largest < start:
                    lo = mid + 1
                else:
                    hi = mid
            self._lvl_ptr[li] = lo
            if lo < len(files):
                iters.append(self._concat(files[lo:], start))
        self._merged = _merge_iters(iters)

    def _concat(self, files, start: bytes):
        first = True
        for f in files:
            self._register_file_tombs(f)
            it = self._db.versions.reader(f.file_no).iter_from(
                start if first else f.smallest
            )
            first = False
            yield from it

    def next(self) -> bool:
        """Advance to the next visible key; returns ``valid``."""
        if self._merged is None:
            # forward state was invalidated by a prev() — rebuild past key
            if not self.valid:
                return False
            self._build_merged(self.key)
            self._skip_key = self.key
        return self._advance()

    def _advance(self) -> bool:
        db = self._db
        for key, seq, type_, value in self._merged:
            if seq > self.read_seq:
                continue  # newer than the read point
            if key == self._skip_key:
                continue  # this user key is already decided
            self._skip_key = key  # first visible version decides the key
            self._advance_tomb_ptrs(key)
            if type_ == kTypeDeletion or seq < self._tomb_seq(key):
                continue  # point- or range-deleted at the read point
            resolved = db._resolve(key, type_, value)
            if resolved is None:
                continue
            self.key = key
            self.value = resolved
            self.valid = True
            return True
        self.key = None
        self.value = None
        self.valid = False
        return False

    # -- reverse iteration ----------------------------------------------
    def prev(self) -> bool:
        """Step to the largest visible key strictly below the current one
        (below infinity when invalid: an invalid cursor's ``prev`` is a
        seek-to-last). Returns ``valid``."""
        bound = self.key if self.valid else None
        self._merged = None  # forward state is stale after a reverse step
        while True:
            cand = self._largest_below(bound)
            if cand is None:
                self.key = None
                self.value = None
                self.valid = False
                return False
            resolved = self._db._lookup_at(
                cand, self.read_seq, self._mems, self._version
            )
            if resolved is not None:
                self.key = cand
                self.value = resolved
                self.valid = True
                return True
            bound = cand  # deleted at the read point — keep walking down

    def _largest_below(self, bound: bytes | None) -> bytes | None:
        db = self._db
        best = None
        for m in self._mems:
            k = m.largest_key_below(bound)
            if k is not None and (best is None or k > best):
                best = k
        for f in self._version.levels[0]:
            k = db.versions.reader(f.file_no).largest_key_below(bound)
            if k is not None and (best is None or k > best):
                best = k
        for files in self._lvl_files:
            # rightmost file that could hold point keys < bound; walk left
            # past tombstone-only tails (extended bounds may hold no point
            # key below the bound at all)
            i = len(files) - 1
            if bound is not None:
                lo, hi = 0, len(files)
                while lo < hi:
                    mid = (lo + hi) // 2
                    if files[mid].smallest < bound:
                        lo = mid + 1
                    else:
                        hi = mid
                i = lo - 1
            while i >= 0:
                k = db.versions.reader(files[i].file_no).largest_key_below(bound)
                if k is not None:
                    if best is None or k > best:
                        best = k
                    break
                i -= 1
        return best


class DB:
    def __init__(self, path: str, cfg: DBConfig | None = None, role: str = "primary"):
        self.path = path
        self.cfg = cfg or DBConfig()
        if self.cfg.replica_of is not None:
            role = "replica"
        if role not in ("primary", "replica"):
            raise ValueError(f"DB role must be 'primary' or 'replica', got {role!r}")
        # replicas reject user writes (check_writable) and disable GC; the
        # replication stream applies through _follower until promote()
        self._role = role
        self._repl = None  # primary-side Replicator once a follower attaches
        self._follower = None  # replica-side Follower once attached
        # pluggable filesystem: every open/read/write/fsync/rename/unlink in
        # the engine routes through this (tests inject FaultInjectionEnv)
        self.env = self.cfg.env or DEFAULT_ENV
        self.env.makedirs(path)
        self.stats = EngineStats()
        self.errors = ErrorHandler(self)
        self.mutex = threading.RLock()
        self.writer_cv = threading.Condition(self.mutex)
        # group-commit writer queue: head = leader, rest = followers
        self._writers: deque[_Writer] = deque()
        self._group_cv = threading.Condition(self.mutex)
        # pipelined commit: groups in flight, oldest first. Publication is
        # strictly in this order (no commit-order hole).
        self._pending: deque[_Group] = deque()
        # live snapshot registry: read-point seq -> refcount (several
        # snapshots can share one seq). Guarded by the mutex; compaction,
        # GC and the memtable retain path all consult it.
        self._snapshots: dict[int, int] = {}
        self._publish_cv = threading.Condition(self.mutex)  # publish-order barrier
        self._pipeline_cv = threading.Condition(self.mutex)  # slot/rotation waits
        self._rotation_pending = False  # rotate once the pipeline drains
        # adaptive group sizing (latency-target controller)
        self._group_cap_bytes = min(
            max(self.cfg.wal_group_init_bytes, self.cfg.wal_group_min_bytes),
            self.cfg.wal_group_max_bytes,
        )
        self._persist_ewma: float | None = None
        self._mt_pool = None  # lazy ThreadPoolExecutor for sharded apply

        # shared decoded-block cache (read path): one 2Q/LRU for every
        # SSTable reader — foreground gets, scans, and (read-through only,
        # by default) compaction. None when disabled so readers skip lookups.
        self.block_cache = (
            BlockCache(
                self.cfg.block_cache_bytes,
                self.cfg.block_cache_shards,
                policy=self.cfg.block_cache_policy,
                a1_fraction=self.cfg.block_cache_a1_fraction,
            )
            if self.cfg.block_cache_bytes > 0
            else None
        )
        self.stats.register_block_cache(self.block_cache)
        self.versions = VersionSet(
            path,
            self.cfg.num_levels,
            self.block_cache,
            env=self.env,
            paranoid=self.cfg.paranoid_checks,
        )
        self.versions.open()
        self._seq = self.versions.last_seq

        # shared token bucket for every accounted byte: background writes
        # (compaction output, flush tables, GC rewrites) block or defer on
        # it, and — under the unified budget — foreground BValue dispatches
        # charge it at PRI_FG, shrinking the background refill. rate 0 =
        # unlimited, zero overhead.
        self.rate_limiter = RateLimiter(
            self.cfg.bg_io_bytes_per_sec,
            self.cfg.bg_io_refill_period_s,
            stats=self.stats,
            bg_min_fraction=self.cfg.bg_io_min_fraction,
        )
        # continuous delayed-write controller state (leader-only, under mutex).
        # _delay_debt accumulates every published group's post-separation
        # bytes; the next leader entering the delay region pays for ALL of
        # it, so the aggregate ingest tracks the controller rate even though
        # followers never lead (charging only the leader's own batch would
        # let a group commit ~group-size times the target rate).
        self._write_controller = WriteController(self.cfg)
        self._delay_debt = 0
        # GC rewrites re-enter the foreground write path from a background
        # thread; this marker exempts them from the hard stall (they would
        # otherwise deadlock a single-thread low pool waiting on themselves)
        self._bg_local = threading.local()

        self.bvcache = BVCache(self.cfg.bvcache_bytes, self.cfg.bvcache_policy)
        self.dead_tracker = DeadValueTracker()
        self.bvalue = BValueManager(
            os.path.join(path, "bvalue"),
            num_queues=self.cfg.num_bvalue_queues,
            async_writes=True,
            dispatch=self.cfg.bvalue_dispatch,
            page_size=self.cfg.bvalue_page_size,
            batch_bytes=self.cfg.bvalue_batch_bytes,
            max_file_bytes=self.cfg.bvalue_max_file_bytes,
            gather_window_s=self.cfg.bvalue_gather_window_s,
            stats=self.stats,
            on_persisted=self.bvcache.unpin,
            on_persisted_many=self.bvcache.unpin_many,
            next_file_id=self.versions.bvalue_next_file_id,
            # unified device model: value-log dispatches charge the shared
            # bucket — foreground puts at PRI_FG (never blocked), GC
            # rewrites inherit PRI_LOW from their background initiator
            limiter=self.rate_limiter if self.cfg.unified_io_budget else None,
            io_priority=lambda: (
                PRI_LOW if getattr(self._bg_local, "exempt", False) else PRI_FG
            ),
            env=self.env,
        )

        self.mem = MemTable()
        self.immutables: list[MemTable] = []
        self._wal_no = 0
        self.wal: WALWriter | None = None
        self._recover()
        self._open_wal()

        self._closed = False
        self.bg = BackgroundCoordinator(self)
        self.bg.maybe_schedule()  # recovery may have left flushable state

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------
    def _wal_path(self, no: int) -> str:
        return os.path.join(self.path, f"wal_{no:06d}.log")

    def _release_wal(self, path: str, last_seq: int) -> None:
        """A flushed memtable's log is redundant for recovery — but a
        lagging follower may still need it for catch-up, so with followers
        attached the segment is retained until every ack passes its last
        sequence (the Replicator unlinks it then)."""
        repl = self._repl
        if repl is not None and repl.active and repl.should_retain(last_seq):
            repl.retain_wal(path, last_seq)
            return
        try:
            self.env.unlink(path)
        except OSError:
            pass

    def _recover(self) -> None:
        logs = sorted(
            f
            for f in self.env.listdir(self.path)
            if f.startswith("wal_") and f.endswith(".log")
        )
        replayed: list[str] = []
        for name in logs:
            no = int(name[4:-4])
            self._wal_no = max(self._wal_no, no + 1)
            path = os.path.join(self.path, name)
            with self.env.open(path, "rb") as f:
                buf = f.read()
            end = 0
            for payload, end in iter_framed_records_ex(buf):
                seq, entries = decode_entries(payload)
                self.mem.add_batch(seq, entries)
                self._seq = max(self._seq, seq)
            if end < len(buf):
                # torn tail (partial frame or CRC mismatch from a crash
                # mid-append): truncate to the last whole record so nothing
                # can ever parse past the damage
                self.stats.add("wal_truncated_bytes", len(buf) - end)
                with self.env.open(path, "r+b") as f:
                    f.truncate(end)
            if end == 0:
                try:
                    self.env.unlink(path)  # nothing recoverable in it
                except OSError:
                    pass
            else:
                replayed.append(path)
        self._drop_dangling_pointers()
        if len(self.mem) or self.mem.range_tombstones:
            # The recovered entries exist ONLY in memory + these logs, so
            # the logs must outlive them: seal the memtable as an immutable
            # that CARRIES its source logs, and let flush_memtable delete
            # them after the L0 manifest commit. (The old code unlinked the
            # logs right here — a crash before the first flush then lost
            # every previously-acked write.)
            self.mem.recovery_logs = replayed
            self.immutables.append(self.mem)
            self.mem = MemTable()
        else:
            for p in replayed:
                try:
                    self.env.unlink(p)
                except OSError:
                    pass

    def _drop_dangling_pointers(self) -> None:
        """Close the async-WAL separation hole at recovery time.

        Under a buffered WAL there is no ordering barrier between a
        separated value's fsync and its Key-ValueOffset record reaching the
        disk, so a crash can leave a durable pointer to value bytes that
        never made it. Probe every replayed pointer and drop the records
        whose bytes are gone: the key falls back to its previous durable
        version — legal, since an async ack never promised durability —
        instead of every future ``get`` failing on a short read forever.
        (Sync WAL fsyncs the value before appending the pointer, so there
        every probe succeeds by construction.)"""
        dangling = set()
        for key, (_seq, type_, value) in self.mem._table.items():
            if type_ != kTypeValuePtr:
                continue
            try:
                # verify=True: existence is not enough — a dropped write
                # batch can leave a zero-filled hole inside a file a LATER
                # batch extended and fsynced, so the probe must prove the
                # bytes themselves (CRC), not just that the read succeeds
                self.bvalue.get(ValueOffset.decode(value), verify=True)
            except Exception:
                dangling.add(key)
        if not dangling:
            return
        self.stats.add("recovery_dangling_ptrs", len(dangling))
        mem = MemTable()
        for key, (seq, type_, value) in self.mem._table.items():
            if key not in dangling:
                mem.add(seq, type_, key, value)
        # range tombstones ride the same replayed WAL records and must
        # survive the rebuild, or a crash after an acked delete_range
        # silently resurrects every covered key
        for seq, start, end in self.mem.range_tombstones:
            mem._add_range_tombstone(seq, start, end)
        self.mem = mem

    def _open_wal(self) -> None:
        if self.cfg.wal_mode == "off":
            self.wal = None
            return
        self.wal = WALWriter(
            self._wal_path(self._wal_no),
            mode=self.cfg.wal_mode,
            flush_interval_s=self.cfg.wal_flush_interval_s,
            flush_bytes=self.cfg.wal_flush_bytes,
            stats=self.stats,
            env=self.env,
        )
        self.mem.wal_no = self._wal_no
        self._wal_no += 1

    @classmethod
    def open(cls, path: str, config: DBConfig | None = None, **kw) -> "DB":
        """Canonical constructor: open (creating if absent) the store at
        ``path``. Equivalent to ``DB(path, config)`` — the bare constructor
        keeps working — but ``open()`` is the one documented spelling,
        mirrored by ``ShardedDB.open(path, shards=N, config=None)``."""
        return cls(path, config, **kw)

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        """Store ``key -> value``. Values >= ``value_threshold`` (in ``wal``
        separation mode) are streamed to the BValue store first; only a
        ValueOffset rides the WAL/MemTable. Durable on return under sync
        WAL. Thread-safe: concurrent puts merge into commit groups."""
        self._commit([(kTypeValue, key, value)])

    def delete(self, key: bytes) -> None:
        """Write a tombstone for ``key`` (the value, if separated, is
        reclaimed later by ``gc_collect``). Same durability as ``put``."""
        self._commit([(kTypeDeletion, key, b"")])

    def delete_range(self, start: bytes, end: bytes) -> None:
        """Delete every key in ``[start, end)`` with ONE range tombstone —
        one WAL record, one memtable entry: O(1) in the number of covered
        keys. Covered versions become invisible to reads above the
        tombstone's sequence (older snapshots still see them); compaction
        physically drops them — and reports their separated values dead —
        as it encounters them. Same durability as ``put``. Requires
        SSTable format v3 (the tombstone side block)."""
        self._commit([(kTypeRangeDeletion, start, end)])

    def write(self, batch: WriteBatch) -> None:
        """Commit a WriteBatch atomically: all ops share one sequence
        number and one CRC-framed WAL record, so crash replay applies the
        whole batch or none of it. An empty batch is a no-op."""
        if len(batch):
            self._commit(list(batch._ops))

    def _commit(
        self, ops: list[tuple[int, bytes, bytes]], precondition=None
    ) -> bool:
        """Commit one batch; returns False iff a ``precondition`` made the
        leader skip it (see :class:`_Writer`)."""
        cfg = self.cfg
        # fail fast while read-only: don't separate values (phase 1 would
        # write them to the BValue log) for a commit that cannot proceed
        self.errors.check_writable()
        # --- Phase 1: WAL-time separation happens OUTSIDE the DB mutex and
        # outside the writer group: parallel callers stream values onto
        # different queues concurrently; a batch's big values fan out across
        # ALL queues in one put_many call before the leader commits. ---
        user_bytes = 0
        big_idx: list[int] = []
        for i, (type_, key, value) in enumerate(ops):
            if type_ == kTypeRangeDeletion:
                # gate at write time, not flush time: a v<3 table cannot
                # carry the tombstone side block, and failing the flush
                # later would lose an already-acked write
                if cfg.sstable_format_version < 3:
                    raise ValueError(
                        "delete_range requires sstable_format_version >= 3"
                    )
                if not key < value:  # key=start, value=end (exclusive)
                    raise ValueError("delete_range: start must sort before end")
            user_bytes += len(key) + len(value)
            if (
                type_ == kTypeValue
                and cfg.separation_mode == "wal"
                and len(value) >= cfg.value_threshold
            ):
                big_idx.append(i)
        if big_idx:
            sync_value = cfg.wal_mode == "sync"
            on_reserved = None
            if not sync_value:
                # async path: the pinned insert must land BEFORE the value is
                # handed to a writer thread, or the persist-completion unpin
                # could fire first and the entry would stay pinned forever.
                def on_reserved(key, voff, value):
                    self.bvcache.insert(key, voff, value, pinned=True)

            voffs = self.bvalue.put_many(
                [(ops[i][1], ops[i][2]) for i in big_idx],
                sync=sync_value,
                on_reserved=on_reserved,
            )
            for i, voff in zip(big_idx, voffs):
                _, key, value = ops[i]
                if sync_value:
                    self.bvcache.insert(key, voff, value, pinned=False)
                self.dead_tracker.on_write(voff)
                ops[i] = (kTypeValuePtr, key, voff.encode())

        # --- Phase 2: join the write group. ---
        w = _Writer(ops, user_bytes, precondition)
        with self.mutex:
            self._writers.append(w)
            if self._pending:
                self._pipeline_cv.notify()  # a waiting leader may fill up now
            # check done FIRST, and guard the head peek: once a leader
            # drains its group off the queue, w may be in a pending group
            # (not done yet, no longer queued) and the deque may be empty.
            while not w.done and not (self._writers and self._writers[0] is w):
                self._group_cv.wait()
            if not w.done:
                self._lead_group_locked(w)
        if w.error is not None:
            raise w.error
        return not w.skipped

    def _lead_group_locked(self, leader: _Writer) -> None:
        """Called with the mutex held by the writer at the queue head: run
        the three commit stages (drain / persist / publish) for one group.

        The mutex is released during persist; by then the group has been
        popped off the writer queue and parked in ``self._pending``, so the
        next queue head immediately becomes a leader and overlaps its
        encode+write with this group's fsync.
        """
        cfg = self.cfg
        try:
            self.errors.check_writable()
            self._maybe_stall_locked()
        except BaseException as e:  # fail fast: only the leader is charged
            popped = self._writers.popleft()
            assert popped is leader, "writer queue out of order"
            leader.error = e
            leader.done = True
            self._group_cv.notify_all()
            return

        # --- stage 1: drain. Wait for a pipeline slot (we are still the
        # queue head, so nobody else can form a group while we wait), then
        # merge the head run of the queue — late arrivals during the stall
        # and the slot wait ride along.
        depth_cap = (
            cfg.wal_pipeline_depth
            if (cfg.wal_pipelined_commit and cfg.wal_group_commit)
            else 1
        )
        while (
            self._rotation_pending
            or len(self._pending) >= depth_cap
            # min-fill gate: overlapping an in-flight group only pays once
            # enough writers are queued to form a real group; otherwise
            # wait — for more arrivals (enqueues notify) or the drain.
            or (self._pending and len(self._writers) < cfg.wal_pipeline_min_fill)
        ):
            self._pipeline_cv.wait()
        group = [leader]
        if cfg.wal_group_commit:
            cap_bytes = (
                self._group_cap_bytes if cfg.wal_group_adaptive else cfg.wal_group_max_bytes
            )
            n_entries, n_bytes = leader.count, leader.entry_bytes
            for w in list(self._writers)[1:]:
                if (
                    len(group) >= cfg.wal_group_max_batches
                    or n_entries + w.count > cfg.wal_group_max_entries
                    or n_bytes + w.entry_bytes > cap_bytes
                ):
                    break
                group.append(w)
                n_entries += w.count
                n_bytes += w.entry_bytes
        if any(w.precondition is not None for w in group):
            self._check_preconditions_locked(group)
        for w in group:
            self._seq += 1
            w.seq = self._seq
        grp = _Group(group)
        wal = self.wal
        if wal is not None:
            # ticket taken under the mutex right after seq assignment, so
            # WAL file order always equals sequence order
            grp.ticket = wal.reserve()
        self._pending.append(grp)
        self.stats.record_pipeline_depth(len(self._pending))

        # --- stage 2: persist. The group STAYS at the queue head through
        # the (fast) file write — late writers keep piling up behind it —
        # and hands the queue off right before the (slow) fsync: the next
        # leader then drains a well-filled queue and encodes + writes its
        # group while our fsync is in flight. Both halves run OUTSIDE the
        # mutex (entries are immutable once queued; the BValue queues keep
        # streaming).
        err: BaseException | None = None
        persist_s = 0.0
        payloads: list | None = None  # kept for the replication ship below
        t0 = time.monotonic()
        if wal is not None:
            self.mutex.release()
            try:
                try:
                    payloads = [encode_entries(w.seq, w.entries) for w in group]
                except BaseException:
                    # the reserved ticket MUST be consumed or every later
                    # group deadlocks at the write barrier
                    wal.abort_ticket(grp.ticket)
                    raise
                wal.write_many(payloads, grp.ticket)
            except BaseException as e:
                err = e
            finally:
                self.mutex.acquire()
        # handoff point: pop the group; the next queue head becomes leader
        for w in group:
            popped = self._writers.popleft()
            assert popped is w, "writer queue out of order"
        self._group_cv.notify_all()
        if wal is not None and err is None:
            self.mutex.release()
            try:
                wal.sync_ticket(grp.ticket)
                persist_s = time.monotonic() - t0
            except BaseException as e:
                err = e
            finally:
                self.mutex.acquire()
            if err is None and cfg.wal_group_adaptive and cfg.wal_group_commit:
                self._adapt_group_cap_locked(persist_s)

        # --- stage 3: publish in sequence order. Earlier groups are
        # durable AND visible before we are; our followers wake only after
        # both hold for us too.
        while self._pending[0] is not grp:
            self._publish_cv.wait()
        if err is None:
            try:
                total_entries = sum(w.count for w in group)
                total_bytes = sum(w.user_bytes for w in group)
                # post-separation bytes: what actually lands in the LSM and
                # drives compaction debt — the delayed-write controller's
                # currency (paid by the next leader entering the region)
                self._delay_debt += sum(w.entry_bytes for w in group)
                prevs = self._apply_group_locked(group, total_entries)
                had_ptr_dead = False
                for prev in prevs:
                    if prev[1] == kTypeValuePtr:
                        self.dead_tracker.on_dead(ValueOffset.decode(prev[2]))
                        had_ptr_dead = True
                if had_ptr_dead:
                    # memtable overwrites can push a sealed BValue file past
                    # the GC trigger with no flush/compaction edge in sight
                    # — this is the one dead-ratio edge those hooks miss
                    self.bg._maybe_schedule_gc()
                self.stats.mark_user_writes(total_entries, total_bytes)
                self.stats.record_group(len(group), total_entries)
            except BaseException as e:  # must still ack the group below, or
                err = e  # every current and future writer deadlocks
        if err is None and self._repl is not None:
            # ship the committed group, publish-ordered (we hold the mutex;
            # earlier groups shipped before us). Durable-first in sync mode
            # (sync_ticket completed above), post-ack in async. Skipped
            # writers ship as empty payloads so follower seqs stay
            # contiguous. Never fails the client write: a dead transport
            # just leaves the follower to catch up from the WAL.
            try:
                self._repl.on_group(
                    [
                        (
                            w.seq,
                            payloads[i]
                            if payloads is not None
                            else encode_entries(w.seq, w.entries),
                        )
                        for i, w in enumerate(group)
                    ]
                )
            except Exception:
                self.stats.add("repl_ship_errors")
        popped_grp = self._pending.popleft()
        assert popped_grp is grp, "pipeline out of order"
        for w in group:
            w.error = err
            w.done = True
        self._group_cv.notify_all()
        self._publish_cv.notify_all()
        self._pipeline_cv.notify_all()
        # rotation waits for the pipeline to drain: every pending group's
        # WAL record lives in the CURRENT file, and rotating under them
        # would let their entries land in a memtable whose WAL is gone
        # after the old file is dropped at flush.
        if err is None and self.mem.approximate_size >= cfg.memtable_size:
            self._rotation_pending = True
        if self._rotation_pending and not self._pending:
            self._rotation_pending = False
            self._rotate_memtable_locked()
            self._pipeline_cv.notify_all()

    def _check_preconditions_locked(self, group: list[_Writer]) -> None:
        """Evaluate conditional batches (RocksDB WriteCallback analogue)
        under the mutex, at seq-assignment time: any published state is
        visible to the check, any later write gets a higher sequence and
        legitimately supersedes. Two windows the state check can't see are
        closed by key-collision scans: earlier batches in this very group,
        and earlier *pipelined groups* that hold lower sequence numbers
        but have not published to the memtable yet (``self._pending`` is
        stable under the mutex; a group is either pending — caught here —
        or applied — caught by the state check — never neither). A failed
        batch is emptied and acked as skipped; any value it already
        separated is reported dead."""
        seen_keys: set[bytes] = {
            k
            for grp in self._pending
            for w_ in grp.writers
            for _t, k, _v in w_.entries
        }
        for w in group:
            if w.precondition is not None:
                try:
                    ok = w.precondition() and not any(
                        k in seen_keys for _t, k, _v in w.entries
                    )
                except BaseException:
                    ok = False  # fail safe: skip, never resurrect
                if not ok:
                    for type_, _k, v in w.entries:
                        if type_ == kTypeValuePtr:
                            # the separated copy phase 1 wrote is now
                            # unreferenced — let GC reclaim it
                            self.dead_tracker.on_dead(ValueOffset.decode(v))
                    w.entries = []
                    w.count = 0
                    w.entry_bytes = 0
                    w.skipped = True
                    continue
            for _t, k, _v in w.entries:
                seen_keys.add(k)

    def _apply_group_locked(self, group: list[_Writer], total_entries: int) -> list:
        """MemTable apply for one group: bulk per-batch, or hash-sharded
        across the worker pool when the group is huge. While snapshots are
        live, superseded versions a snapshot can still see are retained in
        the memtable's history instead of being discarded (and are NOT in
        the returned prev list — their values are not dead yet)."""
        cfg = self.cfg
        retain = max(self._snapshots) if self._snapshots else None
        if (
            cfg.memtable_shard_apply_entries
            and cfg.memtable_apply_shards > 1
            and total_entries >= cfg.memtable_shard_apply_entries
        ):
            if self._mt_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._mt_pool = ThreadPoolExecutor(
                    max_workers=cfg.memtable_apply_shards, thread_name_prefix="mt-apply"
                )
            self.stats.add("memtable_shard_applies")
            return self.mem.add_group_sharded(
                [(w.seq, w.entries) for w in group],
                self._mt_pool,
                cfg.memtable_apply_shards,
                retain_from=retain,
            )
        prevs: list = []
        for w in group:
            prevs.extend(self.mem.add_batch(w.seq, w.entries, retain_from=retain))
        return prevs

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------
    def snapshot(self) -> Snapshot:
        """Pin the current read point; see :class:`Snapshot`. Raises
        ``RuntimeError`` past ``DBConfig.max_snapshots`` live snapshots."""
        with self.mutex:
            if sum(self._snapshots.values()) >= self.cfg.max_snapshots:
                raise RuntimeError(
                    f"snapshot(): {self.cfg.max_snapshots} snapshots already "
                    "live (DBConfig.max_snapshots) — release some first"
                )
            # The read point is the last PUBLISHED sequence. Pipelined
            # groups hold assigned-but-unpublished seqs; including them
            # would let the "snapshot" grow entries after creation.
            if self._pending:
                seq = min(w.seq for w in self._pending[0].writers) - 1
            else:
                seq = self._seq
            self._snapshots[seq] = self._snapshots.get(seq, 0) + 1
            return Snapshot(self, seq)

    def _release_snapshot_seq(self, seq: int) -> None:
        with self.mutex:
            n = self._snapshots.get(seq, 0)
            if n <= 1:
                self._snapshots.pop(seq, None)
            else:
                self._snapshots[seq] = n - 1

    def snapshot_seqs(self) -> list[int]:
        """Sorted live snapshot read points (compaction stripe boundaries,
        GC unlink guard)."""
        with self.mutex:
            return sorted(self._snapshots)

    def iterator(self, snapshot: Snapshot | None = None) -> Cursor:
        """A bidirectional :class:`Cursor` over a stable read point —
        ``snapshot``, or one taken now and released when the cursor
        closes. The cursor survives concurrent flush/compaction/GC (it
        pins the version); always close it (or use ``with``)."""
        return Cursor(self, snapshot)

    def _adapt_group_cap_locked(self, persist_s: float) -> None:
        """Latency-target controller: EWMA the group persist latency and
        steer the effective byte cap toward ``wal_group_target_latency_s``
        — grow while persists are comfortably fast (more amortization for
        free), shrink when the EWMA overshoots (followers waiting too
        long), clamped to [min_bytes, max_bytes]."""
        cfg = self.cfg
        self._persist_ewma = (
            persist_s
            if self._persist_ewma is None
            else 0.7 * self._persist_ewma + 0.3 * persist_s
        )
        cap = self._group_cap_bytes
        if self._persist_ewma > cfg.wal_group_target_latency_s:
            cap = int(cap * 0.7)
        elif self._persist_ewma < 0.5 * cfg.wal_group_target_latency_s:
            cap = int(cap * 1.5)
        self._group_cap_bytes = min(
            max(cap, cfg.wal_group_min_bytes), cfg.wal_group_max_bytes
        )
        self.stats.set_gauge("wal_group_effective_bytes", self._group_cap_bytes)
        self.stats.set_gauge("wal_persist_ewma_s", self._persist_ewma)

    def _pending_compaction_bytes(self) -> int:
        """Estimate of the compaction debt (RocksDB's
        ``estimated_pending_compaction_bytes``).

        Legacy (``pending_debt_overlap_aware=False``): every byte above a
        level's target plus all of L0 once it crosses the compaction
        trigger — the *displaced* bytes, not the work to clear them.

        Overlap-aware: each level's excess is multiplied by the write
        amplification of pushing it one level down (1 + the target level's
        overlap ratio, clamped at ``level_size_multiplier``), and the
        rewritten bytes cascade: what lands on the next level may push
        *it* over target, so the grandparent overlap those bytes will drag
        along is counted too. The delayed-write controller therefore sees
        the real device-write debt — and starts delaying — before the
        fullness-only estimate would."""
        cfg = self.cfg
        v = self.versions.current
        if not cfg.pending_debt_overlap_aware:
            total = 0
            if len(v.levels[0]) >= cfg.l0_compaction_trigger:
                total += v.level_bytes(0)
            for level in range(1, cfg.num_levels - 1):
                total += max(0, v.level_bytes(level) - cfg.level_max_bytes(level))
            return total
        debt = 0.0
        carry = 0.0  # rewritten bytes arriving from the level above
        for level in range(cfg.num_levels - 1):
            size = v.level_bytes(level) + carry
            if level == 0:
                excess = size if len(v.levels[0]) >= cfg.l0_compaction_trigger else 0.0
            else:
                excess = max(0.0, size - cfg.level_max_bytes(level))
            if excess <= 0.0:
                carry = 0.0
                continue
            ratio = min(
                float(cfg.level_size_multiplier),
                v.level_bytes(level + 1) / max(size, 1.0),
            )
            written = excess * (1.0 + ratio)
            debt += written
            carry = written  # lands one level down: grandparent debt
        return int(debt)

    def _maybe_stall_locked(self) -> None:
        """Writer throttling, two regimes (called by the group leader):

        * **stop** — immutables full, L0 at ``l0_stop_trigger``, or
          compaction debt past the hard limit: block on ``writer_cv`` until
          a background job completion clears the trigger (CV-signalled by
          the scheduler; the timeout is only a lost-wakeup safety net).
        * **delay** — above the soft thresholds the
          :class:`~.scheduler.WriteController` converts the bytes committed
          since the last controller charge (``_delay_debt`` — every
          published group's bytes, so followers' bytes are paid for even
          though only leaders sleep) into a sleep at the current
          delayed-write rate, which decays while the backlog grows and
          recovers as compaction catches up — a smooth throughput ramp
          instead of on/off oscillation. The sleep releases the DB mutex
          (the leader still heads the writer queue, so no second leader
          can form), keeping reads and job-completion hooks unblocked.

        Background-originated writes (GC rewrites) skip both regimes: they
        are already rate-limited at the token bucket, and stalling them
        could deadlock the low-priority pool against itself."""
        cfg = self.cfg
        if getattr(self._bg_local, "exempt", False):
            return
        t0 = None
        # the estimate walks every level's file list — compute it once per
        # wakeup and reuse for both the stop condition and the controller,
        # instead of twice per commit on the hot path
        pending = self._pending_compaction_bytes()
        while (
            len(self.immutables) >= cfg.max_immutables
            or len(self.versions.current.levels[0]) >= cfg.l0_stop_trigger
            or pending >= cfg.hard_pending_compaction_bytes
        ):
            self.errors.check_writable()
            if t0 is None:
                t0 = time.monotonic()
                self.bg.maybe_schedule()
            self.writer_cv.wait(timeout=0.05)
            pending = self._pending_compaction_bytes()
        if t0 is not None:
            self.stats.add_stall(time.monotonic() - t0, kind="stop")
        delay = self._write_controller.delay_for(
            len(self.versions.current.levels[0]), pending, max(self._delay_debt, 1)
        )
        self._delay_debt = 0  # charged (or the region is inactive: stale
        # debt must not snowball into one giant first delay on entry)
        if delay > 0:
            self.stats.add_stall(delay, kind="delay")
            self.mutex.release()
            try:
                time.sleep(delay)
            finally:
                self.mutex.acquire()

    def _rotate_memtable_locked(self) -> None:
        if self.wal is not None:
            self.wal.flush()
            self.wal.close()
        self.immutables.append(self.mem)
        self.mem = MemTable()
        self._open_wal()
        self.bg.maybe_schedule()  # turn the new immutable into a flush job

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------
    def get(self, key: bytes, snapshot: Snapshot | None = None) -> bytes | None:
        """Point lookup: newest version visible at the read point wins
        (MemTables, then L0 newest-first, then deeper levels). With
        ``snapshot`` the read point is the snapshot's sequence; otherwise
        latest. SSTable blocks are fetched through the shared block cache
        before any pread; separated values then resolve through the
        BVCache / BValue store. Returns None for absent, deleted, or
        range-deleted keys."""
        read_seq = MAX_SEQ if snapshot is None else snapshot.seq
        # lock-free against background work: the (memtables, version) pair
        # is snapshotted under the mutex, but a compaction may finish and
        # unlink this snapshot's input files while we walk it. The reader
        # cache keeps dropped files open (close-deferred), so that window
        # only bites on a cache miss — retry against a fresh snapshot.
        for _attempt in range(8):
            with self.mutex:
                tables = [self.mem, *reversed(self.immutables)]
                version = self.versions.current
            try:
                result = self._lookup_at(key, read_seq, tables, version)
            except (OSError, ValueError) as e:
                if self.versions.current is version:
                    if isinstance(e, CorruptionError):
                        # quarantine before surfacing: the next read (and
                        # the compaction picker) skips the bad file
                        self.errors.on_corruption(e)
                    raise  # stable snapshot: real I/O or corruption error
                continue  # snapshot superseded mid-walk — take a fresh one
            # a miss is only trustworthy if the version didn't move under
            # us (a file may have been replaced between candidates); under
            # sustained churn accept the last miss rather than spinning.
            if (
                result is not None
                or self.versions.current is version
                or _attempt == 7
            ):
                return result
        return None

    def _lookup_at(self, key: bytes, read_seq: int, tables, version):
        """One MVCC point lookup over a fixed (memtables, version) pair:
        the resolved value, or None for absent / point-deleted /
        range-deleted at ``read_seq``. Raises OSError/ValueError when the
        walk races a compaction (``get`` retries on a fresh pair; pinned
        callers — cursors — can never see that).

        Tombstone accounting relies on the LSM freshness invariants:
        memtable data is strictly newer than table data, and shallower
        overlapping table data is strictly newer than deeper — so the max
        covering-tombstone seq only needs the sources up to AND INCLUDING
        the hit's level (a snapshot-retained version can coexist with a
        newer tombstone in the *adjacent touching file* of the same sorted
        level, hence "including")."""
        tomb = 0
        hit = None
        for t in tables:
            ts = t.covering_tombstone_seq(key, read_seq)
            if ts > tomb:
                tomb = ts
            found, seq, type_, value = t.get_at(key, read_seq)
            if found:
                hit = (seq, type_, value)
                break
        if hit is None:
            hit_level = None
            for level, fmeta in version.candidates_for_get(key):
                if hit is not None and level != hit_level:
                    break  # deeper data is strictly older — done
                reader = self.versions.reader(fmeta.file_no)
                if reader.range_tombstones:
                    ts = reader.max_tombstone_seq(key, read_seq)
                    if ts > tomb:
                        tomb = ts
                if hit is None:
                    if read_seq == MAX_SEQ:
                        found, seq, type_, value = reader.get(key)
                    else:
                        found, seq, type_, value = reader.get_at(key, read_seq)
                    if found:
                        hit = (seq, type_, value)
                        hit_level = level
        if hit is None or hit[0] < tomb or hit[1] == kTypeDeletion:
            return None
        return self._resolve(key, hit[1], hit[2])

    def _resolve(self, key: bytes, type_: int, value: bytes) -> bytes | None:
        if type_ == kTypeDeletion:
            return None
        if type_ == kTypeValue:
            return value
        voff = ValueOffset.decode(value)
        cached = self.bvcache.get_if_unpersisted(
            key, voff, pinned_only=not self.cfg.bvcache_enabled
        )
        if cached is not None:
            self.bvcache.hits += 1
            return cached
        self.bvcache.misses += 1
        try:
            return self.bvalue.get(voff, verify=self.cfg.paranoid_checks)
        except CorruptionError as e:
            self.errors.on_corruption(e)  # quarantine the value-log file
            raise

    def multi_get(
        self, keys, snapshot: Snapshot | None = None
    ) -> list[bytes | None]:
        """Batched point lookup: resolve many keys in one pass, returning a
        list of values (``None`` for absent/deleted) aligned with ``keys``.

        Semantically identical to ``[self.get(k, snapshot) for k in keys]``
        but structured for batch efficiency: the (memtables, version) pair
        is snapshotted ONCE per chunk; per level, every still-unresolved
        key is probed against a candidate table's bloom filter in a single
        vectorized call (:meth:`BloomFilter.may_contain_many`); and keys
        landing in the same data block decode it once
        (:meth:`SSTableReader.get_many`). Chunks are capped at
        ``DBConfig.multi_get_max_batch`` so one huge batch can't pin a
        version for an unbounded stretch."""
        keys = [bytes(k) for k in keys]
        if not keys:
            return []
        read_seq = MAX_SEQ if snapshot is None else snapshot.seq
        self.stats.add("multi_gets")
        self.stats.add("multi_get_keys", len(keys))
        out: dict[bytes, bytes | None] = {}
        cap = max(1, self.cfg.multi_get_max_batch)
        for i in range(0, len(keys), cap):
            # dedup (order-preserving): each distinct key resolves once
            chunk = list(dict.fromkeys(keys[i : i + cap]))
            # same lock-free retry protocol as ``get`` (see there): a walk
            # torn by a concurrent compaction retries the whole chunk on a
            # fresh (memtables, version) pair.
            for _attempt in range(8):
                with self.mutex:
                    tables = [self.mem, *reversed(self.immutables)]
                    version = self.versions.current
                try:
                    resolved = self._multi_lookup_at(
                        chunk, read_seq, tables, version
                    )
                except (OSError, ValueError) as e:
                    if self.versions.current is version:
                        if isinstance(e, CorruptionError):
                            self.errors.on_corruption(e)
                        raise  # stable snapshot: real I/O or corruption
                    continue  # snapshot superseded mid-walk — retry
                # misses are only trustworthy on an unmoved version; under
                # sustained churn accept the last answer rather than spin
                if self.versions.current is version or _attempt == 7:
                    out.update(resolved)
                    break
        return [out.get(k) for k in keys]

    def _multi_lookup_at(self, keys, read_seq: int, tables, version) -> dict:
        """One batched MVCC lookup over a fixed (memtables, version) pair.
        Returns ``{key: value-or-None}`` for every key. Level by level:
        keys already resolved at a shallower level drop out (deeper data is
        strictly older), in-level files still contribute range-tombstone
        seqs for keys they cover (same invariant as ``_lookup_at``: the
        max covering tombstone must include the hit's own level)."""
        tomb = dict.fromkeys(keys, 0)
        hit: dict[bytes, tuple | None] = dict.fromkeys(keys)
        # memtables stay scalar — pure in-memory probes, strictly newer
        # than any table data
        pending = []
        for key in keys:
            for t in tables:
                ts = t.covering_tombstone_seq(key, read_seq)
                if ts > tomb[key]:
                    tomb[key] = ts
                found, seq, type_, value = t.get_at(key, read_seq)
                if found:
                    hit[key] = (seq, type_, value)
                    break
            if hit[key] is None:
                pending.append(key)
        snap_seq = None if read_seq == MAX_SEQ else read_seq
        for level, files in enumerate(version.levels):
            pending = [k for k in pending if hit[k] is None]
            if not pending or not files:
                continue
            if level == 0:
                # L0 files overlap; probe in list order (newest first)
                groups = [
                    (i, [k for k in pending if f.smallest <= k <= f.largest])
                    for i, f in enumerate(files)
                ]
            else:
                # sorted level: bisect each key to its file; bounds extended
                # by range tombstones can make two files TOUCH on one key —
                # keep walking while smallest <= key (at most one extra),
                # earlier file first (it holds the newer versions)
                largests = [f.largest for f in files]
                gm: dict[int, list[bytes]] = {}
                for k in pending:
                    fi = bisect.bisect_left(largests, k)
                    while fi < len(files) and files[fi].smallest <= k:
                        gm.setdefault(fi, []).append(k)
                        fi += 1
                groups = sorted(gm.items())
            for fi, ks in groups:
                if not ks:
                    continue
                reader = self.versions.reader(files[fi].file_no)
                if reader.range_tombstones:
                    for k in ks:
                        ts = reader.max_tombstone_seq(k, read_seq)
                        if ts > tomb[k]:
                            tomb[k] = ts
                probe = [k for k in ks if hit[k] is None]
                if probe:
                    for k, ent in reader.get_many(probe, read_seq=snap_seq).items():
                        hit[k] = ent
        out = {}
        for k in keys:
            h = hit[k]
            if h is None or h[0] < tomb[k] or h[1] == kTypeDeletion:
                out[k] = None
            else:
                out[k] = self._resolve(k, h[1], h[2])
        return out

    def range(
        self,
        start: bytes = b"",
        end: bytes | None = None,
        limit: int | None = None,
        snapshot: Snapshot | None = None,
    ):
        """Stream live ``(key, value)`` pairs with ``start <= key``
        (``< end`` when given), ascending, up to ``limit`` — the canonical
        range-read surface (``scan(start, count)`` is a deprecated shim
        over it).

        A generator over a pinned :class:`Cursor`: the walk cannot be torn
        by concurrent flush/compaction/GC (the cursor pins the version and
        a read-point snapshot for its whole lifetime), memory stays O(1)
        in the result size, and abandoning the generator early closes the
        cursor (``GeneratorExit`` unwinds the ``with``). The cursor — and
        with it the read point, when no ``snapshot`` is passed — is only
        taken when iteration actually starts, standard generator
        semantics.

        Iterator fan-out is lazy: L0 files overlap so each contributes its
        own iterator, but every sorted level (L1+) feeds the heap merge ONE
        concatenating iterator that binary-searches the file list and opens
        a file only when the merge cursor actually reaches it — a short
        range read touches O(levels) files, not O(all files).
        """
        if limit is not None and limit <= 0:
            return
        n = 0
        with Cursor(self, snapshot) as cur:
            ok = cur.seek(start)
            while ok:
                key = cur.key
                if end is not None and key >= end:
                    return
                yield key, cur.value
                n += 1
                if limit is not None and n >= limit:
                    return
                ok = cur.next()

    def scan(self, start: bytes, count: int) -> list[tuple[bytes, bytes]]:
        """Deprecated: use ``range(start, limit=count)``.

        Kept as a shim (materializes the same result list) so old callers
        keep working; the historical bounded-retry scaffold (and the typed
        :class:`SnapshotUnstableError`) stays with it for alternate
        ``_scan_attempts`` implementations that can still report a torn
        snapshot by returning None.
        """
        warnings.warn(
            "DB.scan(start, count) is deprecated; use "
            "DB.range(start, limit=count)",
            DeprecationWarning,
            stacklevel=2,
        )
        for _round in range(2):
            if _round:
                time.sleep(0.005)  # one backoff round, then give up typed
            result = self._scan_attempts(start, count)
            if result is not None:
                return result
        raise SnapshotUnstableError(
            "scan() could not obtain a stable version snapshot"
        )

    def _scan_attempts(
        self, start: bytes, count: int
    ) -> list[tuple[bytes, bytes]] | None:
        with Cursor(self) as cur:
            out: list[tuple[bytes, bytes]] = []
            ok = cur.seek(start)
            while ok and len(out) < count:
                out.append((cur.key, cur.value))
                ok = cur.next()
            return out

    def _level_concat_iter(self, files, start: bytes):
        """Lazily chain one sorted level's tables: a reader is opened only
        when the previous file is exhausted (or, for the first file, when
        the heap merge first pulls from this level)."""
        first = True
        for f in files:
            it = self.versions.reader(f.file_no).iter_from(start if first else f.smallest)
            first = False
            yield from it

    # ------------------------------------------------------------------
    # maintenance / lifecycle
    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Synchronous barrier: drain the commit pipeline, rotate the
        memtable, flush every immutable to L0, and force BValue/WAL
        persistence. On return all previously-acked writes are in SSTables
        or durable logs."""
        with self.mutex:
            # in-flight groups have unapplied entries targeting the current
            # WAL/memtable pair — rotating now would strand them.
            while self._pending:
                self._publish_cv.wait()
            # a tombstone-only memtable has len() == 0 but must still reach
            # an SSTable (its range block), so it counts as flushable
            if len(self.mem) or self.mem.range_tombstones:
                self._rotate_memtable_locked()
        self.wait_idle(compactions=False)
        self.bvalue.flush()
        if self.wal is not None:
            self.wal.flush()

    def wait_idle(self, compactions: bool = True, timeout: float = 120.0) -> None:
        """Block until background work is quiescent. Signalled by the job
        scheduler's completion CV — no sleep-polling, and no ``pick()``
        probes while idle (the coordinator schedules exhaustively at every
        completion edge, so idleness is a pure counter condition)."""
        self.bg.wait_idle(compactions=compactions, timeout=timeout)

    def gc_collect(self, threshold: float = 0.5) -> dict:
        """Reclaim BValue files whose dead ratio ≥ threshold (beyond-paper
        extension — see core/gc.py). Synchronous wrapper over the same
        pass the scheduler runs when ``gc_auto`` is on; a shared lock keeps
        manual and auto GC from ever running concurrently."""
        return self.bg.run_gc(threshold)

    def compact_all(self) -> None:
        """Drive compaction to quiescence (test/benchmark helper)."""
        self.wait_idle(compactions=True)

    def checkpoint(
        self, directory: str, base: str | None = None, hardlink: bool = True
    ) -> None:
        """Online checkpoint: materialize a consistent, openable copy of
        the DB in ``directory`` without stopping writes.

        ``base`` names a previous checkpoint image: any file already
        present there is hard-linked from the base instead of from the
        live DB (incremental checkpoint — repeated replica re-bootstraps
        only materialize what changed). SSTables and sealed BValue files
        are immutable, so same-name ⇒ same-content; the MANIFEST is always
        written fresh.

        ``hardlink=False`` forces byte copies from the *live* DB (links
        from ``base`` still happen — the base belongs to the image's own
        machine). A replica bootstrap needs this: the image will be
        written to (value mirroring) by a different failure domain, and a
        shared inode would let the replica's faults reach the primary's
        files.

        Sequence: flush (so everything acked is in SSTables — a checkpoint
        carries no WAL), seal the active BValue files (an append tail must
        never be hard-linked: the link shares the inode, so later appends
        would bleed into the checkpoint), then under the mutex pin the
        current version + register a snapshot and capture the counters.
        Live tables and value files are hard-linked (``checkpoint_hardlink``;
        copy fallback on False or a cross-device error) into the target,
        and finally a fresh single-edit MANIFEST is written via tmp-file +
        fsync + atomic rename — its presence is the commit marker, so a
        crash mid-checkpoint leaves a directory that is recognizably
        incomplete (no MANIFEST) rather than a subtly wrong DB.

        The pin keeps every captured SSTable on disk (compaction defers
        input unlinks); the snapshot keeps BValue GC from unlinking a
        value file whose pre-rewrite pointers the captured tables still
        hold. The retry probe on value files covers the one benign race
        left (GC passed its guard before our snapshot registered — then
        the captured tables only reference the rewritten copies)."""
        if self.env.exists(os.path.join(directory, MANIFEST_NAME)):
            raise ValueError(f"checkpoint: {directory!r} already holds a DB")
        self.flush()
        self.bvalue.seal_active()
        with self.mutex:
            snap = self.snapshot()
            version = self.versions.pin_current()
            last_seq = self.versions.last_seq
            next_file_no = self.versions.next_file_no
            bv_next = self.bvalue.next_file_id
        try:
            self.env.makedirs(directory)
            bv_dir = os.path.join(directory, "bvalue")
            self.env.makedirs(bv_dir)
            add = []
            for level, lv in enumerate(version.levels):
                # L0 is ordered newest-first in memory, but manifest replay
                # INSERTS each L0 add at the front — a single batched edit
                # must list L0 oldest-first or the opened image reads L0 in
                # reversed (oldest-wins) order.
                files = list(reversed(lv)) if level == 0 else lv
                for f in files:
                    self._checkpoint_file(
                        table_path(self.path, f.file_no),
                        table_path(directory, f.file_no),
                        base_src=table_path(base, f.file_no) if base else None,
                        hardlink=hardlink,
                    )
                    add.append((level, f.to_wire()))
            src_bv = os.path.join(self.path, "bvalue")
            base_bv = os.path.join(base, "bvalue") if base else None
            for name in sorted(self.env.listdir(src_bv)):
                if not name.endswith(".val"):
                    continue
                for _ in range(3):
                    try:
                        self._checkpoint_file(
                            os.path.join(src_bv, name),
                            os.path.join(bv_dir, name),
                            base_src=os.path.join(base_bv, name) if base_bv else None,
                            hardlink=hardlink,
                        )
                        break
                    except OSError:
                        if not self.env.exists(os.path.join(src_bv, name)):
                            break  # GC'd mid-walk: nothing live points here
            edit = {
                "add": add,
                "last_seq": last_seq,
                "next_file_no": next_file_no,
                "bvalue_next_file_id": bv_next,
            }
            tmp = os.path.join(directory, MANIFEST_NAME + ".tmp")
            f = self.env.open(tmp, "wb")
            try:
                f.write(frame_record(msgpack.packb(edit, use_bin_type=True)))
                f.flush()
                self.env.fsync(f)
            finally:
                f.close()
            self.env.rename(tmp, os.path.join(directory, MANIFEST_NAME))
            self.stats.add("checkpoints")
            # the committed image now belongs to its consumer (a replica, a
            # backup target): this env's crash simulation must no longer
            # rewind files another failure domain may start writing. An
            # uncommitted image (crash before the rename) stays tracked —
            # its unsynced files SHOULD vanish with this machine.
            self.env.release_tracking(directory)
        finally:
            self.versions.unpin()
            snap.release()

    def _checkpoint_file(
        self,
        src: str,
        dst: str,
        base_src: str | None = None,
        hardlink: bool = True,
    ) -> None:
        if base_src is not None and self.env.exists(base_src):
            # incremental: the previous image already holds this (immutable)
            # file — link from there, never touching the live copy. The
            # size check guards bases that are NOT pristine images (a
            # re-bootstrap reuses the old replica store, where a mirrored
            # value file can be a short prefix of the primary's): same
            # name + same size is required before trusting same content.
            try:
                if self.env.getsize(base_src) == self.env.getsize(src):
                    self.env.link(base_src, dst)
                    self.stats.add("checkpoint_base_links")
                    return
            except OSError:
                pass  # base unusable for this file: fall through to live
        if hardlink and self.cfg.checkpoint_hardlink:
            try:
                self.env.link(src, dst)
                return
            except FileNotFoundError:
                raise
            except OSError:
                pass  # EXDEV / EEXIST / unsupported — fall back to a copy
        with self.env.open(src, "rb") as fi:
            data = fi.read()
        f = self.env.open(dst, "wb")
        try:
            f.write(data)
            f.flush()
            self.env.fsync(f)
        finally:
            f.close()

    def resume(self) -> None:
        """Leave read-only mode after a hard background error.

        Probes the Env (write + fsync + readback of a scratch file — if the
        cause, say ENOSPC, still holds, the probe raises and the latch
        stays), clears the error latch, replaces a poisoned WAL by sealing
        the current memtable (its log tail may be torn; replay stops at the
        damage anyway, and the sealed memtable holds everything acked), and
        re-kicks the scheduler so deferred flush/compaction/GC work drains.
        """
        if self.errors.error is None:
            return  # not latched: nothing to do
        probe = os.path.join(self.path, "RESUME_PROBE")
        f = self.env.open(probe, "wb")
        try:
            f.write(b"probe")
            f.flush()
            self.env.fsync(f)
        finally:
            f.close()
        try:
            with self.env.open(probe, "rb") as f:
                if f.read() != b"probe":
                    raise IOError("resume(): Env probe readback mismatch")
        finally:
            try:
                self.env.unlink(probe)
            except OSError:
                pass
        self.errors.clear()
        with self.mutex:
            wal = self.wal
            if wal is not None and wal._poisoned:
                # a WAL append failed mid-file: never append past the torn
                # tail. The failed group was never applied (publish skips on
                # error), so the memtable holds exactly the durable prefix —
                # seal it behind a fresh WAL file.
                while self._pending:
                    self._publish_cv.wait()
                self._rotate_memtable_locked()
        self.stats.add("resumes")
        self.bg.maybe_schedule()

    # ------------------------------------------------------------------
    # replication
    # ------------------------------------------------------------------
    def promote(self) -> None:
        """Failover: turn this replica into a primary.

        The resume machinery in reverse — instead of clearing a latch
        on the same instance, the write latch moves here: seal the stream
        (no further frames apply), replay whatever suffix survives in the
        old primary's durable WAL (final catch-up — in sync mode that is
        every acknowledged write, because values fsync before their pointer
        record and retention kept the segments), discard buffered
        non-contiguous frames (the unacked suffix), move the BValue id
        allocator past the mirrored id space and force-roll every queue so
        new writes can never append into a mirrored file, then flip the
        role. Idempotent: promoting a primary — or promoting twice, or
        during an in-flight apply — is a no-op beyond the first call."""
        with self.mutex:
            if self._role != "replica":
                return
        follower = self._follower
        if follower is not None:
            follower.seal(final_catch_up=True)
            # async primaries can die with durable pointers to value bytes
            # that never hit their disk; the final catch-up then mirrors
            # nothing for them. Same hole async recovery has, same cure:
            # probe and drop, each key falls back to its previous version.
            self._drop_dangling_pointers()
        with self.mutex:
            if self._role != "replica":  # lost a promote race
                return
            if follower is not None:
                self.bvalue.ensure_next_file_id(follower.max_mirrored_file + 1)
            self.bvalue.seal_active(force=True)
            self._role = "primary"
            self._follower = None
            # start the new reign on a fresh WAL segment if the memtable
            # holds applied-but-unflushed state (mirrors resume())
            if len(self.mem) or self.mem.range_tombstones:
                self._rotate_memtable_locked()
        self.stats.add("promotions")
        self.bg.maybe_schedule()

    def replication_status(self) -> dict:
        """Role + stream position for observability and the benchmark."""
        out: dict = {"role": self._role}
        repl = self._repl
        if repl is not None and repl.active:
            out["shipped_seq"] = repl.shipped_seq
            out["min_acked_seq"] = repl.min_acked()
            out["retained_wals"] = len(repl._retained)
        follower = self._follower
        if follower is not None:
            out["applied_seq"] = follower.applied_seq
            out["last_shipped_seen"] = follower.last_shipped_seen
            out["lag"] = follower.lag
            out["diverged"] = follower.diverged
            out["needs_rebootstrap"] = follower.needs_rebootstrap
        return out

    def verify_integrity(
        self, background: bool = False, fail_fast: bool = False
    ) -> dict | None:
        """Scrub the DB: CRC-verify every live SSTable block and every
        separated value reachable from a live table entry. Corrupt files
        are quarantined (manifest-marked, skipped by compaction and GC)
        via the normal :class:`CorruptionError` path, and the scan keeps
        going — the report's ``findings`` list carries every damage site
        (file, block, error class), so a replica bootstrap can
        quarantine-and-continue instead of giving up at the first hit.
        Reads are paced at low priority through the shared I/O token
        bucket, so a scrub cannot starve foreground traffic.

        ``fail_fast=True`` restores raise-on-first-corruption semantics
        (the first :class:`CorruptionError` propagates after quarantining
        its file). ``background=True`` submits the scrub to the
        low-priority job pool and returns None; otherwise runs inline and
        returns the report dict."""
        if background:
            self.bg.submit_scrub()
            return None
        return self._scrub(fail_fast=fail_fast)

    def _scrub(self, fail_fast: bool = False) -> dict:
        report = {
            "sst_files": 0,
            "blocks_verified": 0,
            "values_verified": 0,
            "corruptions": [],
            "findings": [],
        }

        def record(kind: str, file_id, block, exc: BaseException) -> None:
            report["corruptions"].append(str(exc))
            report["findings"].append(
                {
                    "kind": kind,
                    "file": file_id,
                    "block": block,
                    "error": type(exc).__name__,
                    "detail": str(exc),
                }
            )
            if fail_fast:
                raise exc

        version = self.versions.current
        quarantined = self.versions.quarantined_files()
        seen_vals: set[tuple[int, int]] = set()
        for level in range(len(version.levels)):
            for fmeta in version.levels[level]:
                if self._closed or fmeta.file_no in quarantined:
                    continue
                try:
                    reader = self.versions.reader(fmeta.file_no)
                except OSError:
                    continue  # compacted away under the scrub — fine
                report["sst_files"] += 1
                unreadable = False
                file_quarantined = False
                for idx in range(len(reader.index)):
                    if self._closed:
                        break
                    _key, _off, length = reader.index[idx]
                    self.rate_limiter.request(length, PRI_LOW)
                    try:
                        reader.verify_block(idx)
                    except CorruptionError as e:
                        # quarantine once, but keep scanning: the report
                        # must name EVERY damaged block, not just the first
                        if not file_quarantined:
                            self.errors.on_corruption(e)
                            file_quarantined = True
                        record("sst_block", fmeta.file_no, idx, e)
                        continue
                    except OSError:
                        unreadable = True
                        break  # truncated/unlinked mid-scrub: not corruption
                    report["blocks_verified"] += 1
                if unreadable or file_quarantined:
                    continue
                # follow the table's value pointers into the BValue log
                try:
                    for _k, _seq, type_, value in reader.iter_all(fill_cache=False):
                        if self._closed:
                            break
                        if type_ != kTypeValuePtr:
                            continue
                        voff = ValueOffset.decode(value)
                        if (
                            voff.file_id in self.versions.quarantined_bvalues
                            or (voff.file_id, voff.offset) in seen_vals
                        ):
                            continue
                        seen_vals.add((voff.file_id, voff.offset))
                        self.rate_limiter.request(voff.size, PRI_LOW)
                        try:
                            self.bvalue.get(voff, verify=True)
                            report["values_verified"] += 1
                        except CorruptionError as e:
                            self.errors.on_corruption(e)
                            record("bvalue", voff.file_id, voff.offset, e)
                        except OSError:
                            continue  # GC'd / short read: retryable, not rot
                except OSError:
                    continue
        return report

    def close(self, crash: bool = False) -> None:
        """Shut down the engine. ``crash=True`` simulates a hard crash for
        recovery tests: async WAL buffers are dropped, memtables are NOT
        flushed, and background work is abandoned — reopening the path
        exercises the real recovery code."""
        if self._closed:
            return
        self._closed = True
        if self._follower is not None:
            if crash:
                self._follower.sealed = True  # abandon in-flight apply
            else:
                self._follower.seal(final_catch_up=False)
        if self._repl is not None:
            self._repl.close()
        if not crash:
            self.bvalue.flush()
        else:
            # crash simulation: queued flush jobs are discarded and the
            # immutables stay unflushed — reopening recovers from the WAL
            with self.mutex:
                self.immutables.clear()
        self.bg.stop(crash=crash)
        if self.wal is not None:
            self.wal.close(drop_buffered=crash)
        self.bvalue.close()
        self.versions.close()
        if self._mt_pool is not None:
            self._mt_pool.shutdown(wait=True)

    # convenience --------------------------------------------------------
    def __enter__(self) -> "DB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
