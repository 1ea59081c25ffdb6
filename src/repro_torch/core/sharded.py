"""ShardedDB — horizontal keyspace sharding behind one KVStore surface.

The paper's multi-queue parallel value store, lifted one level up:
partition the whole engine so N independent
WAL / value-queue / scheduler stacks run in parallel, each shard a full
:class:`~.db.DB` with its own directory, behind a single router that
satisfies the same :class:`~.api.KVStore` protocol as one ``DB``.

Layout::

    <path>/ROUTER            msgpack manifest: shard count + partitioner
                             (atomic tmp+rename; its presence commits the
                             store — mirrors the per-shard MANIFEST)
    <path>/ROUTER_LOG        cross-shard batch durability log (CRC-framed,
                             torn-tail tolerant — same framing as the WAL)
    <path>/shard_00000/ …    one full DB per shard

Partitioning
------------

``HashPartitioner`` (default) places each key by ``crc32(key) % N`` —
stable across processes and Python versions (``hash()`` is salted), and
uniform enough that every shard sees ~1/N of the keyspace. Because hash
placement scatters any key interval across all shards, a range delete
fans out to *every* shard (each applies the full ``[start, end)``
tombstone — keys it doesn't own simply aren't covered by it).

``RangePartitioner(boundaries)`` keeps key order: shard ``i`` owns
``[boundaries[i-1], boundaries[i])`` (unbounded at the edges). Range
deletes clip to the overlapping shards only, and merged scans read
shards mostly in sequence instead of interleaving.

The choice is persisted in ``ROUTER`` and validated on reopen: opening
with a different shard count or partitioner than the store was created
with raises ``ValueError`` (config-mismatch detection) — rebalancing is
an explicit offline operation, not something a typo'd ``open()`` should
silently begin.

Cross-shard WriteBatch atomicity
--------------------------------

A batch whose ops land on ONE shard is exactly that shard's atomic
``write`` — one WAL record, crash-atomic, nothing extra. A batch
spanning shards cannot be made atomic by the shards alone (each commits
its own WAL independently), so the router adds a lightweight write-ahead
intent log:

1. **intent**: the full batch (ops grouped per shard) is appended to
   ``ROUTER_LOG`` and — under sync WAL — fsynced *before* any shard
   sees it;
2. **apply**: each shard commits its sub-batch atomically (fanned out in
   parallel when ``router_parallel_fanout``);
3. **commit**: a commit record for the batch id is appended (and fsynced
   under sync WAL) — only then is the write acknowledged.

Cross-shard batches are serialized by a router lock, so at a crash at
most the tail batches of the log lack commit records. Reopen replays
every uncommitted intent *forward* into the shards (re-applying a
sub-batch that already committed is state-idempotent: same puts, same
tombstones), flushes them, and truncates the log. A crash therefore
never exposes a torn batch *silently*: either the intent was durable and
the batch is completed at recovery, or the intent never hit the log and
no shard saw any of it (the fsync-before-apply ordering). The guarantee
is exactly as strong as the WAL mode — under ``async``, a sub-batch a
shard acked may be lost with that shard's WAL tail, the same
lose-the-tail semantics a single async DB documents. Note the replay is
*forward-only*: a batch the client never saw acknowledged may become
visible after recovery — a legal serialization (the write was in
flight), the same contract a single DB's group commit gives a crashed
writer.

Readers between steps 2 and 3 can observe a half-applied batch (each
shard publishes independently) — the router provides per-shard
atomicity plus crash completion, not cross-shard isolation. Snapshots
narrow this: ``snapshot()`` takes the per-shard snapshots under the
same router lock that serializes cross-shard commits, so a
``ShardedSnapshot`` never straddles one (it sees all of a cross-shard
batch or none of it). The cut is still not a single global instant —
independent single-shard writes may land between the per-shard
acquisitions.

``checkpoint(dir)`` fans out per-shard online checkpoints under that
same lock (single-shard writes continue; cross-shard batches stall for
the duration), writing the ``ROUTER`` manifest last as the commit
marker — the image opens as a ``ShardedDB`` with the same guarantee:
no torn cross-shard batch, per-shard consistency, not one global
instant.

Scans merge the per-shard cursors: a heap for forward order, a
max-of-candidates walk for reverse — keys are unique across shards
(each key has exactly one home), so no tie-breaking is needed.
"""
from __future__ import annotations

import bisect
import heapq
import os
import threading
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace as dc_replace

from repro_torch import _msgpack as msgpack

from .config import DBConfig
from .db import DB, Cursor, Snapshot
from .env import DEFAULT_ENV
from .errors import CorruptionError
from .record import frame_record, iter_framed_records, kTypeRangeDeletion
from .writebatch import WriteBatch

ROUTER_NAME = "ROUTER"
ROUTER_LOG_NAME = "ROUTER_LOG"
SHARD_DIR_FMT = "shard_%05d"


# ---------------------------------------------------------------------------
# partitioners
# ---------------------------------------------------------------------------

class HashPartitioner:
    """``crc32(key) % N`` placement — process-stable, order-destroying."""

    name = "hash"

    def __init__(self, num_shards: int):
        self.num_shards = num_shards

    def shard_of(self, key: bytes) -> int:
        return zlib.crc32(key) % self.num_shards

    def shards_for_range(self, start: bytes, end: bytes):
        """Hash placement scatters every interval: all shards, unclipped."""
        return [(i, start, end) for i in range(self.num_shards)]

    def manifest(self) -> dict:
        return {"partitioner": self.name}


class RangePartitioner:
    """Order-preserving split: shard ``i`` owns ``[b[i-1], b[i])`` with
    ``b = boundaries`` (sorted, unique; edges unbounded)."""

    name = "range"

    def __init__(self, boundaries):
        bs = [bytes(b) for b in boundaries]
        if sorted(set(bs)) != bs:
            raise ValueError("range boundaries must be sorted and unique")
        self.boundaries = bs
        self.num_shards = len(bs) + 1

    def shard_of(self, key: bytes) -> int:
        return bisect.bisect_right(self.boundaries, key)

    def shards_for_range(self, start: bytes, end: bytes):
        """Overlapping shards only, the range clipped to each shard's
        span (``end`` exclusive: the last shard touched owns ``end``'s
        predecessor, hence ``bisect_left``)."""
        lo = self.shard_of(start)
        hi = bisect.bisect_left(self.boundaries, end)
        out = []
        for i in range(lo, hi + 1):
            s = start if i == lo else self.boundaries[i - 1]
            e = end if i == hi else self.boundaries[i]
            if s < e:
                out.append((i, s, e))
        return out

    def manifest(self) -> dict:
        return {"partitioner": self.name, "boundaries": self.boundaries}


def _make_partitioner(kind: str, num_shards: int, boundaries):
    if kind == "hash":
        return HashPartitioner(num_shards)
    if kind == "range":
        if boundaries is None or len(boundaries) != num_shards - 1:
            raise ValueError(
                "range partitioning needs exactly shards-1 boundaries"
            )
        return RangePartitioner(boundaries)
    raise ValueError(f"unknown partitioner {kind!r} (hash | range)")


# ---------------------------------------------------------------------------
# router durability log
# ---------------------------------------------------------------------------

class _RouterLog:
    """Append-only CRC-framed log of cross-shard batch intents/commits.

    Records are msgpack maps: ``{"t": "i", "id": n, "ops": [[shard,
    [[type, key, value], …]], …]}`` and ``{"t": "c", "id": n}``. Framing
    (:func:`~.record.frame_record`) matches the WAL, so a torn tail is
    dropped, never misread."""

    def __init__(self, path: str, env):
        self.path = path
        self.env = env
        self.size = env.getsize(path) if env.exists(path) else 0
        self._f = env.open(path, "ab")

    def append(self, rec: dict, sync: bool) -> None:
        buf = frame_record(msgpack.packb(rec, use_bin_type=True))
        self._f.write(buf)
        self._f.flush()
        if sync:
            self.env.fsync(self._f)
        self.size += len(buf)

    def read_records(self) -> list[dict]:
        if not self.env.exists(self.path):
            return []
        with self.env.open(self.path, "rb") as f:
            buf = f.read()
        return [
            msgpack.unpackb(p, raw=False) for p in iter_framed_records(buf)
        ]

    def truncate(self) -> None:
        """Drop everything logged (caller has made the shards cover it)."""
        self._f.close()
        self.env.unlink(self.path)
        self._f = self.env.open(self.path, "ab")
        self.size = 0

    def close(self) -> None:
        self._f.close()


# ---------------------------------------------------------------------------
# snapshots / merged cursor
# ---------------------------------------------------------------------------

class ShardedSnapshot:
    """One pinned read point per shard, taken under the router's
    cross-shard commit lock — the cut never splits a cross-shard batch
    (see the module docstring for what it does *not* promise)."""

    __slots__ = ("_snaps", "_released")

    def __init__(self, snaps: list[Snapshot]):
        self._snaps = snaps
        self._released = False

    def for_shard(self, idx: int) -> Snapshot:
        return self._snaps[idx]

    @property
    def seqs(self) -> list[int]:
        return [s.seq for s in self._snaps]

    def release(self) -> None:
        if not self._released:
            self._released = True
            for s in self._snaps:
                s.release()

    def __enter__(self) -> "ShardedSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "released" if self._released else "live"
        return f"<ShardedSnapshot shards={len(self._snaps)} {state}>"


class MergedCursor:
    """Bidirectional cursor over all shards at one ``ShardedSnapshot``.

    Holds one pinned per-shard :class:`~.db.Cursor` each. Forward
    iteration is a heap of ``(key, shard)`` heads; reverse iteration
    keeps a predecessor candidate per shard and takes the max. Keys are
    unique across shards (one home each), so neither direction needs a
    tie-break. Direction switches re-seek the per-shard cursors around
    the current key — ``seek(k)`` lands on the first key ≥ ``k``, so its
    ``prev()`` is exactly the largest key < ``k``."""

    def __init__(self, sdb: "ShardedDB", snapshot: ShardedSnapshot | None = None):
        self._own_snap = snapshot is None
        self._snap = sdb.snapshot() if snapshot is None else snapshot
        self._curs: list[Cursor] = [
            Cursor(shard, self._snap.for_shard(i))
            for i, shard in enumerate(sdb.shards)
        ]
        self._dir: str | None = None
        self._heap: list[tuple[bytes, int]] = []
        self._cands: list[tuple[bytes, bytes] | None] = []
        self._src = -1  # shard that produced the current position
        self.key: bytes | None = None
        self.value: bytes | None = None
        self.valid = False
        self._closed = False

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.valid = False
        for c in self._curs:
            c.close()
        if self._own_snap:
            self._snap.release()

    def __enter__(self) -> "MergedCursor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- forward ---------------------------------------------------------
    def seek(self, target: bytes) -> bool:
        """Position on the first visible key >= ``target``; returns
        ``valid``."""
        self._dir = "fwd"
        self._heap = []
        for i, c in enumerate(self._curs):
            if c.seek(target):
                self._heap.append((c.key, i))
        heapq.heapify(self._heap)
        return self._pop_fwd()

    def seek_to_first(self) -> bool:
        return self.seek(b"")

    def _pop_fwd(self) -> bool:
        if not self._heap:
            self.key = None
            self.value = None
            self.valid = False
            return False
        key, i = heapq.heappop(self._heap)
        self._src = i
        self.key = key
        self.value = self._curs[i].value  # cursor still parked on ``key``
        self.valid = True
        return True

    def next(self) -> bool:
        """Advance to the next visible key; returns ``valid``."""
        if self._dir == "fwd":
            c = self._curs[self._src]
            if c.next():
                heapq.heappush(self._heap, (c.key, self._src))
            return self._pop_fwd()
        # switching out of reverse (or never positioned): step past the
        # current key — only its home shard re-seeks ONTO it
        if not self.valid:
            return False
        key = self.key
        self._dir = "fwd"
        self._heap = []
        for i, c in enumerate(self._curs):
            ok = c.seek(key)
            if ok and c.key == key:
                ok = c.next()
            if ok:
                self._heap.append((c.key, i))
        heapq.heapify(self._heap)
        return self._pop_fwd()

    # -- reverse ---------------------------------------------------------
    def prev(self) -> bool:
        """Step to the largest visible key strictly below the current one
        (below infinity when invalid). Returns ``valid``."""
        if self._dir == "bwd":
            c = self._curs[self._src]
            self._cands[self._src] = (c.key, c.value) if c.prev() else None
        else:
            bound = self.key if self.valid else None
            self._dir = "bwd"
            self._cands = []
            for c in self._curs:
                if bound is not None:
                    c.seek(bound)  # parks ≥ bound (or exhausts the shard)
                # bound None ⇒ the merged cursor is invalid ⇒ every shard
                # cursor is too, and an invalid prev() is a seek-to-last
                self._cands.append((c.key, c.value) if c.prev() else None)
        best_i = -1
        for i, cand in enumerate(self._cands):
            if cand is not None and (
                best_i < 0 or cand[0] > self._cands[best_i][0]
            ):
                best_i = i
        if best_i < 0:
            self.key = None
            self.value = None
            self.valid = False
            return False
        self._src = best_i
        self.key, self.value = self._cands[best_i]
        self.valid = True
        return True


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class ShardedDB:
    """N full ``DB`` engines behind one ``KVStore`` router.

    See the module docstring for placement, cross-shard batch, snapshot
    and checkpoint semantics. Canonical constructor:
    ``ShardedDB.open(path, shards=N, config=None)``."""

    def __init__(
        self,
        path: str,
        shards: int | None = None,
        cfg: DBConfig | None = None,
        partitioner: str = "hash",
        boundaries=None,
    ):
        self.path = path
        self.cfg = cfg or DBConfig()
        self.env = self.cfg.env or DEFAULT_ENV
        self.env.makedirs(path)
        manifest_path = os.path.join(path, ROUTER_NAME)
        existing = self._load_manifest(manifest_path)
        if existing is not None:
            # config-mismatch-on-reopen detection: adopt what's persisted,
            # reject explicit arguments that contradict it
            if shards is not None and shards != existing["shards"]:
                raise ValueError(
                    f"shard-count mismatch: store at {path!r} has "
                    f"{existing['shards']} shards, open() asked for {shards}"
                )
            if partitioner != "hash" and partitioner != existing["partitioner"]:
                raise ValueError(
                    f"partitioner mismatch: store at {path!r} uses "
                    f"{existing['partitioner']!r}, open() asked for "
                    f"{partitioner!r}"
                )
            shards = existing["shards"]
            partitioner = existing["partitioner"]
            if partitioner == "range":
                boundaries = existing["boundaries"]
        elif shards is None:
            raise ValueError(
                f"no sharded store at {path!r}: pass shards=N to create one"
            )
        elif shards < 1:
            raise ValueError("shards must be >= 1")
        self.partitioner = _make_partitioner(partitioner, shards, boundaries)
        shard_cfg = self._shard_config(shards)
        self.shards: list[DB] = [
            DB(os.path.join(path, SHARD_DIR_FMT % i), shard_cfg)
            for i in range(shards)
        ]
        # serializes cross-shard commits; snapshot()/checkpoint() take it
        # so their per-shard cuts never split a cross-shard batch
        self._batch_lock = threading.Lock()
        self._pool = (
            ThreadPoolExecutor(
                max_workers=min(shards, 16),
                thread_name_prefix="shard-router",
            )
            if self.cfg.router_parallel_fanout and shards > 1
            else None
        )
        self._router_stats = {
            "single_shard_batches": 0,
            "cross_shard_batches": 0,
            "replayed_batches": 0,
            "log_truncations": 0,
        }
        self._log = _RouterLog(os.path.join(path, ROUTER_LOG_NAME), self.env)
        self._log_sync = self.cfg.wal_mode == "sync"
        self._next_batch_id = 1
        self._closed = False
        self._replay_log()
        if existing is None:
            # manifest LAST: its presence commits the store, so a crash
            # mid-create leaves a directory open() refuses half-made
            self._write_manifest(manifest_path)

    # -- construction helpers -------------------------------------------
    @classmethod
    def open(
        cls,
        path: str,
        shards: int | None = None,
        config: DBConfig | None = None,
        **kw,
    ) -> "ShardedDB":
        """Canonical constructor: open the sharded store at ``path``,
        creating it with ``shards`` engines if absent. On reopen the
        persisted shard count/partitioner win; passing a contradicting
        ``shards`` raises ``ValueError``."""
        return cls(path, shards, config, **kw)

    def _shard_config(self, n: int) -> DBConfig:
        cfg = self.cfg
        if not cfg.shard_divide_cache_budget or n <= 1:
            return cfg
        # divide the cache budgets so N shards cost what the config names
        return dc_replace(
            cfg,
            block_cache_bytes=cfg.block_cache_bytes // n,
            bvcache_bytes=cfg.bvcache_bytes // n,
        )

    def _load_manifest(self, manifest_path: str) -> dict | None:
        if not self.env.exists(manifest_path):
            return None
        with self.env.open(manifest_path, "rb") as f:
            raw = f.read()
        try:
            meta = msgpack.unpackb(raw, raw=False)
        except Exception as e:
            raise CorruptionError(f"unreadable ROUTER manifest: {e}") from e
        if meta.get("partitioner") == "range":
            meta["boundaries"] = [bytes(b) for b in meta["boundaries"]]
        return meta

    def _write_manifest(self, manifest_path: str) -> None:
        meta = {"shards": len(self.shards)}
        meta.update(self.partitioner.manifest())
        tmp = manifest_path + ".tmp"
        f = self.env.open(tmp, "wb")
        try:
            f.write(msgpack.packb(meta, use_bin_type=True))
            f.flush()
            self.env.fsync(f)
        finally:
            f.close()
        self.env.rename(tmp, manifest_path)

    def _replay_log(self) -> None:
        """Complete every intent the log holds no commit record for (the
        crash-recovery half of the cross-shard batch protocol)."""
        records = self._log.read_records()
        outstanding: dict[int, list] = {}
        max_id = 0
        for rec in records:
            max_id = max(max_id, rec["id"])
            if rec["t"] == "i":
                outstanding[rec["id"]] = rec["ops"]
            else:
                outstanding.pop(rec["id"], None)
        self._next_batch_id = max_id + 1
        if not outstanding:
            if records:
                self._truncate_log_locked()
            return
        touched = set()
        for bid in sorted(outstanding):
            for shard_idx, entries in outstanding[bid]:
                self.shards[shard_idx].write(WriteBatch.from_entries(entries))
                touched.add(shard_idx)
            self._router_stats["replayed_batches"] += 1
        # the shards' WALs now cover the replayed ops; flush before the
        # log is dropped so a crash right here cannot lose them again
        self._fan([self.shards[i].flush for i in sorted(touched)])
        self._truncate_log_locked()

    # -- fan-out plumbing ------------------------------------------------
    def _fan(self, fns):
        """Run the thunks, in parallel when the router pool exists; the
        result list is aligned with ``fns``."""
        if self._pool is None or len(fns) <= 1:
            return [fn() for fn in fns]
        return [f.result() for f in [self._pool.submit(fn) for fn in fns]]

    def _truncate_log_locked(self) -> None:
        self._log.truncate()
        self._router_stats["log_truncations"] += 1

    def shard_of(self, key: bytes) -> int:
        """The shard index ``key`` lives on (routing is deterministic)."""
        return self.partitioner.shard_of(key)

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    # -- write path ------------------------------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        """Route ``key -> value`` to its home shard (that shard's ``put``
        durability semantics apply unchanged)."""
        self.shards[self.partitioner.shard_of(key)].put(key, value)

    def delete(self, key: bytes) -> None:
        self.shards[self.partitioner.shard_of(key)].delete(key)

    def delete_range(self, start: bytes, end: bytes) -> None:
        """Range-tombstone ``[start, end)``. Under hash partitioning every
        shard gets the full tombstone (an interval scatters across all of
        them); under range partitioning only the overlapping shards get
        their clipped pieces. Multi-shard fan-out runs through the
        cross-shard batch protocol, so a crash completes it at reopen
        instead of leaving some shards un-tombstoned silently."""
        batch = WriteBatch().delete_range(start, end)
        self.write(batch)

    def write(self, batch: WriteBatch) -> None:
        """Apply a :class:`WriteBatch`. One-shard batches are that shard's
        native atomic commit; multi-shard batches run the logged
        intent/apply/commit protocol (module docstring: per-shard atomic,
        crash-completed, not cross-shard isolated)."""
        per_shard: dict[int, list] = {}
        for type_, key, value in batch:
            if type_ == kTypeRangeDeletion:
                for idx, s, e in self.partitioner.shards_for_range(key, value):
                    per_shard.setdefault(idx, []).append((type_, s, e))
            else:
                idx = self.partitioner.shard_of(key)
                per_shard.setdefault(idx, []).append((type_, key, value))
        if not per_shard:
            return
        if len(per_shard) == 1:
            idx, entries = next(iter(per_shard.items()))
            self.shards[idx].write(WriteBatch.from_entries(entries))
            self._router_stats["single_shard_batches"] += 1
            return
        ops = sorted(per_shard.items())
        with self._batch_lock:
            bid = self._next_batch_id
            self._next_batch_id += 1
            self._log.append(
                {
                    "t": "i",
                    "id": bid,
                    "ops": [
                        [idx, [list(e) for e in entries]]
                        for idx, entries in ops
                    ],
                },
                sync=self._log_sync,
            )
            self._fan(
                [
                    (lambda s=self.shards[idx], es=entries:
                        s.write(WriteBatch.from_entries(es)))
                    for idx, entries in ops
                ]
            )
            # commit durable before the ack: a post-ack write must never
            # be clobbered by this batch's replay after a crash
            self._log.append({"t": "c", "id": bid}, sync=self._log_sync)
            self._router_stats["cross_shard_batches"] += 1
            if self._log.size > self.cfg.router_log_max_bytes:
                # everything logged is committed (commits are serialized
                # under this lock); flush the shards so their WALs cover
                # it, then drop the log
                self._fan([s.flush for s in self.shards])
                self._truncate_log_locked()

    # -- read path -------------------------------------------------------
    def get(
        self, key: bytes, snapshot: ShardedSnapshot | None = None
    ) -> bytes | None:
        idx = self.partitioner.shard_of(key)
        snap = None if snapshot is None else snapshot.for_shard(idx)
        return self.shards[idx].get(key, snapshot=snap)

    def multi_get(
        self, keys, snapshot: ShardedSnapshot | None = None
    ) -> list[bytes | None]:
        """Batched lookup: keys group by home shard, each shard runs ONE
        ``multi_get`` over its group (the vectorized bloom probes +
        same-block coalescing apply per shard), fanned out in parallel;
        results re-align with ``keys``."""
        keys = [bytes(k) for k in keys]
        if not keys:
            return []
        groups: dict[int, list[int]] = {}
        for pos, key in enumerate(keys):
            groups.setdefault(self.partitioner.shard_of(key), []).append(pos)
        order = sorted(groups)
        results = self._fan(
            [
                (lambda i=idx: self.shards[i].multi_get(
                    [keys[p] for p in groups[i]],
                    snapshot=None if snapshot is None else snapshot.for_shard(i),
                ))
                for idx in order
            ]
        )
        out: list[bytes | None] = [None] * len(keys)
        for idx, vals in zip(order, results):
            for pos, val in zip(groups[idx], vals):
                out[pos] = val
        return out

    def range(
        self,
        start: bytes = b"",
        end: bytes | None = None,
        limit: int | None = None,
        snapshot: ShardedSnapshot | None = None,
    ):
        """Stream live ``(key, value)`` pairs with ``start <= key``
        (``< end`` when given), globally ascending across every shard, up
        to ``limit`` — same contract as :meth:`DB.range`, served from a
        :class:`MergedCursor`."""
        if limit is not None and limit <= 0:
            return
        n = 0
        with MergedCursor(self, snapshot) as cur:
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
        """Deprecated: use ``range(start, limit=count)``."""
        warnings.warn(
            "ShardedDB.scan(start, count) is deprecated; use "
            "ShardedDB.range(start, limit=count)",
            DeprecationWarning,
            stacklevel=2,
        )
        return list(self.range(start, limit=count))

    def iterator(self, snapshot: ShardedSnapshot | None = None) -> MergedCursor:
        """A bidirectional :class:`MergedCursor` over all shards at one
        stable read point (``snapshot``, or one taken now and released on
        close)."""
        return MergedCursor(self, snapshot)

    def snapshot(self) -> ShardedSnapshot:
        """Pin one read point per shard under the cross-shard commit lock
        — the cut never splits a cross-shard batch (module docstring)."""
        with self._batch_lock:
            return ShardedSnapshot([s.snapshot() for s in self.shards])

    # -- maintenance / lifecycle ----------------------------------------
    def flush(self) -> None:
        """Per-shard durability barriers, fanned out."""
        self._fan([s.flush for s in self.shards])

    def wait_idle(self, compactions: bool = True, timeout: float = 120.0) -> None:
        for s in self.shards:
            s.wait_idle(compactions=compactions, timeout=timeout)

    def compact_all(self) -> None:
        self._fan([s.compact_all for s in self.shards])

    def gc_collect(self, threshold: float = 0.5) -> dict:
        """Run value GC on every shard; numeric stats summed across them."""
        reports = self._fan(
            [(lambda s=s: s.gc_collect(threshold=threshold)) for s in self.shards]
        )
        agg: dict = {}
        for rep in reports:
            for k, v in rep.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                agg[k] = agg.get(k, 0) + v
        agg["per_shard"] = reports
        return agg

    def checkpoint(self, directory: str) -> None:
        """Consistent online copy of the whole sharded store: per-shard
        online checkpoints under the cross-shard commit lock (the cut
        never splits a cross-shard batch; single-shard writes continue),
        then the ``ROUTER`` manifest — written last, via tmp+rename — as
        the commit marker. The image opens with ``ShardedDB.open(dir)``;
        no ``ROUTER_LOG`` is copied because under the lock nothing is
        uncommitted and each shard's checkpoint flushes first."""
        self.env.makedirs(directory)
        with self._batch_lock:
            self._fan(
                [
                    (lambda s=s, i=i: s.checkpoint(
                        os.path.join(directory, SHARD_DIR_FMT % i)
                    ))
                    for i, s in enumerate(self.shards)
                ]
            )
            self._write_manifest(os.path.join(directory, ROUTER_NAME))

    def stats(self) -> dict:
        """Aggregate + per-shard engine counters, plus router counters.

        ``aggregate`` sums every numeric counter across shards (ratios are
        recomputed from the summed inputs where that's meaningful:
        ``write_amp``, ``block_cache_hit_rate``); ``per_shard`` keeps the
        full per-engine dicts for tail analysis."""
        per = [s.stats() for s in self.shards]
        agg: dict = {}
        for p in per:
            for k, v in p.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                agg[k] = agg.get(k, 0) + v
        if agg.get("user_bytes"):
            agg["write_amp"] = agg.get("device_bytes", 0) / agg["user_bytes"]
        probes = agg.get("block_cache_hits", 0) + agg.get("block_cache_misses", 0)
        if probes:
            agg["block_cache_hit_rate"] = agg.get("block_cache_hits", 0) / probes
        return {
            "shards": len(per),
            "router": dict(self._router_stats),
            "router_log_bytes": self._log.size,
            "aggregate": agg,
            "per_shard": per,
        }

    def verify_integrity(self, fail_fast: bool = False) -> dict:
        """Inline scrub of every shard; counts summed, findings merged
        (each finding annotated with its shard index)."""
        report = {
            "shards": len(self.shards),
            "sst_files": 0,
            "blocks_verified": 0,
            "values_verified": 0,
            "corruptions": [],
            "findings": [],
            "per_shard": [],
        }
        for i, s in enumerate(self.shards):
            rep = s.verify_integrity(fail_fast=fail_fast)
            report["per_shard"].append(rep)
            for k in ("sst_files", "blocks_verified", "values_verified"):
                report[k] += rep.get(k, 0)
            report["corruptions"].extend(
                f"shard {i}: {c}" for c in rep.get("corruptions", ())
            )
            for f in rep.get("findings", ()):
                report["findings"].append({**f, "shard": i})
        return report

    def close(self, crash: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._fan([(lambda s=s: s.close(crash=crash)) for s in self.shards])
        finally:
            self._log.close()
            if self._pool is not None:
                self._pool.shutdown(wait=True)

    def __enter__(self) -> "ShardedDB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
