"""Manifest: versioned level metadata + edit log (RocksDB MANIFEST analogue).

A *Version* is the immutable set of live SSTables per level. Mutations are
*VersionEdits* appended to a CRC-framed msgpack log; recovery replays the
log. Tracked alongside the file layout: ``last_seq``, ``next_file_no``, and
``bvalue_next_file_id`` so BValue files never collide across restarts.
"""
from __future__ import annotations

import os
import threading

from repro_torch import _msgpack as msgpack

from .env import DEFAULT_ENV
from .record import frame_record, iter_framed_records
from .sstable import FileMetadata, SSTableReader, table_path

MANIFEST_NAME = "MANIFEST"


class Version:
    """Immutable snapshot of the LSM level structure."""

    __slots__ = ("levels", "_level_bytes")

    def __init__(self, num_levels: int, levels=None):
        self.levels: list[list[FileMetadata]] = (
            levels if levels is not None else [[] for _ in range(num_levels)]
        )
        self._level_bytes: list[int] | None = None

    def clone(self) -> "Version":
        return Version(len(self.levels), [list(lv) for lv in self.levels])

    def level_bytes(self, level: int) -> int:
        # memoized on first read: a Version is immutable once installed
        # (clones are only mutated before publication), and the write path
        # consults level sizes on every commit — O(levels), not O(files)
        cache = self._level_bytes
        if cache is None:
            cache = [sum(f.size for f in lv) for lv in self.levels]
            self._level_bytes = cache
        return cache[level]

    def files_touching(self, level: int, smallest: bytes, largest: bytes):
        files = self.levels[level]
        if level == 0:
            # L0 is ordered by age, not key — linear scan is the only option
            return [f for f in files if f.largest >= smallest and f.smallest <= largest]
        # sorted levels are key-disjoint and ordered by smallest (so also by
        # largest): binary-search the first candidate, extend while touching
        # — overlap-ratio picking calls this per file per pick, so O(log n +
        # overlap) instead of O(level) matters
        lo, hi = 0, len(files)
        while lo < hi:
            mid = (lo + hi) // 2
            if files[mid].largest < smallest:
                lo = mid + 1
            else:
                hi = mid
        out = []
        for f in files[lo:]:
            if f.smallest > largest:
                break
            out.append(f)
        return out

    def overlap_bytes(self, level: int, smallest: bytes, largest: bytes) -> int:
        """Total size of the files in ``level`` whose key range touches
        [smallest, largest] — the bytes a compaction of that range would
        have to rewrite at (or a trivial move would park on top of) this
        level. Used by overlap-ratio picking and the grandparent checks."""
        return sum(f.size for f in self.files_touching(level, smallest, largest))

    def files_from(self, level: int, start: bytes):
        """Files in a SORTED level (L1+) that may hold keys >= ``start``,
        in key order — binary search for the first candidate, so a lazy
        concatenating scan iterator does no per-file work up front."""
        files = self.levels[level]
        lo, hi = 0, len(files)
        while lo < hi:
            mid = (lo + hi) // 2
            if files[mid].largest < start:
                lo = mid + 1
            else:
                hi = mid
        return files[lo:]

    def candidates_for_get(self, key: bytes):
        """Yield (level, FileMetadata) newest-first for a point lookup.

        Sorted-level file ranges are disjoint in their POINT keys, but the
        bounds are extended by range-tombstone spans, which clip exactly at
        a neighbour's first key — two files can *touch* on one key. Yield
        every touching file (at most two), in order: the earlier file holds
        the newer versions when a key sits on a table boundary."""
        # L0 files may overlap — newest first (we append newest at index 0).
        for f in self.levels[0]:
            if f.smallest <= key <= f.largest:
                yield 0, f
        for level in range(1, len(self.levels)):
            files = self.levels[level]
            lo, hi = 0, len(files)
            while lo < hi:  # first file with largest >= key
                mid = (lo + hi) // 2
                if files[mid].largest < key:
                    lo = mid + 1
                else:
                    hi = mid
            for f in files[lo:]:
                if f.smallest > key:
                    break
                yield level, f


class VersionSet:
    def __init__(self, directory: str, num_levels: int, block_cache=None, env=None, paranoid=False):
        self.dir = directory
        self.num_levels = num_levels
        # shared decoded-block cache handed to every SSTableReader (None =
        # caching disabled); owned by the DB, shared with gets/scans/compaction
        self.block_cache = block_cache
        self.env = env or DEFAULT_ENV
        self.paranoid = paranoid
        self.current = Version(num_levels)
        self.last_seq = 0
        self.next_file_no = 1
        self.bvalue_next_file_id = 0
        # files a CRC-verified read found corrupt: still in the levels (their
        # intact blocks keep serving reads) but excluded from compaction
        # picking and, for value files, from GC — the damage is contained
        # instead of being rewritten downstream or crashing jobs forever.
        self.quarantined: set[int] = set()
        self.quarantined_bvalues: set[int] = set()
        self._manifest = None
        self._lock = threading.Lock()
        self._readers: dict[int, SSTableReader] = {}
        self._retired: list[SSTableReader] = []  # dropped, close-deferred
        # -- cursor pinning ------------------------------------------------
        # while pins > 0 (open cursors/checkpoints), readers dropped by
        # compaction PARK instead of retiring (still resolvable via
        # ``reader()``) and input unlinks are deferred — a lazy merged scan
        # may open a cold input file minutes after the compaction that
        # replaced it committed.
        self._pins = 0
        self._parked: dict[int, SSTableReader] = {}
        self._deferred_unlinks: list[str] = []
        self.compaction_ptr: dict[int, bytes] = {}
        # per-file compaction locks: a file is locked from pick time until
        # its job's manifest edit commits, so concurrent compaction jobs
        # can never claim overlapping inputs (and a locked file is only
        # ever deleted by the job holding its lock).
        self._compacting: set[int] = set()

    # -- manifest log -----------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, MANIFEST_NAME)

    def open(self) -> None:
        path = self._manifest_path()
        if self.env.exists(path):
            with self.env.open(path, "rb") as f:
                buf = f.read()
            for payload in iter_framed_records(buf):
                self._apply(msgpack.unpackb(payload))
        self._sweep_orphans()
        self._manifest = self.env.open(path, "ab", buffering=0)

    def _sweep_orphans(self) -> None:
        """Delete .sst files not referenced by any level — the outputs of a
        flush/compaction (or individual subcompaction shards) that crashed
        before its atomic manifest edit. Also bumps ``next_file_no`` past
        every on-disk table so a recovered counter can never collide."""
        live = {f.file_no for lv in self.current.levels for f in lv}
        for name in self.env.listdir(self.dir):
            if not name.endswith(".sst"):
                continue
            try:
                no = int(name[: -len(".sst")])
            except ValueError:
                continue
            self.next_file_no = max(self.next_file_no, no + 1)
            if no not in live:
                try:
                    self.env.unlink(os.path.join(self.dir, name))
                except OSError:
                    pass

    def _apply(self, edit: dict) -> None:
        v = self.current.clone()
        for level, meta in edit.get(b"add", edit.get("add", [])):
            fm = FileMetadata.from_wire(meta)
            if level == 0:
                v.levels[level].insert(0, fm)  # newest first
            else:
                v.levels[level].append(fm)
                v.levels[level].sort(key=lambda f: f.smallest)
        for level, file_no in edit.get(b"delete", edit.get("delete", [])):
            v.levels[level] = [f for f in v.levels[level] if f.file_no != file_no]
            self.quarantined.discard(file_no)
        self.current = v
        for kind, ident in edit.get(b"quarantine", edit.get("quarantine", [])):
            kind = kind.decode() if isinstance(kind, bytes) else kind
            if kind == "sst":
                self.quarantined.add(ident)
            elif kind == "bvalue":
                self.quarantined_bvalues.add(ident)
        for k_raw in (b"last_seq", "last_seq"):
            if k_raw in edit:
                self.last_seq = max(self.last_seq, edit[k_raw])
        for k_raw in (b"next_file_no", "next_file_no"):
            if k_raw in edit:
                self.next_file_no = max(self.next_file_no, edit[k_raw])
        for k_raw in (b"bvalue_next_file_id", "bvalue_next_file_id"):
            if k_raw in edit:
                self.bvalue_next_file_id = max(self.bvalue_next_file_id, edit[k_raw])

    def log_and_apply(self, edit: dict) -> None:
        with self._lock:
            edit.setdefault("next_file_no", self.next_file_no)
            payload = msgpack.packb(edit, use_bin_type=True)
            self._manifest.write(frame_record(payload))
            self.env.fsync(self._manifest)
            self._apply(edit)

    # -- quarantine -------------------------------------------------------
    def quarantine(self, kind: str, ident: int) -> bool:
        """Mark a corrupt file so pick/GC skip it. Durable via a manifest
        edit when possible; if even the manifest write fails, the mark is
        kept in memory (better to run degraded now and rediscover the
        corruption after a restart than to crash). Returns False when the
        file was already quarantined (nothing new to handle)."""
        with self._lock:
            already = (
                ident in self.quarantined
                if kind == "sst"
                else ident in self.quarantined_bvalues
            )
        if already:
            return False
        try:
            self.log_and_apply({"quarantine": [(kind, ident)]})
        except OSError:
            with self._lock:
                if kind == "sst":
                    self.quarantined.add(ident)
                else:
                    self.quarantined_bvalues.add(ident)
        return True

    def quarantined_files(self) -> set[int]:
        with self._lock:
            return set(self.quarantined)

    # -- file number / reader management -------------------------------------
    def new_file_no(self) -> int:
        with self._lock:
            no = self.next_file_no
            self.next_file_no += 1
            return no

    def try_lock_files(self, file_nos) -> bool:
        """Atomically acquire the compaction lock on every file in
        ``file_nos`` — all or nothing. Returns False if any is held."""
        with self._lock:
            if any(no in self._compacting for no in file_nos):
                return False
            self._compacting.update(file_nos)
            return True

    def unlock_files(self, file_nos) -> None:
        with self._lock:
            self._compacting.difference_update(file_nos)

    def locked_files(self) -> set[int]:
        with self._lock:
            return set(self._compacting)

    def pin(self) -> None:
        """A cursor (or checkpoint) is walking the current version: park
        dropped readers and defer input unlinks until every pin releases."""
        with self._lock:
            self._pins += 1

    def pin_current(self):
        """Atomically pin AND return the current version. The two must be
        one critical section: a compaction edit + input unlink between a
        ``current`` read and the pin() would hand the caller a version
        whose files are already gone. (A pin landing between an edit and
        its input unlink merely defers that unlink — conservative, cleaned
        up at unpin.) Pair with :meth:`unpin`."""
        with self._lock:
            self._pins += 1
            return self.current

    def unpin(self) -> None:
        with self._lock:
            self._pins -= 1
            if self._pins > 0:
                return
            to_unlink = self._deferred_unlinks
            self._deferred_unlinks = []
            # parked readers join the normal close-deferred retirement
            self._retired.extend(self._parked.values())
            self._parked.clear()
            to_close = self._retired[:-32] if len(self._retired) > 64 else []
            if to_close:
                self._retired = self._retired[-32:]
        for path in to_unlink:
            try:
                self.env.unlink(path)
            except OSError:
                pass  # rediscovered by the next open's orphan sweep
        for r in to_close:
            r.close()

    def defer_or_unlink(self, path: str) -> None:
        """Unlink a replaced input table now — or, while cursors hold pins,
        after the last pin releases (the file stays openable meanwhile)."""
        with self._lock:
            if self._pins > 0:
                self._deferred_unlinks.append(path)
                return
        self.env.unlink(path)

    def reader(self, file_no: int) -> SSTableReader:
        with self._lock:
            r = self._readers.get(file_no)
            if r is None:
                r = self._parked.get(file_no)
        if r is not None:
            return r
        # construct OUTSIDE the lock (opens the file + loads its index);
        # on a race the loser's never-shared reader is closed immediately
        r = SSTableReader(
            table_path(self.dir, file_no), file_no, self.block_cache,
            env=self.env, paranoid=self.paranoid,
        )
        with self._lock:
            existing = self._readers.get(file_no)
            if existing is None:
                self._readers[file_no] = r
                return r
        r.close()
        return existing

    def drop_reader(self, file_no: int) -> None:
        # Don't close immediately: a get() walking a just-superseded version
        # snapshot may still pread() this reader, and closing would free the
        # fd for reuse (a concurrent pread would then silently read some
        # OTHER file). Retire it instead and close a stale batch once enough
        # pile up — any in-flight lookup is long done by then.
        with self._lock:
            r = self._readers.pop(file_no, None)
            if r is None:
                return
            if self._pins > 0:
                # an open cursor may still reach this file through its
                # pinned version — keep it resolvable until unpin
                self._parked[file_no] = r
                return
            self._retired.append(r)
            to_close = self._retired[:-32] if len(self._retired) > 64 else []
            if to_close:
                self._retired = self._retired[-32:]
        for r in to_close:
            r.close()
        if self.block_cache is not None:
            # file numbers are never reused, so stale blocks could only
            # waste capacity — reclaim them eagerly anyway
            self.block_cache.evict_file(file_no)

    def close(self) -> None:
        if self._manifest is not None:
            self._manifest.close()
        for r in self._readers.values():
            r.close()
        self._readers.clear()
        for r in self._parked.values():
            r.close()
        self._parked.clear()
        for r in self._retired:
            r.close()
        self._retired.clear()
