"""BValue garbage collection — a beyond-paper extension.

The paper describes no reclamation story for BValue files: overwritten or
deleted keys leave dead values behind forever (WiscKey/Titan both need GC;
BVLSM §III-C is silent). This module adds the standard vLog GC, adapted to
the multi-queue layout:

* ``DeadValueTracker`` — the write/compaction paths report superseded
  ValueOffsets (overwrite in MemTable, drop during compaction, delete);
  dead bytes are accumulated per BValue file.
* ``collect()`` — for every sealed file whose dead ratio ≥ threshold, scan
  the LIVE key space (the LSM tree is the source of truth), rewrite each
  live value through the normal multi-queue write path (getting a fresh
  ValueOffset), re-insert the Key-ValueOffset record, and delete the file.
  Crash-safe by construction: the old file is unlinked only after the
  re-pointed records are durable (same WAL-ordering argument as checkpoint
  commit), and a crash mid-GC leaves only duplicate live values, never
  missing ones.

Scheduling: GC normally runs as a low-priority job on the background
scheduler, triggered when a compaction pushes a sealed file past
``DBConfig.gc_dead_ratio_trigger`` (``gc_auto``). ``DB.gc_collect`` is the
synchronous wrapper over the same pass. Either way the rewrites draw from
the shared I/O token bucket at low priority (under the unified budget the
BValue dispatch itself inherits PRI_LOW from the GC context), and the pass
bails out between files when the DB is closing.

Pacing: an auto-scheduled pass is **sliced** — it rewrites at most
``DBConfig.gc_slice_bytes`` of live values, then returns its LOW thread to
the scheduler; the completion edge re-examines the dead ratios and queues
the next slice. A slice that stops mid-file simply leaves the file for the
next slice: already-moved keys no longer point into it, so resuming is a
plain re-scan (idempotent), and the file is only unlinked by the slice
that proves every live pointer has moved out. Candidates are served
deadest-first so each slice reclaims the most bytes per rewrite.
"""
from __future__ import annotations

import threading
from collections import defaultdict

from .errors import SnapshotUnstableError
from .ratelimiter import PRI_LOW
from .record import ValueOffset, kTypeValue, kTypeValuePtr


class DeadValueTracker:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.dead_bytes: dict[int, int] = defaultdict(int)
        self.total_bytes: dict[int, int] = defaultdict(int)

    def on_write(self, voff: ValueOffset) -> None:
        with self._lock:
            self.total_bytes[voff.file_id] += voff.size

    def on_dead(self, voff: ValueOffset) -> None:
        with self._lock:
            self.dead_bytes[voff.file_id] += voff.size

    def dead_ratio(self, file_id: int) -> float:
        with self._lock:
            total = self.total_bytes.get(file_id, 0)
            return self.dead_bytes.get(file_id, 0) / total if total else 0.0

    def candidates(self, threshold: float, exclude: set[int]) -> list[int]:
        with self._lock:
            out = []
            for fid, total in self.total_bytes.items():
                if fid in exclude or not total:
                    continue
                if self.dead_bytes.get(fid, 0) / total >= threshold:
                    out.append(fid)
            return out

    def forget(self, file_id: int) -> None:
        with self._lock:
            self.dead_bytes.pop(file_id, None)
            self.total_bytes.pop(file_id, None)

    def signature(self, fids) -> frozenset:
        """(fid, dead_bytes) fingerprint of a candidate set — dead bytes
        only grow, so ANY new death in these files changes the signature.
        The scheduler parks this after a zero-progress GC pass and re-arms
        as soon as it differs (new candidate OR more deaths in an old
        one), so a transiently uncollectable set is retried on the next
        real edge instead of being ignored forever."""
        with self._lock:
            return frozenset((fid, self.dead_bytes.get(fid, 0)) for fid in fids)


class BValueGC:
    def __init__(
        self, db, threshold: float = 0.5, max_rewrite_bytes: int = 0, resume=None
    ):
        self.db = db
        self.threshold = threshold
        # slice budget: stop the pass (without unlinking the current file)
        # once this many live bytes have been rewritten; 0 = unsliced
        self.max_rewrite_bytes = max_rewrite_bytes
        # work list carried over from a previous sliced pass — the live-key
        # scan is the dominant cost, so slices share ONE scan. Safe to
        # reuse because fresh ValueOffsets always land in active files (ids
        # never reused), so no NEW pointer can appear inside a sealed
        # candidate after the scan: a carried list is complete-modulo-
        # deaths, and every key is re-checked against the live pointer
        # before rewriting anyway.
        self.resume = resume
        self.resume_state = None  # (remaining candidate fids, live_ptrs)
        self.collected_files = 0
        self.reclaimed_bytes = 0
        self.rewritten_values = 0
        self.rewritten_bytes = 0
        self.sliced = False  # budget exhausted with work remaining
        self.snapshot_deferred = 0  # files kept alive for a live snapshot

    def _live_files(self) -> set[int]:
        """Files GC must not touch: the active append tails, plus any file
        quarantined for corruption (rewriting through it would read the bad
        bytes; the file stays on disk so its intact values keep serving)."""
        db = self.db
        return {q.file_id for q in db.bvalue.queues} | set(
            db.versions.quarantined_bvalues
        )

    def _stopping(self) -> bool:
        db = self.db
        return db._closed or db.bg._stopping

    def collect(self) -> dict:
        """One GC pass. Returns stats. Runs from a scheduler thread
        (``gc_auto``) or synchronously via ``DB.gc_collect``."""
        db = self.db
        cur = set(db.dead_tracker.candidates(self.threshold, exclude=self._live_files()))
        if self._stopping():
            return self._stats()
        cands: list[int] = []
        live_ptrs: dict[int, list[bytes]] = {}
        if self.resume is not None:
            # continue the previous slice's work list (files collected or
            # cleaned since then drop out of the current candidate set)
            r_cands, live_ptrs = self.resume
            cands = [fid for fid in r_cands if fid in cur]
        if not cands:
            if not cur:
                return self._stats()
            # deadest-first: a sliced pass spends its budget where each
            # rewritten byte reclaims the most dead ones
            cands = sorted(cur, key=db.dead_tracker.dead_ratio, reverse=True)
            # ONE scan over the live key space serves every candidate file
            # (and, via resume, every later slice): the LSM view is the
            # truth, so collect (key -> pointer) per candidate.
            live_ptrs = {fid: [] for fid in cands}
            for n, (key, _) in enumerate(db.range()):
                if (n & 1023) == 0 and self._stopping():
                    return self._stats()  # closing: don't finish an O(DB) walk
                rec = self._pointer_for(key)
                if rec is not None and rec.file_id in live_ptrs:
                    live_ptrs[rec.file_id].append(key)
        # GC rewrites re-enter the foreground put path from a background
        # thread: exempt them from the writer stall (the token bucket below
        # is their throttle) so they can't deadlock the low-priority pool.
        db._bg_local.exempt = True
        try:
            for ci, fid in enumerate(cands):
                if self._stopping():
                    break
                moved = 0
                file_clean = True  # every live pointer provably moved out
                for j, key in enumerate(live_ptrs[fid]):
                    if (j & 255) == 0 and self._stopping():
                        return self._stats()  # closing mid-file: the file
                        # is NOT unlinked, so bailing here loses nothing
                    # re-check: the pointer may have been superseded (or the
                    # key deleted) since the scan — only rewrite live ones
                    rec = self._pointer_for(key)
                    if rec is None or rec.file_id != fid:
                        continue
                    value = db.bvalue.get(rec)
                    # priority inheritance: when the commit below will
                    # itself dispatch this value through BValue (unified
                    # budget, WAL-time separation, value still over the
                    # threshold), that dispatch charges PRI_LOW on this
                    # thread — charging here too would pace the rewrite
                    # twice. Every other shape (budget not unified, flush
                    # separation where the dispatch happens later on the
                    # flush thread at FG priority, or a value now under
                    # the threshold) still pays the LOW toll here.
                    commit_charges_low = (
                        db.cfg.unified_io_budget
                        and db.cfg.separation_mode == "wal"
                        and len(value) >= db.cfg.value_threshold
                    )
                    if not commit_charges_low:
                        db.rate_limiter.request(len(key) + len(value), PRI_LOW)

                    # conditional re-insert (fresh ValueOffset via the
                    # normal separation path): the commit leader re-checks
                    # the pointer at seq-assignment time, so a concurrent
                    # foreground overwrite of `key` can never be shadowed
                    # by this resurrected old value
                    def _still_current(k=key, want=rec):
                        cur = self._pointer_for(k)
                        return (
                            cur is not None
                            and cur.file_id == want.file_id
                            and cur.offset == want.offset
                        )

                    if db._commit(
                        [(kTypeValue, key, value)], precondition=_still_current
                    ):
                        moved += 1
                        self.rewritten_bytes += len(value)
                        if (
                            self.max_rewrite_bytes
                            and self.rewritten_bytes >= self.max_rewrite_bytes
                        ):
                            # slice budget spent: yield the LOW thread and
                            # hand the remaining work list (this file
                            # included — moved keys skip on re-check) to
                            # the next slice, which resumes WITHOUT
                            # repeating the keyspace scan. The file is NOT
                            # unlinked: only a slice that walks its full
                            # key list may prove it clean.
                            self.sliced = True
                            self.rewritten_values += moved
                            self.resume_state = (cands[ci:], live_ptrs)
                            return self._stats()
                        continue
                    # skipped: a supersede is fine (the key's value lives
                    # elsewhere now), but a precondition that merely ERRORED
                    # leaves the pointer live in fid — unlinking then would
                    # orphan it. Fresh offsets are never reused, so "still
                    # points into fid" can only mean the error path.
                    try:
                        cur = self._pointer_for(key)
                    except RuntimeError:
                        cur = rec  # can't prove it moved: keep the file
                    if cur is not None and cur.file_id == fid:
                        file_clean = False
                if self._stopping():
                    break
                if not file_clean:
                    continue  # leave fid for a later, calmer pass
                # snapshot guard: a live snapshot older than this file's
                # rewrites can still resolve a key to a PRE-rewrite pointer
                # (the re-inserted record has a newer seq, invisible to it),
                # and compaction retains those older versions for exactly
                # that snapshot. Unlinking now would break its reads — defer
                # to a later pass. A snapshot taken after ``hwm`` sees only
                # the fresh pointers, so it never blocks reclamation.
                with db.mutex:
                    hwm = db._seq
                snaps = db.snapshot_seqs()
                if snaps and min(snaps) < hwm:
                    self.snapshot_deferred += 1
                    continue
                db.flush()
                path = db.bvalue.file_path(fid)
                try:
                    size = db.env.getsize(path)
                    db.env.unlink(path)
                except OSError:
                    size = 0
                db.bvalue.drop_reader(fid)
                db.dead_tracker.forget(fid)
                self.collected_files += 1
                self.reclaimed_bytes += size
                self.rewritten_values += moved
        finally:
            db._bg_local.exempt = False
        return self._stats()

    def _stats(self) -> dict:
        return {
            "collected_files": self.collected_files,
            "reclaimed_bytes": self.reclaimed_bytes,
            "rewritten_values": self.rewritten_values,
            "rewritten_bytes": self.rewritten_bytes,
            "sliced": self.sliced,
            "snapshot_deferred": self.snapshot_deferred,
        }

    def _pointer_for(self, key: bytes) -> ValueOffset | None:
        """Fetch the authoritative ValueOffset for `key` (or None). Like
        ``DB.get``, the version-snapshot walk races concurrent compaction
        (an input table can be unlinked mid-walk) — retry on a superseded
        snapshot instead of surfacing the torn read."""
        db = self.db
        for _attempt in range(8):
            with db.mutex:
                tables = [db.mem, *reversed(db.immutables)]
                version = db.versions.current
            for t in tables:
                found, type_, value = t.get(key)
                if found:
                    return ValueOffset.decode(value) if type_ == kTypeValuePtr else None
            try:
                for _lvl, fmeta in version.candidates_for_get(key):
                    found, _seq, type_, value = db.versions.reader(fmeta.file_no).get(key)
                    if found:
                        return ValueOffset.decode(value) if type_ == kTypeValuePtr else None
            except (OSError, ValueError):
                if db.versions.current is version:
                    raise  # stable snapshot: real I/O or corruption error
                continue  # snapshot superseded mid-walk — take a fresh one
            if db.versions.current is version or _attempt == 7:
                return None
        # every attempt died on a torn snapshot: treating that as "no live
        # pointer" would let collect() unlink a file without rewriting this
        # key — surface the instability instead (the pass retries later)
        raise SnapshotUnstableError("GC could not obtain a stable version snapshot")
