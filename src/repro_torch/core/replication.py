"""Primary/replica WAL shipping: follower apply, bootstrap, promotion.

The replication unit is the committed WAL group — exactly the payloads the
group-commit leader just persisted (BVLSM makes this cheap: big values are
already separated into immutable-once-sealed BValue files, so only the
lightweight key/pointer stream ships in order; the follower pulls value
bytes out of band and drops them at the *same* ``(file_id, offset)``, which
keeps every shipped ValueOffset valid verbatim).

Shape of the system::

    primary._lead_group_locked (publish, seq order)
        └─ Replicator.on_group ── frame ──► Env.ship(stream, wire)
                                                  │ (FaultInjectionEnv may
                                                  │  drop/dup/reorder/corrupt)
                                  Follower.enqueue ◄─ InProcessTransport
                                      │ (scheduler: single-flight repl job)
                                  Follower.drain
                                      ├─ mirror separated values (pread from
                                      │  primary, pwrite + fsync locally;
                                      │  a miss stops the apply there)
                                      ├─ append payloads to own WAL
                                      └─ memtable apply at the shipped seq

* **Ordering/dedup** — frames carry contiguous ``(seq, payload)`` runs. The
  follower applies only ``applied+1``-contiguous runs; stale frames are
  duplicates (dropped), future frames buffer until a WAL **catch-up**
  (:class:`~.wal.WALSegmentReader` over the primary's durable segments)
  bridges the gap. The primary *retains* flushed WAL segments until every
  registered follower has acked past them, so a catch-up can always find
  the missing groups.
* **Value before pointer** — a streaming follower applies a group only
  once every value it points at is mirrored and fsynced. An async
  primary ships a pointer before its value writer has necessarily landed
  the bytes; the follower then stops at that group and retries it on a
  later drain, so its own WAL never holds a pointer into a hole (a hole
  there would outlive a crash of the replica, silently). Only the
  promotion's final catch-up applies past a miss: the dead primary's
  missing values are the promote-time dangling-pointer drop's problem.
* **Divergence detection** — the primary folds a rolling CRC over each run
  of ``repl_crc_interval`` consecutive payloads and ships the digest with a
  later frame; the follower folds the same CRC over what it actually
  applied. A mismatch means the streams forked (a flip the frame CRC
  missed, an apply bug, a lost-and-refetched group that differed): the
  follower stops applying and flags ``needs_rebootstrap`` instead of
  silently serving forked data.
* **Bootstrap** — :func:`bootstrap_replica` materializes a checkpoint image
  (optionally incremental against the previous image) and opens it as a
  replica; :func:`attach` registers the follower *before* reading its
  position so WAL retention covers the catch-up window with no gap.
* **Promotion** — :meth:`DB.promote` seals the stream, replays whatever
  suffix survives in the dead primary's durable WAL (in sync mode that is
  every acked write), discards non-contiguous buffered frames, moves the
  BValue id allocator past the mirrored id space, and flips the write
  latch. Idempotent.
"""
from __future__ import annotations

import os
import shutil
import threading
import zlib

from repro_torch import _msgpack as msgpack

from .record import (
    ValueOffset,
    decode_entries,
    frame_record,
    iter_framed_records,
    kTypeValuePtr,
)
from .wal import WALSegmentReader


def _run_of(seq: int, interval: int) -> int:
    return (seq - 1) // interval


class InProcessTransport:
    """Delivers framed batches primary → follower, routing every send
    through the *primary's* ``Env.ship`` hook — a ``FaultInjectionEnv``
    there can drop, duplicate, reorder, or corrupt frames in flight, and a
    simulated primary crash severs the stream (a dead machine cannot
    send)."""

    def __init__(self, env, stream: str):
        self._env = env
        self.stream = stream
        self._deliver = None

    def connect(self, deliver) -> None:
        self._deliver = deliver

    def send(self, wire: bytes) -> None:
        for frame in self._env.ship(self.stream, wire):
            deliver = self._deliver
            if deliver is not None:
                deliver(frame)

    def close(self) -> None:
        self._deliver = None


class Replicator:
    """Primary-side stream state: ships publish-ordered groups to every
    registered follower, tracks acks, and retains flushed WAL segments
    needed for follower catch-up."""

    def __init__(self, db):
        self.db = db
        self._lock = threading.Lock()
        self._sinks: dict[str, InProcessTransport] = {}
        self._acked: dict[str, int] = {}
        self._retained: list[tuple[int, str]] = []  # (last_seq, wal path)
        # rolling divergence CRC: current run index + folded crc, plus
        # completed-run digests waiting to ride the next frame out
        self._run: int | None = None
        self._run_crc = 0
        self._pending_checks: list[tuple[int, int]] = []
        self.shipped_seq = 0

    # -- membership ------------------------------------------------------
    def register(self, follower_id: str, transport: InProcessTransport, acked: int) -> None:
        with self._lock:
            self._sinks[follower_id] = transport
            self._acked[follower_id] = acked

    def unregister(self, follower_id: str) -> None:
        with self._lock:
            sink = self._sinks.pop(follower_id, None)
            self._acked.pop(follower_id, None)
        if sink is not None:
            sink.close()
        self._prune_retained()

    @property
    def active(self) -> bool:
        return bool(self._sinks)

    # -- WAL retention ---------------------------------------------------
    def min_acked(self) -> int:
        with self._lock:
            if not self._acked:
                return 1 << 62
            return min(self._acked.values())

    def should_retain(self, last_seq: int) -> bool:
        return self.min_acked() < last_seq

    def retain_wal(self, path: str, last_seq: int) -> None:
        with self._lock:
            self._retained.append((last_seq, path))
        self.db.stats.add("repl_wals_retained")

    def _prune_retained(self) -> None:
        floor = self.min_acked()
        drop: list[str] = []
        with self._lock:
            keep = []
            for last_seq, path in self._retained:
                if last_seq > floor:
                    keep.append((last_seq, path))
                else:
                    drop.append(path)
            self._retained = keep
        for path in drop:
            try:
                self.db.env.unlink(path)
            except OSError:
                pass

    def ack(self, follower_id: str, seq: int) -> None:
        with self._lock:
            if follower_id not in self._acked:
                return
            if seq > self._acked[follower_id]:
                self._acked[follower_id] = seq
        self._prune_retained()
        self.db.stats.set_gauge("repl_min_acked_seq", self.min_acked())

    # -- shipping --------------------------------------------------------
    def on_group(self, batches: list[tuple[int, bytes]]) -> None:
        """Called by the publish stage, under the DB mutex, strictly in
        sequence order. Folds the divergence CRC, frames the group (split
        at ``repl_batch_bytes``), and ships to every sink. Never raises:
        replication failure must not fail the client write."""
        cfg = self.db.cfg
        interval = max(1, cfg.repl_crc_interval)
        cap = max(1, cfg.repl_batch_bytes)
        frames: list[bytes] = []
        with self._lock:
            if not self._sinks:
                return
            chunk: list[tuple[int, bytes]] = []
            chunk_bytes = 0

            def _flush_chunk():
                nonlocal chunk, chunk_bytes
                if not chunk:
                    return
                checks, self._pending_checks = self._pending_checks, []
                msg = {"b": chunk, "c": checks}
                frames.append(frame_record(msgpack.packb(msg, use_bin_type=True)))
                chunk = []
                chunk_bytes = 0

            for seq, payload in batches:
                run = _run_of(seq, interval)
                if self._run is None:
                    self._run = run
                if run != self._run:
                    self._pending_checks.append((self._run, self._run_crc))
                    self._run, self._run_crc = run, 0
                self._run_crc = zlib.crc32(payload, self._run_crc) & 0xFFFFFFFF
                self.shipped_seq = seq
                if chunk_bytes + len(payload) > cap:
                    _flush_chunk()
                chunk.append((seq, payload))
                chunk_bytes += len(payload)
            _flush_chunk()
            sinks = list(self._sinks.values())
        stats = self.db.stats
        for wire in frames:
            stats.add("repl_bytes_shipped", len(wire))
            for sink in sinks:
                try:
                    sink.send(wire)
                except Exception:
                    stats.add("repl_ship_errors")
        stats.add("repl_batches_shipped", len(batches))
        stats.set_gauge("repl_shipped_seq", self.shipped_seq)

    def close(self) -> None:
        for follower_id in list(self._sinks):
            self.unregister(follower_id)


class Follower:
    """Replica-side stream state: frame inbox, ordered apply (value mirror
    → local WAL → memtable), gap catch-up from the primary's durable WAL,
    and rolling-CRC divergence checks."""

    #: buffered out-of-order frames beyond this are dropped — catch-up
    #: re-reads them from the primary's WAL anyway
    MAX_PENDING = 64
    #: completed CRC runs kept around waiting for the primary's digest
    MAX_RUNS = 64

    def __init__(self, db, primary_path: str, primary_env=None):
        self.db = db
        self.primary_path = primary_path
        # reads of the primary's files (WAL catch-up, value fetch) go
        # through the *replica's* env: they are this machine's I/O, and a
        # crashed primary's disk stays readable
        self._penv = primary_env or db.env
        self._reader = WALSegmentReader(primary_path, env=self._penv)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._drain_lock = threading.Lock()  # one drain at a time; seal joins it
        self._inbox: list[bytes] = []
        self._pending: dict[int, list[tuple[int, bytes]]] = {}  # first_seq -> run
        self._dirty = False
        self.sealed = False
        self.diverged = False
        self.needs_rebootstrap = False
        self.last_shipped_seen = db._seq
        # divergence CRC state: run -> folded crc for runs we applied, and
        # run -> expected crc received from the primary. Runs that started
        # before our bootstrap point were only partially observed — never
        # checkable.
        self._runs: dict[int, int] = {}
        self._expected: dict[int, int] = {}
        self._check_floor = db._seq  # can check run r iff floor <= r*interval
        self._last_gap: int | None = None
        self.on_applied = None  # ack callback, set by attach()
        self._mirror_read_fds: dict[int, int] = {}
        self._mirror_write_fds: dict[int, int] = {}
        self.max_mirrored_file = -1
        # a streaming apply stopped at a value the primary has not landed
        # yet (wait_caught_up re-drives the drain while this is set)
        self._value_stall = False
        # values the promotion's final catch-up could not fetch: retried
        # once more before the stream closes (see seal)
        self._miss_retry: dict[tuple[int, int], ValueOffset] = {}

    # -- transport-facing -------------------------------------------------
    def enqueue(self, wire: bytes) -> None:
        with self._lock:
            if self.sealed or self.diverged:
                return
            self._inbox.append(wire)
            self._dirty = True
        self.db.bg.maybe_schedule_repl()

    def nudge(self) -> None:
        """Mark work pending (e.g. the stream went quiet after a dropped
        tail frame) so the next drain runs a catch-up read."""
        with self._lock:
            self._dirty = True
        self.db.bg.maybe_schedule_repl()

    def has_work(self) -> bool:
        with self._lock:
            return self._dirty and not self.sealed and not self.diverged

    @property
    def applied_seq(self) -> int:
        return self.db._seq

    @property
    def lag(self) -> int:
        return max(0, self.last_shipped_seen - self.db._seq)

    # -- apply loop (scheduler job) ---------------------------------------
    def drain(self) -> None:
        with self._drain_lock:
            while True:
                with self._lock:
                    self._dirty = False
                    frames, self._inbox = self._inbox, []
                    if self.sealed or self.diverged:
                        return
                for wire in frames:
                    self._ingest(wire)
                progressed = self._apply_ready()
                if not progressed and self._gapped():
                    self._catch_up()
                    self._apply_ready()
                self._retry_misses()
                with self._lock:
                    self._cv.notify_all()
                    if not self._dirty:
                        return

    def _gapped(self) -> bool:
        with self._lock:
            if self._pending:
                return True
        return self.last_shipped_seen > self.db._seq

    def _ingest(self, wire: bytes) -> None:
        stats = self.db.stats
        payloads = list(iter_framed_records(wire))
        if len(payloads) != 1:
            stats.add("repl_frames_corrupt")  # frame CRC caught a flip
            return
        try:
            msg = msgpack.unpackb(payloads[0], raw=False)
            batches = [(int(s), bytes(p)) for s, p in msg["b"]]
            checks = [(int(r), int(c)) for r, c in msg.get("c", ())]
        except Exception:
            stats.add("repl_frames_corrupt")
            return
        with self._lock:
            for run, crc in checks:
                self._expected[run] = crc
        interval = max(1, self.db.cfg.repl_crc_interval)
        # digests may describe runs we already applied — check them now
        self._check_completed_runs(interval)
        if not batches:
            return
        first, last = batches[0][0], batches[-1][0]
        if last <= self.db._seq:
            stats.add("repl_frames_duplicate")
            return
        with self._lock:
            self.last_shipped_seen = max(self.last_shipped_seen, last)
            if first in self._pending and self._pending[first][-1][0] >= last:
                stats.add("repl_frames_duplicate")
                return
            self._pending[first] = batches
            if len(self._pending) > self.MAX_PENDING:
                # drop the farthest-future run: catch-up re-reads it from
                # the primary's (retained) WAL
                del self._pending[max(self._pending)]

    def _apply_ready(self) -> bool:
        """Apply every buffered run that is contiguous with the applied
        sequence. Returns True if anything was applied."""
        progressed = False
        while True:
            applied = self.db._seq
            run = None
            with self._lock:
                for first in sorted(self._pending):
                    if first > applied + 1:
                        break
                    run = self._pending.pop(first)
                    if run[-1][0] > applied:
                        break
                    run = None  # fully stale: keep scanning
            if run is None:
                return progressed
            run = [(s, p) for s, p in run if s > applied]
            done = self._apply_batches(run)
            progressed |= done > 0
            if done < len(run):
                # stopped at a value not yet on the primary's disk: the
                # rest waits for a later drain
                with self._lock:
                    first = run[done][0]
                    if first not in self._pending or self._pending[first][-1][0] < run[-1][0]:
                        self._pending[first] = run[done:]
                return progressed

    def _apply_batches(self, batches: list[tuple[int, bytes]]) -> int:
        """Apply contiguous ``(seq, payload)`` groups: mirror separated
        values first (fsynced — the same value-before-pointer durability
        barrier the primary's sync mode pays), then the local WAL append,
        then the memtable at the shipped sequence numbers. A streaming
        apply stops before the first group with a value it could not
        mirror and make durable. Returns how many groups it applied."""
        if not batches:
            return 0
        db = self.db
        cfg = db.cfg
        interval = max(1, cfg.repl_crc_interval)
        decoded = []
        touched: set[int] = set()
        stalled = False
        for seq, payload in batches:
            pseq, entries = decode_entries(payload)
            if pseq != seq:
                # header/frame mismatch — treat as corruption, force catch-up
                db.stats.add("repl_frames_corrupt")
                return 0
            ok = True
            for type_, _key, value in entries:
                if type_ == kTypeValuePtr:
                    ok &= self._mirror_value(ValueOffset.decode(value), touched)
            if not ok and not self.sealed:
                stalled = True
                break
            decoded.append((seq, payload, entries))
        for fd in touched:
            try:
                db.env.fsync(fd)
            except OSError:
                if not self.sealed:
                    # the mirrored bytes may not survive a crash: no
                    # pointer to them goes into the WAL
                    decoded, stalled = [], True
        self._value_stall = stalled
        if not decoded:
            return 0
        wal = db.wal
        if wal is not None:
            wal.append_many([p for _s, p, _e in decoded])
        with db.mutex:
            retain = max(db._snapshots) if db._snapshots else None
            for seq, payload, entries in decoded:
                if seq != db._seq + 1:
                    continue  # raced a concurrent applier (shouldn't happen)
                prevs = db.mem.add_batch(seq, entries, retain_from=retain)
                for prev in prevs:
                    if prev[1] == kTypeValuePtr:
                        db.dead_tracker.on_dead(ValueOffset.decode(prev[2]))
                db._seq = seq
                run = _run_of(seq, interval)
                with self._lock:
                    self._runs[run] = zlib.crc32(payload, self._runs.get(run, 0)) & 0xFFFFFFFF
            if (
                db.mem.approximate_size >= cfg.memtable_size
                and not db._pending
                # during the promote-time final catch-up the memtable must
                # NOT flush: promote probes it for dangling pointers
                # (values the dead primary never made durable) after the
                # replay, and a flush would bake them into an SSTable
                and not self.sealed
            ):
                db._rotate_memtable_locked()
        self._check_completed_runs(interval)
        db.stats.add("repl_batches_applied", len(batches))
        lag = self.lag
        db.stats.set_gauge("repl_lag_seqs", lag)
        db.stats.set_gauge("repl_applied_seq", db._seq)
        if lag > cfg.repl_lag_warn_seqs:
            db.stats.add("repl_lag_warnings")
        cb = self.on_applied
        if cb is not None:
            try:
                cb(db._seq)
            except Exception:
                pass
        return len(decoded)

    def _mirror_value(self, voff: ValueOffset, touched: set[int]) -> bool:
        if self._mirror_once(voff, touched):
            return True
        # fetch failed (typically: an async primary's value-writer thread
        # has not landed the bytes yet). Streaming, the apply stops here
        # and the group is retried whole; in the promotion's final
        # catch-up the record is kept and the fetch retried once more in
        # seal, reads of it falling back like any dangling pointer
        self.db.stats.add("repl_value_fetch_misses")
        if self.sealed and len(self._miss_retry) < 4096:
            self._miss_retry[(voff.file_id, voff.offset)] = voff
        return False

    def _mirror_once(self, voff: ValueOffset, touched: set[int]) -> bool:
        db = self.db
        name = f"bv_{voff.file_id:06d}.val"
        try:
            rfd = self._mirror_read_fds.get(voff.file_id)
            if rfd is None:
                src = os.path.join(self.primary_path, "bvalue", name)
                rfd = self._penv.open_fd(src, os.O_RDONLY)
                self._mirror_read_fds[voff.file_id] = rfd
            data = self._penv.pread(rfd, voff.size, voff.offset)
            if len(data) != voff.size or (zlib.crc32(data) & 0xFFFFFFFF) != voff.crc:
                raise IOError(f"short/corrupt value read from primary {name}")
            wfd = self._mirror_write_fds.get(voff.file_id)
            if wfd is None:
                dst = db.bvalue.file_path(voff.file_id)
                wfd = db.env.open_fd(dst, os.O_RDWR | os.O_CREAT, 0o644)
                self._mirror_write_fds[voff.file_id] = wfd
            db.env.pwrite(wfd, data, voff.offset)
            touched.add(wfd)
            self.max_mirrored_file = max(self.max_mirrored_file, voff.file_id)
            return True
        except OSError:
            return False

    def _retry_misses(self) -> None:
        if not self._miss_retry:
            return
        touched: set[int] = set()
        for key, voff in list(self._miss_retry.items()):
            if self._mirror_once(voff, touched):
                del self._miss_retry[key]
        for fd in touched:
            try:
                self.db.env.fsync(fd)
            except OSError:
                pass

    # -- catch-up ---------------------------------------------------------
    def _catch_up(self) -> None:
        """Bridge a gap by reading the primary's durable WAL segments
        directly. Applies every contiguous group past our position; a hole
        *below* what the segments still hold means the primary deleted
        logs we never saw (possible only when retention wasn't active for
        us) — that forces a re-bootstrap."""
        db = self.db
        batch: list[tuple[int, bytes]] = []
        gap_seen = False
        stalled = False
        # The live primary's WAL file shows written-but-unsynced bytes; a
        # group whose fsync is about to fail must never reach the replica.
        # Publish (and therefore ship) happens after the sync-mode fsync,
        # so last_shipped_seen is a durability floor — cap streaming
        # catch-up there. A sealed (promotion) catch-up reads to the end:
        # the primary is dead and its unsynced tail is already gone.
        cap = None if self.sealed else self.last_shipped_seen
        try:
            for seq, payload in self._reader.read_new():
                if cap is not None and seq > cap:
                    break
                expect = db._seq + len(batch) + 1
                if seq < expect:
                    continue  # already applied / duplicate in older segment
                if seq > expect:
                    # hole inside the durable stream we can observe: either
                    # mid-catch-up corruption or a deleted segment
                    gap_seen = True
                    break
                batch.append((seq, payload))
                if len(batch) >= 128:
                    stalled = self._apply_batches(batch) < len(batch)
                    batch = []
                    if stalled:
                        break
        except OSError:
            db.stats.add("repl_catchup_errors")
        if batch and not stalled:
            stalled = self._apply_batches(batch) < len(batch)
        if stalled:
            # the groups past the stall were read but not applied: read
            # the segments again from the start next time
            self._reader.reset()
        db.stats.add("repl_catchups")
        if gap_seen and self.last_shipped_seen > db._seq:
            # A hole in the durable stream cannot be filled by future
            # frames (everything shipped is in the WAL first), but a
            # reordered frame still in flight could cover it — flag only
            # when a SECOND catch-up finds the same hole unmoved.
            hole = db._seq + 1
            with self._lock:
                if self._last_gap == hole:
                    self.needs_rebootstrap = True
                self._last_gap = hole
        else:
            with self._lock:
                self._last_gap = None

    # -- divergence -------------------------------------------------------
    def _check_completed_runs(self, interval: int) -> None:
        db = self.db
        applied = db._seq
        mismatched = None
        with self._lock:
            horizon = _run_of(max(1, applied), interval) - self.MAX_RUNS
            for run in sorted(self._expected):
                if applied < (run + 1) * interval:
                    break  # run not fully applied yet
                expected = self._expected.pop(run)
                # keep the local fold (popping it would turn a duplicated
                # digest frame — re-check of an already-checked run — into
                # a local=None false divergence); eviction below bounds it
                local = self._runs.get(run)
                if self._check_floor > run * interval:
                    continue  # partially observed (bootstrap mid-run)
                if run < horizon:
                    continue  # local fold already evicted — unknowable
                db.stats.add("repl_crc_checks")
                if local != expected:
                    mismatched = run
                    break
            # bound memory: forget runs far behind the applied frontier
            for d in (self._runs, self._expected):
                for run in [r for r in d if r < horizon]:
                    del d[run]
            if mismatched is not None:
                self.diverged = True
                self.needs_rebootstrap = True
                self._cv.notify_all()
        if mismatched is not None:
            db.stats.add("repl_divergence_detected")

    # -- lifecycle --------------------------------------------------------
    def wait_caught_up(self, target_seq: int, timeout: float = 30.0) -> bool:
        """Block until the applied sequence reaches ``target_seq`` (True),
        or the follower seals/diverges or the timeout passes (False)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while True:
            with self._lock:
                if self.db._seq >= target_seq and not self._miss_retry:
                    return True
                if self.sealed or self.diverged:
                    return False
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=min(remaining, 0.05))
                stalled = self._value_stall
            if stalled:
                # no frame may come to re-drive a stalled apply
                self.nudge()

    def seal(self, final_catch_up: bool = True) -> None:
        """Stop the stream: no further frames are accepted or applied.
        With ``final_catch_up`` (promotion), first replay whatever suffix
        survives in the primary's durable WAL; buffered non-contiguous
        frames — the unacked suffix — are discarded."""
        with self._lock:
            self.sealed = True
        # join any in-flight drain, then run the final catch-up with the
        # drain lock held so nothing else can interleave
        with self._drain_lock:
            if final_catch_up and not self.diverged:
                self._apply_ready()
                self._catch_up()
                self._apply_ready()
                # last chance to fill mirror holes while the primary's
                # disk is still readable; still-missing values are the
                # promote-time dangling-pointer drop's problem
                self._retry_misses()
            with self._lock:
                self._inbox.clear()
                self._pending.clear()
                self._cv.notify_all()
        self.close_fds()

    def close_fds(self) -> None:
        for fds, env in (
            (self._mirror_read_fds, self._penv),
            (self._mirror_write_fds, self.db.env),
        ):
            for fd in fds.values():
                try:
                    env.close_fd(fd)
                except OSError:
                    pass
            fds.clear()


class ReplicationLink:
    """One primary→replica attachment (see :func:`attach`)."""

    def __init__(self, primary, replica, transport, follower, follower_id):
        self.primary = primary
        self.replica = replica
        self.transport = transport
        self.follower = follower
        self.follower_id = follower_id

    def wait_caught_up(self, timeout: float = 30.0) -> bool:
        return self.follower.wait_caught_up(self.primary._seq, timeout=timeout)

    def nudge(self) -> None:
        # advertise the primary's position: a fully-dead wire (every frame
        # dropped) never advances last_shipped_seen, so the follower would
        # otherwise see no gap and skip the catch-up read
        f = self.follower
        with f._lock:
            f.last_shipped_seen = max(f.last_shipped_seen, self.primary._seq)
        f.nudge()

    @property
    def lag(self) -> int:
        return max(0, self.primary._seq - self.replica._seq)

    def detach(self) -> None:
        repl = self.primary._repl
        if repl is not None:
            repl.unregister(self.follower_id)
        self.follower.seal(final_catch_up=False)
        if self.replica._follower is self.follower:
            self.replica._follower = None

    def rebootstrap(self, keep_base: bool = True):
        """Tear the replica down and rebuild it from a fresh checkpoint of
        the primary (the divergence/hole recovery path). With ``keep_base``
        the old image serves as the incremental-checkpoint base, so only
        files the old image lacks are re-materialized. Returns the new
        replica DB (also stored on ``self.replica``)."""
        old = self.replica
        path, cfg = old.path, old.cfg
        self.detach()
        old.close()
        base_dir = path + ".rebase"
        if os.path.exists(base_dir):
            shutil.rmtree(base_dir)
        os.rename(path, base_dir)
        # the old store's SSTables carry the REPLICA's file numbering —
        # its own flushes can collide with primary file numbers, so only
        # the (id-space-mirrored) value files are usable as a base
        for name in os.listdir(base_dir):
            if name.endswith(".sst"):
                os.unlink(os.path.join(base_dir, name))
        try:
            # hardlink=False: the image lives in the replica's failure
            # domain; base links are fine (the old image is replica-local)
            self.primary.checkpoint(
                path, base=base_dir if keep_base else None, hardlink=False
            )
        except BaseException:
            shutil.rmtree(path, ignore_errors=True)
            os.rename(base_dir, path)
            raise
        shutil.rmtree(base_dir, ignore_errors=True)
        new = type(old)(path, cfg, role="replica")
        self.primary.stats.add("repl_rebootstraps")
        link = attach(self.primary, new, follower_id=self.follower_id)
        self.replica = new
        self.transport = link.transport
        self.follower = link.follower
        return new


def attach(primary, replica, transport=None, follower_id=None) -> ReplicationLink:
    """Wire a live stream from ``primary`` to ``replica``.

    Registration order matters: the follower's position is registered
    (activating WAL retention) *before* the initial catch-up computes what
    it missed, so the primary cannot delete a segment in the window."""
    if getattr(replica, "_role", "primary") != "replica":
        raise ValueError("attach: target DB was not opened with role='replica'")
    fid = follower_id or replica.path
    if transport is None:
        transport = InProcessTransport(primary.env, f"repl://{fid}")
    if primary._repl is None:
        primary._repl = Replicator(primary)
    follower = Follower(replica, primary.path, primary_env=replica.env)
    replica._follower = follower
    primary._repl.register(fid, transport, acked=replica._seq)
    repl = primary._repl
    follower.on_applied = lambda seq: repl.ack(fid, seq)
    # everything the primary committed so far is catch-up work, even if no
    # frame ever announces it (the stream may stay quiet from here on)
    follower.last_shipped_seen = max(follower.last_shipped_seen, primary._seq)
    transport.connect(follower.enqueue)
    link = ReplicationLink(primary, replica, transport, follower, fid)
    # initial catch-up: anything committed between checkpoint and attach
    follower.nudge()
    return link


def bootstrap_replica(primary, path: str, cfg=None, base: str | None = None):
    """Materialize a checkpoint of ``primary`` at ``path`` and open it as a
    replica DB (caller attaches it next). ``base`` makes the checkpoint
    incremental against a previous image. Files are *copied*, not
    hard-linked: the replica writes into its value files (mirroring) and
    must not share inodes with the live primary."""
    from .config import DBConfig

    if cfg is None:
        cfg = DBConfig()
    primary.checkpoint(path, base=base, hardlink=False)
    db_cls = type(primary)
    return db_cls(path, cfg, role="replica")
