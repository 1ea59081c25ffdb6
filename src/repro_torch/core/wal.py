"""Write-Ahead Log with the three durability modes the paper benchmarks.

* ``sync``  — every append is followed by ``fsync`` (strict durability;
  workloads R-WS / S-WS).
* ``async`` — appends buffer in memory and a background flusher writes +
  fsyncs in batches (R-WA / S-WA). Acknowledged writes may be lost on crash
  up to the flush interval, exactly like RocksDB's WAL-async mode.
* ``off``   — handled at the DB layer (no WAL object at all; R-WO / S-WO).

Group commit rides on :meth:`WALWriter.append_many`: the DB's write-group
leader hands over every queued batch's payload at once, and the whole group
costs a single ``write`` + (sync mode) a single ``fsync``. Each payload keeps
its own CRC frame (:mod:`.record`), so replay-atomicity remains per-batch:
a torn tail drops whole batches, never partial ones.

Pipelined commit (write pipeline v2)
------------------------------------

Concurrent group leaders overlap their commits through a **ticket
barrier**: the DB reserves a ticket per group *in sequence order* (under
its mutex, via :meth:`reserve`), then each leader calls ``append_many``
concurrently. Frame encoding runs with no lock at all; the file ``write``
runs under the barrier strictly in ticket order, so the WAL byte stream is
always a seq-ordered prefix — recovery can never observe group N+1 without
group N (no commit-order hole). The ``fsync`` runs *outside* the barrier:
while leader N's fsync is in flight, leader N+1 is already encoding and
writing. Because appends are file-ordered, any fsync issued after ticket
T's write also covers every ticket ≤ T — at most one fsync runs at a time,
and leaders that pile up behind it ride the next one instead of issuing
their own (``wal_fsync_skips``).

Records are CRC-framed (:mod:`.record`); replay stops at the first torn or
corrupt record.
"""
from __future__ import annotations

import threading

import os

from .env import DEFAULT_ENV
from .record import (
    decode_varint,
    frame_records,
    iter_framed_records,
    iter_framed_records_ex,
)


class WALWriter:
    def __init__(
        self,
        path: str,
        mode: str = "sync",
        flush_interval_s: float = 0.05,
        flush_bytes: int = 1 << 20,
        stats=None,
        env=None,
    ):
        assert mode in ("sync", "async")
        self.path = path
        self.mode = mode
        self._env = env or DEFAULT_ENV
        self._f = self._env.open(path, "ab", buffering=0)
        self._stats = stats
        self._closed = False
        # ticket barrier state (sync + async: file/buffer order must match
        # sequence order for hole-free replay)
        self._order_lock = threading.Lock()
        self._order_cv = threading.Condition(self._order_lock)
        self._next_ticket = 0  # next ticket to hand out
        self._next_write = 0  # ticket whose write may proceed
        self._synced = -1  # highest ticket covered by a completed fsync
        self._sync_in_flight = False  # one fsync at a time; laters piggyback
        self._poisoned = False  # a write failed: the tail may be torn
        if mode == "async":
            self._buf: list[bytes] = []
            self._buf_bytes = 0
            self._flush_bytes = flush_bytes
            self._interval = flush_interval_s
            self._lock = threading.Lock()
            self._wake = threading.Event()
            self._thread = threading.Thread(target=self._flusher, name="wal-flusher", daemon=True)
            self._thread.start()

    # -- public api -------------------------------------------------------
    def reserve(self) -> int:
        """Hand out the next write-order ticket.

        The caller (the DB's group-commit leader) MUST call this in commit
        sequence order — i.e. while holding the lock under which it assigned
        the group's sequence numbers — or the file order would diverge from
        the sequence order.
        """
        with self._order_lock:
            t = self._next_ticket
            self._next_ticket += 1
            return t

    def append(self, payload: bytes) -> None:
        """Persist one record (self-ordered: reserves its own ticket)."""
        self.append_many([payload])

    def append_many(self, payloads, ticket: int | None = None) -> None:
        """Group commit: persist many framed records with ONE write (and in
        sync mode at most one fsync) — the durability barrier is paid per
        group, and skipped entirely when a later-started fsync already
        covers this ticket.

        With ``ticket`` (from :meth:`reserve`) the write waits its turn at
        the ticket barrier; without one the call is self-ordered (reserve +
        append under the same breath — the non-pipelined path).
        """
        if not payloads:
            return
        if ticket is None:
            ticket = self.reserve()
        self.write_many(payloads, ticket)
        self.sync_ticket(ticket)

    def write_many(self, payloads, ticket: int) -> None:
        """Stage 1 of a pipelined append: frame (lock-free) + ordered file
        write. NOT durable yet in sync mode — follow with
        :meth:`sync_ticket`. The split lets the DB's commit leader hand the
        writer queue off between the write and the fsync, so the next
        group forms and encodes while this one's fsync is in flight."""
        try:
            blob = frame_records(payloads)  # encode OUTSIDE any lock
        except BaseException:
            self.abort_ticket(ticket)  # or every later ticket deadlocks
            raise
        if self.mode == "sync":
            self._write_ordered(ticket, blob, len(payloads))
        else:
            self._buffer_ordered(ticket, blob, len(payloads))

    def abort_ticket(self, ticket: int) -> None:
        """Consume a reserved ticket without writing (the caller failed
        before reaching the barrier). MUST be called for any reserved
        ticket that will never be written, or the barrier deadlocks."""
        with self._order_cv:
            while self._next_write != ticket:
                self._order_cv.wait()
            self._next_write = ticket + 1
            self._order_cv.notify_all()

    def sync_ticket(self, ticket: int) -> None:
        """Stage 2: make ``ticket`` durable (sync mode; async buffers are
        flushed by the background flusher on its own clock)."""
        if self.mode == "sync":
            self._sync_cover(ticket)

    def flush(self) -> None:
        """Force buffered records to disk (async mode barrier)."""
        if self.mode == "async":
            self._drain()
        else:
            self._env.fsync(self._f)

    def close(self, drop_buffered: bool = False) -> None:
        """drop_buffered=True simulates a crash with unflushed async buffer."""
        if self._closed:
            return
        self._closed = True
        if self.mode == "async":
            if drop_buffered:
                with self._lock:
                    self._buf.clear()
                    self._buf_bytes = 0
            self._wake.set()
            self._thread.join(timeout=5)
            if not drop_buffered:
                self._drain()
        self._f.close()

    # -- internals ----------------------------------------------------------
    def _write_ordered(self, ticket: int, blob: bytes, nrecords: int) -> None:
        """File write strictly in ticket order (the sequence barrier)."""
        with self._order_cv:
            while self._next_write != ticket:
                self._order_cv.wait()
            try:
                if self._poisoned:
                    # an earlier write failed: the file may end in a torn
                    # record, and replay stops there — appending past it
                    # would ack writes that can never be recovered.
                    raise IOError(f"WAL {self.path} poisoned by an earlier failed write")
                self._f.write(blob)
            except BaseException:
                self._poisoned = True
                raise
            finally:
                # advance even on a failed write: later tickets must not
                # deadlock (they fail fast on the poison flag instead)
                self._next_write = ticket + 1
                self._order_cv.notify_all()
            if self._stats:
                self._stats.add("wal_bytes", len(blob))
                self._stats.add("wal_records", nrecords)

    def _sync_cover(self, ticket: int) -> None:
        """fsync OUTSIDE the write barrier — overlaps the next leader's
        encode+write. At most one fsync is in flight; a group that arrives
        while one is running waits for it, then re-checks: because appends
        are file-ordered, an fsync started after ticket T's write durably
        covers every ticket ≤ T, so piled-up groups ride the next fsync
        instead of issuing their own (``wal_fsync_skips``)."""
        with self._order_cv:
            while True:
                if self._synced >= ticket:
                    if self._stats:
                        self._stats.add("wal_fsync_skips")
                    return
                if not self._sync_in_flight:
                    self._sync_in_flight = True
                    covered = self._next_write - 1  # everything written so far
                    break
                self._order_cv.wait()
        try:
            self._env.fsync(self._f)
        finally:
            with self._order_cv:
                self._sync_in_flight = False
                if covered > self._synced:
                    self._synced = covered
                self._order_cv.notify_all()
        if self._stats:
            self._stats.add("wal_fsyncs")

    def _buffer_ordered(self, ticket: int, blob: bytes, nrecords: int) -> None:
        # async mode: the buffer append takes the ticket barrier too, so the
        # flusher writes groups in sequence order (hole-free replay).
        with self._order_cv:
            while self._next_write != ticket:
                self._order_cv.wait()
            try:
                with self._lock:
                    self._buf.append(blob)
                    self._buf_bytes += len(blob)
                    if self._stats:
                        self._stats.add("wal_records", nrecords)
                    if self._buf_bytes >= self._flush_bytes:
                        self._wake.set()
            finally:
                self._next_write = ticket + 1
                self._order_cv.notify_all()

    def _drain(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
            self._buf_bytes = 0
        if buf:
            blob = b"".join(buf)
            self._f.write(blob)
            self._env.fsync(self._f)
            if self._stats:
                self._stats.add("wal_bytes", len(blob))
                self._stats.add("wal_fsyncs")

    def _flusher(self) -> None:
        while not self._closed:
            self._wake.wait(timeout=self._interval)
            self._wake.clear()
            if self._closed:
                return
            self._drain()


def replay_wal(path: str, env=None):
    """Yield payloads of intact records from a WAL file."""
    env = env or DEFAULT_ENV
    if not env.exists(path):
        return
    with env.open(path, "rb") as f:
        buf = f.read()
    yield from iter_framed_records(buf)


class WALSegmentReader:
    """Tail-following reader over a DB directory's WAL segments
    (``wal_NNNNNN.log``), used by replication catch-up: a lagging follower
    reads the primary's durable log directly and applies every committed
    group it missed over the wire.

    Segments are visited in wal-number order (= append order; each
    segment's sequence numbers are a contiguous continuation of the
    previous one's thanks to the ticket barrier). The reader is stateful:
    it remembers a byte offset per segment, so repeated :meth:`read_new`
    calls only parse bytes appended since the last call — including bytes
    appended to a segment that was previously read to its (then) end.
    Torn or corrupt frames stop the scan of that segment at that point;
    the caller's seq-contiguity check decides whether what follows is a
    real gap."""

    def __init__(self, directory: str, env=None):
        self.dir = directory
        self._env = env or DEFAULT_ENV
        self._offsets: dict[str, int] = {}

    def reset(self) -> None:
        self._offsets.clear()

    def _segments(self) -> list[str]:
        try:
            names = self._env.listdir(self.dir)
        except OSError:
            return []
        segs = [n for n in names if n.startswith("wal_") and n.endswith(".log")]
        segs.sort()  # zero-padded wal numbers: lexical == numeric order
        return segs

    def read_new(self):
        """Yield ``(seq, payload)`` for every intact record appended since
        the last call, across all segments in order. Deleted segments are
        forgotten; new ones are picked up automatically."""
        segs = self._segments()
        live = set(segs)
        for tracked in list(self._offsets):
            if tracked not in live:
                del self._offsets[tracked]
        for name in segs:
            start = self._offsets.get(name, 0)
            path = os.path.join(self.dir, name)
            try:
                with self._env.open(path, "rb") as f:
                    if start:
                        f.seek(start)
                    buf = f.read()
            except OSError:
                continue
            if not buf:
                continue
            consumed = 0
            for payload, end in iter_framed_records_ex(buf):
                consumed = end
                try:
                    seq, _ = decode_varint(payload, 0)
                except (IndexError, ValueError):
                    break
                yield seq, payload
            self._offsets[name] = start + consumed
