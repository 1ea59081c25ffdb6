"""BValue store — the paper's multi-queue parallel big-value log (§III-C).

Each *queue* owns a dedicated append-only BValue file and (in async mode) a
dedicated writer thread: the userspace realization of "one NVMe submission
queue per BValue file" (see DESIGN.md §3 for the hardware-adaptation note).
Offsets are **reserved synchronously** at dispatch time — this is what makes
WAL-time separation possible: the ``ValueOffset`` must be known before the
Key-ValueOffset record is appended to the WAL.

Write modes:

* ``put_sync``  — caller pwrites at its reserved offset and fsyncs before
  returning (WAL-enabled strong-consistency path: value durable before the
  WAL record that references it). Concurrent callers on different queues
  proceed in parallel (pwrite/fsync release the GIL).
* ``put_async`` — reservation returns immediately; the queue's writer thread
  batches contiguous runs to page multiples, pwrites, fsyncs, then unpins
  the corresponding BVCache entries (which held the only copy meanwhile).

``put_many`` is the group-commit fan-out: a WriteBatch's big values are
dispatched across all queues in one call, and in sync mode each queue pays
ONE fsync for its whole share of the batch instead of one per value.

File descriptors are tracked per file-id with a reservation refcount: a
queue may roll to a new file while older reservations are still being
written, so the old file's fd stays open (and is fsynced+closed) only once
every reservation against it has completed — a pwrite can never land in the
wrong file.

Dispatch across queues is round-robin or least-loaded (pending bytes),
matching the paper's "hash or round-robin" scheduler.

Unified I/O budget: when the manager is built with a ``limiter`` (see
:mod:`.ratelimiter`), every dispatched value charges the shared token
bucket at reservation time on the *caller's* thread, at the priority
``io_priority()`` reports for that caller — foreground puts charge
``PRI_FG`` (accounted, never blocked), while a GC rewrite re-entering
this path inherits ``PRI_LOW`` and genuinely waits (priority
inheritance). Charging at dispatch rather than persist time keeps the
accounting identical for the sync and async write modes.
"""
from __future__ import annotations

import os
import queue
import threading
import zlib
from dataclasses import dataclass

from .env import DEFAULT_ENV
from .errors import CorruptionError
from .record import ValueOffset

_SENTINEL = object()


@dataclass(slots=True)
class _Pending:
    file_id: int
    offset: int
    value: bytes
    key: bytes  # for BVCache unpin on completion


class _BValueQueue:
    """One writer queue bound to one (rolling) BValue file."""

    def __init__(self, mgr: "BValueManager", qid: int):
        self.mgr = mgr
        self.qid = qid
        self.file_id = mgr._alloc_file_id(qid)
        self.tail = 0
        self.pending_bytes = 0
        self._pending_items = 0  # async reservations not yet persisted
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        # file_id -> (fd, outstanding reservation count); the active file and
        # any rolled-away file with reservations still in flight.
        self._fds: dict[int, int] = {self.file_id: self._open(self.file_id)}
        self._refs: dict[int, int] = {self.file_id: 0}
        self._q: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        if mgr.async_writes:
            self._thread = threading.Thread(
                target=self._writer_loop, name=f"bvalue-q{qid}", daemon=True
            )
            self._thread.start()

    def _open(self, file_id: int) -> int:
        path = self.mgr.file_path(file_id)
        return self.mgr.env.open_fd(path, os.O_WRONLY | os.O_CREAT, 0o644)

    def reserve(self, size: int) -> tuple[int, int]:
        """Reserve [offset, offset+size) — returns (file_id, offset). The
        reservation holds a reference on the file's fd until the matching
        write completes (see _release)."""
        close_fd = None
        with self._lock:
            if self.tail + size > self.mgr.max_file_bytes and self.tail > 0:
                old = self.file_id
                if self._refs.get(old, 0) == 0:
                    close_fd = self._fds.pop(old)
                    del self._refs[old]
                # else: writes against `old` are still in flight — its fd is
                # closed by _release when the last one completes.
                self.file_id = self.mgr._alloc_file_id(self.qid)
                self._fds[self.file_id] = self._open(self.file_id)
                self._refs[self.file_id] = 0
                self.tail = 0
            off = self.tail
            self.tail += size
            self._refs[self.file_id] += 1
            file_id = self.file_id
        if close_fd is not None:
            self.mgr.env.fsync(close_fd)
            self.mgr.env.close_fd(close_fd)
        return file_id, off

    def _fd_for(self, file_id: int) -> int:
        with self._lock:
            return self._fds[file_id]

    def _release(self, file_id: int) -> None:
        """A reservation against file_id completed (data already fsynced by
        the write path); close rolled-away files once fully drained."""
        close_fd = None
        with self._lock:
            self._refs[file_id] -= 1
            if self._refs[file_id] == 0 and file_id != self.file_id:
                close_fd = self._fds.pop(file_id)
                del self._refs[file_id]
        if close_fd is not None:
            self.mgr.env.close_fd(close_fd)

    # -- sync path ------------------------------------------------------
    def write_sync(self, file_id: int, offset: int, value: bytes) -> None:
        fd = self._fd_for(file_id)
        self.mgr.env.pwrite(fd, value, offset)
        self.mgr.env.fsync(fd)
        self.mgr._account(len(value), fsyncs=1)
        self._release(file_id)

    def _persist_resvs(self, resvs: list[tuple[int, int, bytes]]) -> int:
        """Shared sync/async persistence: coalesce in-order reservations
        [(file_id, offset, value)] into contiguous pwrite runs, fsync each
        distinct file ONCE, account, and release every reservation. Returns
        the number of bytes written."""
        runs: list[list[tuple[int, int, bytes]]] = [[resvs[0]]]
        for r in resvs[1:]:
            last = runs[-1][-1]
            if r[0] == last[0] and r[1] == last[1] + len(last[2]):
                runs[-1].append(r)
            else:
                runs.append([r])
        total = 0
        touched: dict[int, int] = {}
        for run in runs:
            fid = run[0][0]
            fd = touched.get(fid)
            if fd is None:
                fd = touched[fid] = self._fd_for(fid)
            blob = b"".join(v for _, _, v in run)
            self.mgr.env.pwrite(fd, blob, run[0][1])
            total += len(blob)
        for fd in touched.values():
            self.mgr.env.fsync(fd)
        self.mgr._account(total, fsyncs=len(touched))
        for fid, _, _ in resvs:
            self._release(fid)
        return total

    def write_sync_many(self, resvs: list[tuple[int, int, bytes]]) -> None:
        """Persist many reservations with one fsync per distinct file — the
        group-commit amortization for the durable big-value path. resvs must
        be in reservation order (consecutive reserve() calls)."""
        if resvs:
            self._persist_resvs(resvs)

    # -- async path -------------------------------------------------------
    def submit(self, item: _Pending) -> None:
        with self._lock:
            self.pending_bytes += len(item.value)
            self._pending_items += 1
        self._q.put(item)

    def wait_drained(self, timeout: float | None = None) -> bool:
        """Barrier: block until every submitted async write has been
        persisted (condition-variable signalled by the writer thread)."""
        with self._lock:
            return self._drained.wait_for(lambda: self._pending_items == 0, timeout=timeout)

    def _writer_loop(self) -> None:
        import time

        gather_s = self.mgr.gather_window_s
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            batch = [item]
            nbytes = len(item.value)
            # "aggregate small-to-medium writes into full pages": gather
            # within a short window so a slow producer still yields large
            # batches — one fsync per BATCH, not per value (the paper's
            # async page-aligned submission).
            deadline = time.monotonic() + gather_s
            while nbytes < self.mgr.batch_bytes:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    self._flush_batch(batch)
                    return
                batch.append(nxt)
                nbytes += len(nxt.value)
            self._flush_batch(batch)

    def _flush_batch(self, batch: list[_Pending]) -> None:
        if not batch:
            return
        total = self._persist_resvs([(p.file_id, p.offset, p.value) for p in batch])
        # unpin callbacks BEFORE signalling the drain barrier: wait_drained()
        # returning must mean the batch is persisted AND its cache entries
        # are unpinned.
        if self.mgr.on_persisted_many is not None:
            self.mgr.on_persisted_many(
                [(p.key, ValueOffset(p.file_id, p.offset, len(p.value))) for p in batch]
            )
        elif self.mgr.on_persisted is not None:
            for p in batch:
                self.mgr.on_persisted(p.key, ValueOffset(p.file_id, p.offset, len(p.value)))
        with self._lock:
            self.pending_bytes -= total
            self._pending_items -= len(batch)
            if self._pending_items == 0:
                self._drained.notify_all()

    def drain(self) -> None:
        if self._thread is not None:
            self._q.put(_SENTINEL)
            self._thread.join(timeout=30)
            self._thread = None

    def close(self) -> None:
        self.drain()
        with self._lock:
            fds = list(self._fds.values())
            self._fds.clear()
            self._refs.clear()
        for fd in fds:
            try:
                self.mgr.env.fsync(fd)
            except OSError:
                pass
            self.mgr.env.close_fd(fd)


class BValueManager:
    """Dispatches separated big values across N parallel queues."""

    def __init__(
        self,
        directory: str,
        num_queues: int = 4,
        async_writes: bool = True,
        dispatch: str = "round_robin",
        page_size: int = 4096,
        batch_bytes: int = 1 << 18,
        max_file_bytes: int = 256 << 20,
        gather_window_s: float = 0.02,
        stats=None,
        on_persisted=None,
        on_persisted_many=None,
        next_file_id: int = 0,
        limiter=None,
        io_priority=None,
        env=None,
    ):
        assert dispatch in ("round_robin", "least_loaded")
        self.dir = directory
        self.env = env or DEFAULT_ENV
        self.env.makedirs(directory)
        self.async_writes = async_writes
        self.dispatch = dispatch
        self.page_size = page_size
        self.batch_bytes = batch_bytes
        self.max_file_bytes = max_file_bytes
        self.gather_window_s = gather_window_s
        self.stats = stats
        # unified device budget: charge the shared token bucket at dispatch
        # time, at the priority the calling context reports (None = no
        # charging — the pre-unification background-only model)
        self.limiter = limiter
        self.io_priority = io_priority
        self.on_persisted = on_persisted
        self.on_persisted_many = on_persisted_many
        self._file_lock = threading.Lock()
        self._next_file_id = next_file_id
        self._rr = 0
        self.queues = [_BValueQueue(self, q) for q in range(num_queues)]
        self._read_fds: dict[int, int] = {}
        self._read_lock = threading.Lock()

    # -- file naming / ids --------------------------------------------------
    def file_path(self, file_id: int) -> str:
        return os.path.join(self.dir, f"bv_{file_id:06d}.val")

    def _alloc_file_id(self, qid: int) -> int:
        with self._file_lock:
            fid = self._next_file_id
            self._next_file_id += 1
            return fid

    def _account(self, n: int, fsyncs: int = 0) -> None:
        if self.stats:
            self.stats.add("bvalue_bytes", n)
            if fsyncs:
                self.stats.add("bvalue_fsyncs", fsyncs)

    # -- write path -----------------------------------------------------------
    def _pick_queue(self) -> _BValueQueue:
        if self.dispatch == "least_loaded":
            return min(self.queues, key=lambda q: q.pending_bytes)
        q = self.queues[self._rr % len(self.queues)]
        self._rr += 1
        return q

    def _charge(self, nbytes: int) -> None:
        if self.limiter is not None and self.limiter.enabled and nbytes > 0:
            pri = self.io_priority() if self.io_priority is not None else None
            if pri is not None:
                self.limiter.request(nbytes, pri)

    def put(self, key: bytes, value: bytes, sync: bool) -> ValueOffset:
        self._charge(len(value))
        q = self._pick_queue()
        file_id, off = q.reserve(len(value))
        voff = ValueOffset(file_id, off, len(value), zlib.crc32(value) & 0xFFFFFFFF)
        if sync or not self.async_writes:
            q.write_sync(file_id, off, value)
        else:
            q.submit(_Pending(file_id, off, value, key))
        return voff

    def put_many(
        self, items: list[tuple[bytes, bytes]], sync: bool, on_reserved=None
    ) -> list[ValueOffset]:
        """Batched fan-out for group commit: dispatch a WriteBatch's big
        values across all queues, then persist each queue's share with one
        fsync (sync mode) or one submission run (async mode). Returns the
        ValueOffsets in input order.

        ``on_reserved(key, voff, value)`` fires per item BEFORE anything is
        handed to a writer thread — the DB uses it to insert pinned BVCache
        entries so the persist-completion unpin can never race ahead of the
        insert."""
        self._charge(sum(len(v) for _, v in items))
        voffs: list[ValueOffset] = []
        per_q: dict[int, list[tuple[int, int, bytes, bytes]]] = {}
        for key, value in items:
            q = self._pick_queue()
            file_id, off = q.reserve(len(value))
            voff = ValueOffset(file_id, off, len(value), zlib.crc32(value) & 0xFFFFFFFF)
            voffs.append(voff)
            if on_reserved is not None:
                on_reserved(key, voff, value)
            per_q.setdefault(q.qid, []).append((file_id, off, value, key))
        durable = sync or not self.async_writes
        for qid, resvs in per_q.items():
            q = self.queues[qid]
            if durable:
                q.write_sync_many([(fid, off, val) for fid, off, val, _ in resvs])
            else:
                for fid, off, val, key in resvs:
                    q.submit(_Pending(fid, off, val, key))
        return voffs

    # -- read path ------------------------------------------------------------
    def get(self, voff: ValueOffset, verify: bool = False) -> bytes:
        fd = self._reader_fd(voff.file_id)
        buf = self.env.pread(fd, voff.size, voff.offset)
        if len(buf) != voff.size:
            # short read ≠ corruption: it's a truncation/roll race and is
            # retryable (plain IOError, classified transient)
            raise IOError(
                f"short BValue read: file {voff.file_id} off {voff.offset} "
                f"want {voff.size} got {len(buf)}"
            )
        if verify and voff.crc and (zlib.crc32(buf) & 0xFFFFFFFF) != voff.crc:
            raise CorruptionError(
                f"BValue CRC mismatch at file {voff.file_id}+{voff.offset}",
                bvalue_file_id=voff.file_id,
                path=self.file_path(voff.file_id),
            )
        return buf

    def drop_reader(self, file_id: int) -> None:
        with self._read_lock:
            fd = self._read_fds.pop(file_id, None)
            if fd is not None:
                self.env.close_fd(fd)

    def _reader_fd(self, file_id: int) -> int:
        with self._read_lock:
            fd = self._read_fds.get(file_id)
            if fd is None:
                fd = self.env.open_fd(self.file_path(file_id), os.O_RDONLY)
                self._read_fds[file_id] = fd
            return fd

    # -- lifecycle -------------------------------------------------------------
    def flush(self, timeout: float = 120.0) -> None:
        """Barrier: wait for all pending async writes to hit disk."""
        for q in self.queues:
            if not q.wait_drained(timeout=timeout):
                raise TimeoutError(f"BValue queue {q.qid} did not drain in {timeout}s")

    def seal_active(self, force: bool = False) -> None:
        """Roll every queue with a non-empty active file to a fresh one.

        Checkpoints hard-link BValue files, and a link shares the inode —
        an active append tail must never be linked, or the checkpoint's
        copy would keep growing underneath it. Sealing first makes every
        existing file immutable from this point on (the same roll
        ``reserve`` performs at the size cap; in-flight reservations keep
        the old fd open until they drain).

        ``force=True`` also rolls queues whose active file is still empty.
        Replica promotion needs this: a replica's idle queue files can
        share ids with value files mirrored from the old primary, and an
        append at the queue's (zero) tail would overwrite mirrored bytes —
        after bumping the allocator past the mirrored id space, a forced
        roll moves every queue onto a guaranteed-fresh file."""
        for q in self.queues:
            close_fd = None
            with q._lock:
                if q.tail == 0 and not force:
                    continue  # empty active file: nothing to seal
                sealed_nonempty = q.tail > 0
                old = q.file_id
                if q._refs.get(old, 0) == 0:
                    close_fd = q._fds.pop(old)
                    del q._refs[old]
                q.file_id = self._alloc_file_id(q.qid)
                q._fds[q.file_id] = q._open(q.file_id)
                q._refs[q.file_id] = 0
                q.tail = 0
            if close_fd is not None:
                if sealed_nonempty:
                    self.env.fsync(close_fd)
                self.env.close_fd(close_fd)

    def ensure_next_file_id(self, n: int) -> None:
        """Raise the id allocator floor to at least ``n`` (promotion: never
        allocate an id the old primary already used for a mirrored file)."""
        with self._file_lock:
            if n > self._next_file_id:
                self._next_file_id = n

    @property
    def next_file_id(self) -> int:
        with self._file_lock:
            return self._next_file_id

    def close(self) -> None:
        for q in self.queues:
            q.close()
        with self._read_lock:
            for fd in self._read_fds.values():
                self.env.close_fd(fd)
            self._read_fds.clear()
