"""Pluggable filesystem Env + FaultInjectionEnv (RocksDB FaultInjectionTestFS-style).

Every file operation the engine performs — WAL appends, value-queue pwrites,
SSTable writes, manifest appends, recovery listdir/unlink — goes through
``DBConfig.env`` instead of calling ``open``/``os.*`` directly. The default
:class:`Env` is a zero-overhead passthrough; :class:`FaultInjectionEnv`
layers three test capabilities on top without the engine knowing:

* **rule-based faults** — inject an errno (or arbitrary exception) by
  operation kind, path substring, Nth-occurrence countdown, or probability
  (:meth:`add_fault`). An ``errno.ENOSPC`` rule on ``write``/``sync`` is a
  faithful disk-full simulation.
* **simulated crashes** — :meth:`set_crash_after` arms a countdown; once it
  fires, every mutating op raises :class:`SimulatedCrashError` ("the machine
  died"), and :meth:`drop_unsynced` then rewinds every tracked file to its
  last-fsynced state: appends past the synced size are truncated, overwrites
  of previously-synced bytes are undone from a per-write undo log. This is
  what lets the crash harness kill the engine at *any* write edge and check
  that reopen honors exactly the acknowledged-sync prefix.
* **corruption** — :meth:`corrupt` flips bytes at a file offset to exercise
  CRC verification and quarantine paths.

Metadata ops (``rename``/``unlink``) are applied immediately and treated as
durable — the engine always fsyncs outputs before unlinking inputs, so
dropping unsynced *data* is the interesting failure mode, matching RocksDB's
FaultInjectionTestFS default.
"""
from __future__ import annotations

import errno as _errno
import os
import random
import threading

from .errors import SimulatedCrashError

#: operation kinds a fault rule can match. "write" covers append/pwrite,
#: "sync" covers fsync/fdatasync on any handle, "ship" covers replication
#: frame sends (the transport routes through the env).
OPS = ("open", "read", "write", "sync", "rename", "unlink", "listdir",
       "truncate", "link", "ship")

#: ops that mutate the (simulated) device — these all fail once a simulated
#: crash has fired. "ship" is here because a dead primary cannot send.
_MUTATING_OPS = frozenset(
    ("open", "write", "sync", "rename", "unlink", "truncate", "link", "ship")
)


class Env:
    """Default environment: a thin passthrough to the real filesystem.

    The engine only ever calls these methods, so a subclass can interpose on
    the complete I/O surface. File handles returned by :meth:`open` are
    ordinary file objects (or wrappers with the same interface); raw-fd
    paths use :meth:`open_fd`/:meth:`pread`/:meth:`pwrite`/:meth:`close_fd`.
    """

    # -- buffered file objects ------------------------------------------
    def open(self, path, mode="rb", buffering=-1):
        return open(path, mode, buffering=buffering)

    def fsync(self, f) -> None:
        """fsync a file object or a raw fd. File objects are flushed first —
        fsyncing a buffered handle without draining the userspace buffer
        would silently make nothing durable."""
        if isinstance(f, int):
            os.fsync(f)
        else:
            f.flush()
            os.fsync(f.fileno())

    # -- raw fd API (value queues) --------------------------------------
    def open_fd(self, path, flags, mode=0o644) -> int:
        return os.open(path, flags, mode)

    def close_fd(self, fd: int) -> None:
        os.close(fd)

    def pread(self, fd: int, size: int, offset: int) -> bytes:
        return os.pread(fd, size, offset)

    def pread_f(self, f, size: int, offset: int) -> bytes:
        """Positional read on a file object (race-free: no shared cursor)."""
        return os.pread(f.fileno(), size, offset)

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        return os.pwrite(fd, data, offset)

    def truncate_fd(self, fd: int, size: int) -> None:
        os.ftruncate(fd, size)

    # -- metadata --------------------------------------------------------
    def rename(self, src, dst) -> None:
        os.rename(src, dst)

    def unlink(self, path) -> None:
        os.unlink(path)

    def listdir(self, path):
        return os.listdir(path)

    def exists(self, path) -> bool:
        return os.path.exists(path)

    def getsize(self, path) -> int:
        return os.path.getsize(path)

    def makedirs(self, path) -> None:
        os.makedirs(path, exist_ok=True)

    def link(self, src, dst) -> None:
        """Hard-link ``src`` to ``dst`` (checkpoint file sharing). Callers
        that must work across devices catch OSError and fall back to a
        byte copy."""
        os.link(src, dst)

    def release_tracking(self, prefix: str) -> None:
        """Disown every tracked path under ``prefix`` (no-op here; see
        ``FaultInjectionEnv``). Called when a completed checkpoint image is
        handed to another failure domain — e.g. a replica bootstrap — so
        this env's simulated crash can no longer rewind files that a
        different machine now owns and writes."""

    # -- replication transport -------------------------------------------
    def ship(self, stream: str, blob: bytes) -> list:
        """Deliver one replication frame on ``stream``. Returns the frames
        that actually arrive at the far end — a fault-injecting env may
        drop, duplicate, reorder, or corrupt them in flight."""
        return [blob]


#: module-level default shared by every DB that doesn't set ``cfg.env``.
DEFAULT_ENV = Env()


class FaultRule:
    """One injection rule. Matches ``op`` (or any op if None) against a path
    substring, then fires according to ``count`` (first N matches) and/or
    ``probability``. ``count=None`` means unlimited."""

    __slots__ = ("op", "path_substr", "count", "probability", "exc_factory")

    def __init__(self, op, path_substr, count, probability, exc_factory):
        self.op = op
        self.path_substr = path_substr
        self.count = count
        self.probability = probability
        self.exc_factory = exc_factory

    def matches(self, op: str, path: str) -> bool:
        if self.op is not None and self.op != op:
            return False
        if self.path_substr is not None and self.path_substr not in path:
            return False
        return True


class _FaultFile:
    """File-object wrapper that routes write/flush/read traffic back through
    the owning FaultInjectionEnv for rule checks and unsynced tracking."""

    def __init__(self, env, f, path, writable):
        self._env = env
        self._f = f
        self.path = path
        self._writable = writable

    def write(self, data):
        if self._writable:
            self._env._check("write", self.path)
        n = self._f.write(data)
        if self._writable:
            self._env._note_append(self.path, len(data))
        return n

    def read(self, *a):
        self._env._check("read", self.path)
        return self._f.read(*a)

    def seek(self, *a):
        return self._f.seek(*a)

    def tell(self):
        return self._f.tell()

    def flush(self):
        return self._f.flush()

    def fileno(self):
        return self._f.fileno()

    def truncate(self, size=None):
        self._env._check("truncate", self.path)
        r = self._f.truncate(size)
        self._env._note_truncate(self.path, size if size is not None else self._f.tell())
        return r

    def close(self):
        return self._f.close()

    @property
    def closed(self):
        return self._f.closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _FileState:
    """Unsynced-write tracking for one path: bytes beyond ``synced_size`` and
    overwrites recorded in ``undo`` vanish on :meth:`drop_unsynced`.

    The undo log is bounded: only the *first* overwrite of each synced byte
    range is recorded (``covered`` tracks ranges already logged — their
    pre-overwrite originals are what a rollback restores, so later rewrites
    of the same bytes need no new entries). Total undo bytes per file can
    therefore never exceed ``synced_size``, no matter how many times a
    long-running workload rewrites the same region."""

    __slots__ = ("synced_size", "undo", "covered", "undo_bytes")

    def __init__(self, synced_size: int):
        self.synced_size = synced_size
        self.undo = []  # list[(offset, original_bytes)] for overwrites below synced_size
        self.covered = []  # sorted disjoint (start, end) ranges already in undo
        self.undo_bytes = 0

    def uncovered(self, start: int, end: int):
        """Subranges of [start, end) not yet present in the undo log."""
        out = []
        pos = start
        for s, e in self.covered:
            if e <= pos:
                continue
            if s >= end:
                break
            if s > pos:
                out.append((pos, s))
            pos = max(pos, e)
            if pos >= end:
                break
        if pos < end:
            out.append((pos, end))
        return out

    def cover(self, start: int, end: int) -> None:
        if start >= end:
            return
        ivs = self.covered + [(start, end)]
        ivs.sort()
        merged = [ivs[0]]
        for s, e in ivs[1:]:
            ls, le = merged[-1]
            if s <= le:
                merged[-1] = (ls, max(le, e))
            else:
                merged.append((s, e))
        self.covered = merged

    def clear_undo(self) -> None:
        self.undo.clear()
        self.covered.clear()
        self.undo_bytes = 0


class FaultInjectionEnv(Env):
    """Env that can fail operations on command, simulate whole-process
    crashes with loss of unsynced data, and corrupt bytes on disk."""

    def __init__(self, seed: int = 0):
        self._lock = threading.RLock()
        self._rules: list[FaultRule] = []
        self._rng = random.Random(seed)
        self._files: dict[str, _FileState] = {}
        self._fd_paths: dict[int, str] = {}
        # crash point: countdown over matching mutating ops; <0 = disarmed
        self._crash_countdown = -1
        self._crash_ops: frozenset = frozenset()
        self._crash_path_substr: str | None = None
        self._crashed = False
        self.op_counts: dict[str, int] = {}
        # replication-transport faults: (drop, duplicate, reorder, corrupt)
        # probabilities applied per shipped frame
        self._transport_faults = (0.0, 0.0, 0.0, 0.0)
        self._held_frame: bytes | None = None  # frame delayed by a reorder
        self.transport_stats = {
            "dropped": 0, "duplicated": 0, "reordered": 0, "corrupted": 0,
        }

    # ------------------------------------------------------------------
    # test-facing controls
    # ------------------------------------------------------------------
    def add_fault(
        self,
        op: str | None = None,
        path_substr: str | None = None,
        count: int | None = 1,
        probability: float = 1.0,
        error: int | BaseException | type = _errno.EIO,
    ) -> FaultRule:
        """Arm an injection rule. ``error`` may be an errno int, an exception
        instance/class, or a zero-arg callable returning an exception."""
        if isinstance(error, int):
            eno = error
            factory = lambda path: OSError(eno, os.strerror(eno), path)  # noqa: E731
        elif isinstance(error, BaseException):
            factory = lambda path, e=error: e  # noqa: E731
        elif isinstance(error, type) and issubclass(error, BaseException):
            factory = lambda path, cls=error: cls(f"injected fault at {path}")  # noqa: E731
        else:
            factory = lambda path, fn=error: fn()  # noqa: E731
        rule = FaultRule(op, path_substr, count, probability, factory)
        with self._lock:
            self._rules.append(rule)
        return rule

    def clear_faults(self) -> None:
        with self._lock:
            self._rules.clear()

    def set_crash_after(
        self,
        n: int,
        ops=("write", "sync", "rename", "unlink"),
        path_substr: str | None = None,
    ) -> None:
        """After ``n`` more matching mutating ops succeed, the simulated
        machine dies: every further mutating op raises SimulatedCrashError."""
        with self._lock:
            self._crash_countdown = max(0, n)
            self._crash_ops = frozenset(ops)
            self._crash_path_substr = path_substr
            self._crashed = n == 0

    def disarm_crash(self) -> None:
        with self._lock:
            self._crash_countdown = -1
            self._crashed = False

    def set_transport_faults(
        self,
        drop: float = 0.0,
        duplicate: float = 0.0,
        reorder: float = 0.0,
        corrupt: float = 0.0,
    ) -> None:
        """Per-frame fault probabilities for :meth:`ship`. ``reorder`` holds
        a frame back and delivers it after the next one (an adjacent swap);
        ``corrupt`` flips one byte, which the frame CRC must catch."""
        with self._lock:
            self._transport_faults = (drop, duplicate, reorder, corrupt)

    @property
    def undo_bytes(self) -> int:
        """Total bytes held in per-file overwrite undo logs (bounded: at most
        one entry per synced byte — see :class:`_FileState`)."""
        with self._lock:
            seen, total = set(), 0
            for st in self._files.values():
                if id(st) in seen:  # hard links share one state object
                    continue
                seen.add(id(st))
                total += st.undo_bytes
            return total

    def reset(self) -> None:
        """Return the env to a pristine state: clear fault rules, disarm any
        crash point, forget unsynced-write tracking, clear transport faults
        and the held reorder frame, and zero all counters. Long-lived
        harness loops call this between iterations so no state (including
        the undo log) accumulates across runs."""
        with self._lock:
            self._rules.clear()
            self._crash_countdown = -1
            self._crash_ops = frozenset()
            self._crash_path_substr = None
            self._crashed = False
            self._files.clear()
            self._fd_paths.clear()
            self._transport_faults = (0.0, 0.0, 0.0, 0.0)
            self._held_frame = None
            self.op_counts.clear()
            for k in self.transport_stats:
                self.transport_stats[k] = 0

    @property
    def crashed(self) -> bool:
        return self._crashed

    def release_tracking(self, prefix: str) -> None:
        """Disown tracked paths under ``prefix``: a completed checkpoint
        image belongs to whoever it was made for (a replica, an operator's
        backup target), so this env's ``drop_unsynced`` must not rewind
        those files once another failure domain starts writing them.
        Hard-link-shared state stays alive under the source path."""
        sep = prefix if prefix.endswith(os.sep) else prefix + os.sep
        with self._lock:
            for path in [p for p in self._files if p.startswith(sep)]:
                del self._files[path]

    def drop_unsynced(self) -> None:
        """Rewind every tracked file to its last-fsynced state (the on-disk
        image a real power-cut would leave, under a no-reorder disk model)."""
        with self._lock:
            for path, st in list(self._files.items()):
                try:
                    fd = os.open(path, os.O_RDWR)
                except FileNotFoundError:
                    continue
                try:
                    for off, original in reversed(st.undo):
                        os.pwrite(fd, original, off)
                    os.ftruncate(fd, st.synced_size)
                finally:
                    os.close(fd)
                st.clear_undo()
            # state survives: synced sizes are still the truth for these paths

    def reset_tracking(self) -> None:
        """Forget unsynced-write state (fresh boot of the simulated machine)."""
        with self._lock:
            self._files.clear()
            self._fd_paths.clear()

    def corrupt(self, path: str, offset: int, nbytes: int = 1) -> None:
        """Flip bits in ``nbytes`` bytes at ``offset`` (XOR 0xFF)."""
        with open(path, "r+b") as f:
            f.seek(offset)
            original = f.read(nbytes)
            f.seek(offset)
            f.write(bytes(b ^ 0xFF for b in original))

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _check(self, op: str, path: str, mutating: bool | None = None) -> None:
        """Rule + crash-point gate, called before the real operation.
        ``mutating`` overrides the op-kind default — a read-only ``open``
        must keep working after a simulated crash (the dead machine's disk
        is still readable), while a writable one must not."""
        if mutating is None:
            mutating = op in _MUTATING_OPS
        with self._lock:
            self.op_counts[op] = self.op_counts.get(op, 0) + 1
            if self._crashed and mutating:
                raise SimulatedCrashError(
                    _errno.EIO, f"simulated crash: {op} on {path}"
                )
            if (
                self._crash_countdown >= 0
                and op in self._crash_ops
                and (
                    self._crash_path_substr is None
                    or self._crash_path_substr in path
                )
            ):
                if self._crash_countdown == 0:
                    self._crashed = True
                    raise SimulatedCrashError(
                        _errno.EIO, f"simulated crash: {op} on {path}"
                    )
                self._crash_countdown -= 1
            for rule in self._rules:
                if not rule.matches(op, path):
                    continue
                if rule.count is not None and rule.count <= 0:
                    continue
                if rule.probability < 1.0 and self._rng.random() >= rule.probability:
                    continue
                if rule.count is not None:
                    rule.count -= 1
                raise rule.exc_factory(path)

    def _state(self, path: str, synced_size: int) -> _FileState:
        st = self._files.get(path)
        if st is None:
            st = self._files[path] = _FileState(synced_size)
        return st

    def _note_append(self, path: str, nbytes: int) -> None:
        # appends land past synced_size; nothing to record — drop_unsynced's
        # truncate handles them. Ensure the path is tracked.
        with self._lock:
            if path not in self._files:
                # opened before tracking started (shouldn't happen via open())
                self._files[path] = _FileState(0)

    def _note_truncate(self, path: str, size: int) -> None:
        with self._lock:
            st = self._files.get(path)
            if st is not None and size < st.synced_size:
                st.synced_size = size
                st.undo = [(o, b[: max(0, size - o)]) for o, b in st.undo if o < size]
                st.undo_bytes = sum(len(b) for _, b in st.undo)
                st.covered = [(s, min(e, size)) for s, e in st.covered if s < size]

    def _note_sync(self, path: str) -> None:
        with self._lock:
            st = self._files.get(path)
            if st is not None:
                try:
                    st.synced_size = os.path.getsize(path)
                except OSError:
                    pass
                st.clear_undo()

    # ------------------------------------------------------------------
    # Env surface
    # ------------------------------------------------------------------
    def open(self, path, mode="rb", buffering=-1):
        writable = any(c in mode for c in "wax+")
        self._check("open", path, mutating=writable)
        f = open(path, mode, buffering=buffering)
        if writable:
            with self._lock:
                if "w" in mode:
                    # truncating open: previously-synced content is gone
                    self._files[path] = _FileState(0)
                elif path not in self._files:
                    # append/update open of an existing file: whatever is on
                    # disk now was (conservatively) already durable
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        size = 0
                    self._files[path] = _FileState(size)
        return _FaultFile(self, f, path, writable)

    def fsync(self, f) -> None:
        if isinstance(f, int):
            path = self._fd_paths.get(f, "")
            self._check("sync", path)
            os.fsync(f)
            if path:
                self._note_sync(path)
        else:
            path = getattr(f, "path", getattr(f, "name", ""))
            self._check("sync", path)
            f.flush()
            os.fsync(f.fileno())
            self._note_sync(path)

    def open_fd(self, path, flags, mode=0o644) -> int:
        self._check(
            "open", path, mutating=bool(flags & (os.O_WRONLY | os.O_RDWR))
        )
        fd = os.open(path, flags, mode)
        with self._lock:
            self._fd_paths[fd] = path
            if flags & (os.O_WRONLY | os.O_RDWR):
                if path not in self._files:
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        size = 0
                    self._files[path] = _FileState(size)
        return fd

    def close_fd(self, fd: int) -> None:
        with self._lock:
            self._fd_paths.pop(fd, None)
        os.close(fd)

    def pread(self, fd: int, size: int, offset: int) -> bytes:
        self._check("read", self._fd_paths.get(fd, ""))
        return os.pread(fd, size, offset)

    def pread_f(self, f, size: int, offset: int) -> bytes:
        self._check("read", getattr(f, "path", getattr(f, "name", "")))
        return os.pread(f.fileno(), size, offset)

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        path = self._fd_paths.get(fd, "")
        self._check("write", path)
        if path:
            with self._lock:
                st = self._files.get(path)
                if st is not None and offset < st.synced_size:
                    # overwriting durable bytes: remember the original so a
                    # simulated crash can undo the unsynced overwrite. Only
                    # ranges not already logged need an entry — the oldest
                    # original is what a rollback restores, so the undo log
                    # stays bounded by synced_size however often the same
                    # bytes are rewritten.
                    n = min(len(data), st.synced_size - offset)
                    for s, e in st.uncovered(offset, offset + n):
                        original = os.pread(fd, e - s, s)
                        st.undo.append((s, original))
                        st.undo_bytes += len(original)
                    st.cover(offset, offset + n)
        return os.pwrite(fd, data, offset)

    def truncate_fd(self, fd: int, size: int) -> None:
        path = self._fd_paths.get(fd, "")
        self._check("truncate", path)
        os.ftruncate(fd, size)
        if path:
            self._note_truncate(path, size)

    def rename(self, src, dst) -> None:
        self._check("rename", src)
        os.rename(src, dst)
        with self._lock:
            if src in self._files:
                self._files[dst] = self._files.pop(src)

    def unlink(self, path) -> None:
        self._check("unlink", path)
        os.unlink(path)
        with self._lock:
            self._files.pop(path, None)

    def listdir(self, path):
        self._check("listdir", path)
        return os.listdir(path)

    def link(self, src, dst) -> None:
        # a hard link shares the inode, so both names must share ONE state
        # object — independent copies let drop_unsynced ftruncate the inode
        # down through one name (its stale smaller synced_size) and then
        # zero-extend it back through the other, corrupting synced bytes
        # that a real power-cut would have kept
        self._check("link", dst)
        os.link(src, dst)
        with self._lock:
            st = self._files.get(src)
            if st is not None:
                self._files[dst] = st

    def ship(self, stream: str, blob: bytes) -> list:
        # crash/rule gate first: a dead primary cannot send, and crash
        # harnesses can arm kill points on the ship edge itself
        self._check("ship", stream)
        with self._lock:
            drop, dup, reorder, corrupt = self._transport_faults
            held, self._held_frame = self._held_frame, None
            out = []
            rnd = self._rng.random
            if drop and rnd() < drop:
                self.transport_stats["dropped"] += 1
            else:
                if corrupt and blob and rnd() < corrupt:
                    i = self._rng.randrange(len(blob))
                    blob = blob[:i] + bytes((blob[i] ^ 0xFF,)) + blob[i + 1:]
                    self.transport_stats["corrupted"] += 1
                if reorder and rnd() < reorder:
                    # hold this frame back; it rides after the next send
                    self._held_frame = blob
                    self.transport_stats["reordered"] += 1
                else:
                    out.append(blob)
                    if dup and rnd() < dup:
                        out.append(blob)
                        self.transport_stats["duplicated"] += 1
            if held is not None:
                out.append(held)
            return out
