"""Typed error hierarchy + background ErrorHandler (failure subsystem).

Before this module existed, ANY exception escaping a background job latched
``scheduler.error`` forever: one transient ``OSError`` in a flush turned
every later ``put``/``get`` into ``RuntimeError("background job failed")``
with no retry, no degradation, and no way back short of reopening the DB.

The failure model now has three severities (see docs/ARCHITECTURE.md
§"Failure model & recovery"):

* **transient** — plausibly-recoverable I/O errors (EINTR/EAGAIN/EIO/...):
  background jobs retry with bounded exponential backoff + jitter
  (``bg_error_max_retries`` / ``bg_error_backoff_ms``). Only after the
  retries are exhausted does the error escalate to *hard*.
* **hard** — resource exhaustion (ENOSPC, EDQUOT, EROFS, ...), simulated
  device loss, or any non-I/O exception (a programming error is never
  retried): the DB degrades to **read-only mode** — reads keep serving,
  writes fail fast with :class:`DBReadOnlyError` — until :meth:`DB.resume`
  re-probes the Env and clears the latch.
* **corruption** — a CRC-verified read failed (:class:`CorruptionError`):
  the offending file is *quarantined* (marked in the manifest, skipped by
  compaction picking and GC) and the job aborts without latching, so one
  bad block degrades one file, not the whole DB.

``DBError`` subclasses ``RuntimeError`` and ``CorruptionError`` subclasses
``IOError`` so every pre-existing ``except RuntimeError`` /
``pytest.raises(IOError)`` contract over these paths keeps holding.
"""
from __future__ import annotations

import errno
import random
import threading
import time

# -- severities -------------------------------------------------------------

TRANSIENT = "transient"
HARD = "hard"
CORRUPTION = "corruption"

#: errnos that mean "the device/filesystem cannot take writes, retrying
#: will not help": degrade to read-only instead of burning retries.
_HARD_ERRNOS = frozenset(
    getattr(errno, name)
    for name in ("ENOSPC", "EDQUOT", "EROFS", "EACCES", "EPERM", "ENODEV", "ENXIO")
    if hasattr(errno, name)
)


# -- typed errors -----------------------------------------------------------


class DBError(RuntimeError):
    """Base of the engine's typed errors (a RuntimeError so callers written
    against the pre-hierarchy behavior keep catching them)."""


class DBReadOnlyError(DBError):
    """The DB latched read-only after a hard background error; writes fail
    fast until :meth:`DB.resume` clears the latch. ``__cause__`` carries the
    original hard error."""


class BackgroundError(DBError):
    """A background job failed hard; raised by ``wait_idle``/``flush`` when
    the scheduler error latch is set."""


class SnapshotUnstableError(DBError):
    """A read could not obtain a stable version snapshot even after retries
    and one backoff round (sustained compaction churn)."""


class ReplicaDivergedError(DBError):
    """A follower's rolling stream CRC disagreed with the primary's: its
    applied state has forked (byte flip, reorder, or lost frame that slipped
    past the frame CRC). The replica stops applying and must re-bootstrap
    from a fresh checkpoint image."""


class CorruptionError(IOError):
    """A CRC-verified read found corrupt data. Carries enough identity for
    the ErrorHandler to quarantine the file (``sst_file_no`` or
    ``bvalue_file_id``). An IOError so paranoid-read callers that predate
    the hierarchy (``pytest.raises(IOError)``) still catch it."""

    def __init__(
        self,
        msg: str,
        *,
        sst_file_no: int | None = None,
        bvalue_file_id: int | None = None,
        path: str | None = None,
    ):
        super().__init__(msg)
        self.sst_file_no = sst_file_no
        self.bvalue_file_id = bvalue_file_id
        self.path = path


class SimulatedCrashError(OSError):
    """Raised by FaultInjectionEnv once its crash point fires: the simulated
    device is gone, so classification is HARD (no retries)."""


def classify(exc: BaseException) -> str:
    """Map an exception to a severity. Unknown exception types (including
    plain RuntimeError — a programming error, not an I/O hiccup) are HARD:
    retrying a bug only repeats it."""
    if isinstance(exc, CorruptionError):
        return CORRUPTION
    if isinstance(exc, SimulatedCrashError):
        return HARD
    if isinstance(exc, SnapshotUnstableError):
        return TRANSIENT  # compaction churn: backs off and settles
    if isinstance(exc, OSError):
        if exc.errno in _HARD_ERRNOS:
            return HARD
        return TRANSIENT
    return HARD


#: sentinel returned by :meth:`ErrorHandler.run_job` when the job was
#: aborted on a handled (quarantined) corruption instead of completing.
JOB_ABORTED = object()


class ErrorHandler:
    """Severity-classified background-failure policy for one DB.

    The scheduler's sticky ``error`` latch still exists — but only *hard*
    errors reach it now. ``run_job`` wraps every background job body:
    transient errors retry in place (bounded exponential backoff with
    jitter, on the worker thread), corruption quarantines the offending
    file and aborts the job without latching, and hard errors (or exhausted
    retries) re-raise so the worker latches them and the DB enters
    read-only mode."""

    def __init__(self, db):
        self.db = db
        cfg = db.cfg
        self.max_retries = max(0, cfg.bg_error_max_retries)
        self.backoff_s = max(0.0, cfg.bg_error_backoff_ms) / 1e3
        self.backoff_max_s = max(self.backoff_s, cfg.bg_error_backoff_max_ms / 1e3)
        self._rng = random.Random(0xB44D)
        self._lock = threading.Lock()

    # -- read-only latch -------------------------------------------------
    @property
    def error(self) -> BaseException | None:
        """The hard error the DB is latched on (None = healthy)."""
        bg = getattr(self.db, "bg", None)
        return bg.error if bg is not None else None

    @property
    def read_only(self) -> bool:
        return self.error is not None

    def check_writable(self) -> None:
        """Write-path gate: fail fast (typed) while the DB is read-only."""
        if getattr(self.db, "_role", "primary") != "primary":
            raise DBReadOnlyError(
                "DB is a replica: user writes are rejected until promote()"
            )
        e = self.error
        if e is not None:
            raise DBReadOnlyError(
                "DB is read-only after a hard background error "
                "(call resume() once the cause is cleared)"
            ) from e

    def clear(self) -> None:
        """Drop the hard-error latch (resume path). The scheduler latch is
        the single source of truth, so clearing it is the whole job."""
        bg = getattr(self.db, "bg", None)
        if bg is not None:
            with bg.sched.condition:
                bg.sched.error = None

    # -- corruption ------------------------------------------------------
    def on_corruption(self, exc: CorruptionError) -> bool:
        """Quarantine the file a CorruptionError identifies. Returns True
        when the error was attributable (and the DB can keep running
        without the file); False means it must escalate to hard."""
        db = self.db
        handled = False
        if exc.sst_file_no is not None:
            if db.versions.quarantine("sst", exc.sst_file_no):
                handled = True
        if exc.bvalue_file_id is not None:
            if db.versions.quarantine("bvalue", exc.bvalue_file_id):
                handled = True
        if handled:
            db.stats.add("corruptions_detected")
            db.stats.add("files_quarantined")
        return handled

    # -- background job wrapper -----------------------------------------
    def run_job(self, fn, kind: str):
        """Run one background job body under the retry/severity policy.

        Returns ``fn()``'s result on success, :data:`JOB_ABORTED` when a
        corruption was handled by quarantine (the job gives up its slot;
        the next scheduling edge re-picks without the quarantined file),
        and re-raises hard errors for the scheduler to latch."""
        db = self.db
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as exc:
                sev = classify(exc)
                if sev == CORRUPTION:
                    if self.on_corruption(exc):
                        return JOB_ABORTED
                    sev = HARD
                if (
                    sev == TRANSIENT
                    and attempt < self.max_retries
                    and not getattr(db, "_closed", False)
                ):
                    attempt += 1
                    db.stats.add("bg_retries")
                    delay = min(
                        self.backoff_max_s, self.backoff_s * (2 ** (attempt - 1))
                    )
                    # full jitter in [0.5, 1.5): retries from concurrent
                    # jobs against the same device spread out
                    time.sleep(delay * (0.5 + self._rng.random()))
                    continue
                db.stats.add(
                    "bg_errors_hard" if sev == HARD else "bg_errors_transient_exhausted"
                )
                raise
