"""Prioritized background job scheduler + delayed-write controller.

This replaces the single sleep-polling ``BackgroundWorker`` thread: all
background work now runs as discrete **jobs** on a small two-class thread
pool, scheduled *event-driven* (on memtable rotation, on job completion)
instead of being discovered by a 0.2 s poll loop.

Three layers live here:

* :class:`JobScheduler` — the generic pool. ``flush_threads`` serve only
  HIGH-priority jobs (a long compaction can never starve a flush);
  ``background_threads`` serve HIGH first, then LOW (compaction / GC).
  Completion is condition-variable signalled, so ``DB.wait_idle`` and the
  write-stall path block on a CV instead of sleep-polling.
* :class:`BackgroundCoordinator` — the DB-specific orchestration: decides
  *which* jobs exist (single-flight flush of the oldest immutable,
  pick-and-lock compactions up to the thread budget, threshold-triggered
  GC), re-examines the tree on every completion edge, and owns the
  subcompaction worker pool that :meth:`Compactor.run` fans shard work
  onto.
* :class:`WriteController` — the continuous delayed-write controller
  (RocksDB style): instead of the old binary stop/sleep, writers above the
  slowdown thresholds pay a per-byte delay derived from a write rate that
  decays multiplicatively while L0 depth / pending-compaction bytes keep
  growing and recovers once compaction catches up.

Concurrency safety relies on the per-file compaction locks in
:mod:`.manifest`: a file is locked from pick time until its job commits,
so two concurrent compaction jobs can never claim overlapping inputs, and
each job's input set is pinned (locked files are only ever deleted by the
job holding the lock).
"""
from __future__ import annotations

import threading
import time
import traceback
from collections import deque

from .compaction import Compactor
from .errors import JOB_ABORTED, BackgroundError

# job priorities share the rate limiter's definitions: flush is HIGH in
# both domains (thread pool and I/O budget), compaction/GC LOW in both —
# one source of truth keeps the two domains from desynchronizing
from .ratelimiter import PRI_HIGH, PRI_LOW  # noqa: F401  (re-exported)


class Job:
    __slots__ = ("name", "fn", "priority", "kind")

    def __init__(self, name: str, fn, priority: int, kind: str):
        self.name = name
        self.fn = fn
        self.priority = priority
        self.kind = kind


class JobScheduler:
    """Fixed thread pool with two priority classes and CV-signalled
    completion. ``on_job_done(job)`` (if set) runs on the worker thread
    after the job body but *before* the job is counted as finished, so a
    completion hook that submits follow-up work can never leave a window
    where ``outstanding()`` reads zero while more work is schedulable."""

    def __init__(self, flush_threads: int = 1, background_threads: int = 2, stats=None):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queues: tuple[deque[Job], deque[Job]] = (deque(), deque())
        self._outstanding = [0, 0]  # queued + running, per priority
        self._stop = False
        self._discard = False
        self.error: BaseException | None = None
        self.on_job_done = None
        self._stats = stats
        self._threads: list[threading.Thread] = []
        for i in range(max(1, flush_threads)):
            t = threading.Thread(
                target=self._worker, args=(False,), name=f"lsm-flush-{i}", daemon=True
            )
            self._threads.append(t)
        for i in range(max(1, background_threads)):
            t = threading.Thread(
                target=self._worker, args=(True,), name=f"lsm-bg-{i}", daemon=True
            )
            self._threads.append(t)
        for t in self._threads:
            t.start()

    def submit(self, name: str, fn, priority: int, kind: str) -> bool:
        """Enqueue a job; returns False if the scheduler is stopping."""
        with self._cv:
            if self._stop:
                return False
            self._queues[priority].append(Job(name, fn, priority, kind))
            self._outstanding[priority] += 1
            self._cv.notify_all()
            return True

    def outstanding(self, priority: int | None = None) -> int:
        with self._lock:
            if priority is None:
                return sum(self._outstanding)
            return self._outstanding[priority]

    def stop(self, discard_queued: bool = False, timeout: float = 60.0) -> None:
        """Stop the pool. Queued jobs are drained first unless
        ``discard_queued`` (crash close); running jobs always finish."""
        with self._cv:
            self._stop = True
            self._discard = discard_queued
            if discard_queued:
                for pri, q in enumerate(self._queues):
                    self._outstanding[pri] -= len(q)
                    q.clear()
            self._cv.notify_all()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))

    @property
    def condition(self) -> threading.Condition:
        """The completion CV — waiters must re-check their predicate."""
        return self._cv

    # -- internals --------------------------------------------------------
    def _pop_locked(self, serve_low: bool) -> Job | None:
        if self._queues[PRI_HIGH]:
            return self._queues[PRI_HIGH].popleft()
        if serve_low and self._queues[PRI_LOW]:
            return self._queues[PRI_LOW].popleft()
        return None

    def _worker(self, serve_low: bool) -> None:
        while True:
            with self._cv:
                while True:
                    job = self._pop_locked(serve_low)
                    if job is not None:
                        break
                    if self._stop:
                        return
                    self._cv.wait()
            t0 = time.monotonic()
            try:
                job.fn()
            except BaseException as e:  # surface instead of dying silently
                with self._cv:
                    if self.error is None:
                        self.error = e
                traceback.print_exc()
            finally:
                if self._stats is not None:
                    self._stats.record_job(job.kind, time.monotonic() - t0)
                hook = self.on_job_done
                if hook is not None:
                    try:
                        hook(job)
                    except BaseException as e:
                        with self._cv:
                            if self.error is None:
                                self.error = e
                        traceback.print_exc()
                with self._cv:
                    self._outstanding[job.priority] -= 1
                    self._cv.notify_all()


class WriteController:
    """Continuous delayed-write controller (RocksDB ``WriteController``
    analogue). ``delay_for`` is called by the commit leader under the DB
    mutex (the sleep itself happens with the mutex released); it returns
    the seconds the leader must sleep so the aggregate ingest rate tracks
    the current delayed-write rate. The rate decays (×0.8) while the stall
    signals — L0 depth, pending-compaction bytes — keep worsening, holds
    while they are unchanged (they only move at flush/compaction commit
    edges, so "unchanged" means sustained pressure, not relief), and
    recovers (×1.25, capped at ``delayed_write_rate``) once they improve —
    a smooth throughput ramp instead of the old binary sleep."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._rate = float(cfg.delayed_write_rate)
        self._active = False
        self._last_l0 = 0
        self._last_pending = 0

    def delay_for(self, l0: int, pending_bytes: int, nbytes: int) -> float:
        cfg = self.cfg
        delayed = (
            l0 >= cfg.l0_slowdown_trigger
            or pending_bytes >= cfg.soft_pending_compaction_bytes
        )
        if not delayed:
            self._active = False
            self._rate = min(float(cfg.delayed_write_rate), self._rate * 1.25)
            return 0.0
        if not self._active:
            self._active = True
            self._rate = float(cfg.delayed_write_rate)
        elif l0 > self._last_l0 or pending_bytes > self._last_pending:
            self._rate = max(float(cfg.delayed_write_min_rate), self._rate * 0.8)
        elif l0 < self._last_l0 or pending_bytes < self._last_pending:
            self._rate = min(float(cfg.delayed_write_rate), self._rate * 1.25)
        # unchanged signals = sustained pressure (they only move at
        # flush/compaction commit edges): HOLD the rate — recovering here
        # would climb back to full rate between edges and reintroduce the
        # on/off oscillation this controller exists to remove
        self._last_l0 = l0
        self._last_pending = pending_bytes
        # cap a single charge's delay so one giant debt can't freeze the
        # writer queue (the sleeping leader still heads it, so every
        # writer queues behind this sleep even though the mutex is free)
        return min(nbytes / self._rate, 0.25)


class BackgroundCoordinator:
    """DB-side orchestration on top of :class:`JobScheduler`.

    Scheduling is edge-triggered: :meth:`maybe_schedule` runs at every
    memtable rotation and after every job, converting available work into
    queued jobs. That makes idleness a pure counter condition —
    ``outstanding() == 0`` and no immutables — which :meth:`wait_idle`
    waits for on the scheduler CV (no polling ``pick()`` calls)."""

    def __init__(self, db):
        self.db = db
        cfg = db.cfg
        self.compactor = Compactor(db)
        self.sched = JobScheduler(
            flush_threads=cfg.flush_threads,
            background_threads=cfg.background_threads,
            stats=db.stats,
        )
        self.sched.on_job_done = self._job_done
        self._state_lock = threading.Lock()
        self._pick_lock = threading.Lock()  # serializes pick-and-lock
        self._gc_lock = threading.Lock()  # manual vs auto GC exclusion
        self._flush_inflight = False
        self._compactions_inflight = 0
        self._gc_inflight = False
        self._repl_inflight = False  # single-flight follower apply/catch-up
        # candidate-set signature of a completed auto-GC pass that made no
        # progress: don't immediately requeue the exact same stuck work
        # (a new dead-ratio edge changes the signature and re-arms GC)
        self._gc_stuck: frozenset | None = None
        # sliced auto-GC hands its remaining work list to the next slice so
        # the O(DB) live-key scan runs once per pass, not once per slice
        self._gc_resume = None
        self._stopping = False
        self._subpool = None  # lazy shared subcompaction pool

    @property
    def error(self) -> BaseException | None:
        return self.sched.error

    # -- scheduling -------------------------------------------------------
    def maybe_schedule(self) -> None:
        """Convert every piece of available background work into jobs:
        one flush (single-flight, oldest immutable first), compactions up
        to the thread budget (inputs locked at pick time), and a GC pass
        when a sealed BValue file crosses the dead-ratio trigger."""
        if self._stopping or self.sched.error is not None:
            return
        db = self.db
        with self._state_lock:
            want_flush = not self._flush_inflight and bool(db.immutables)
            if want_flush:
                self._flush_inflight = True
        if want_flush and not self.sched.submit("flush", self._flush_job, PRI_HIGH, "flush"):
            with self._state_lock:
                self._flush_inflight = False
        while True:
            with self._state_lock:
                if self._compactions_inflight >= db.cfg.background_threads:
                    break
                self._compactions_inflight += 1  # optimistic slot claim
            picked = self._pick_and_lock()
            if picked is None:
                with self._state_lock:
                    self._compactions_inflight -= 1
                break
            ok = self.sched.submit(
                "compact", lambda p=picked: self._compaction_job(p), PRI_LOW, "compaction"
            )
            if not ok:
                level, inputs, overlaps = picked
                db.versions.unlock_files([f.file_no for f in inputs + overlaps])
                with self._state_lock:
                    self._compactions_inflight -= 1
                break
        self._maybe_schedule_gc()
        self.maybe_schedule_repl()

    def maybe_schedule_repl(self) -> None:
        """Follower apply/catch-up job (single-flight, flush-priority pool):
        queued replication frames — or a detected gap that needs a WAL
        catch-up read from the primary — become one drain pass. Re-armed at
        every completion edge like the other job kinds, so a frame that
        arrives mid-drain schedules the next pass instead of being lost."""
        db = self.db
        follower = getattr(db, "_follower", None)
        if (
            follower is None
            or self._stopping
            or getattr(db, "_closed", False)
            or self.sched.error is not None
            or not follower.has_work()
        ):
            return
        with self._state_lock:
            if self._repl_inflight:
                return
            self._repl_inflight = True
        if not self.sched.submit("repl-apply", self._repl_job, PRI_HIGH, "repl_apply"):
            with self._state_lock:
                self._repl_inflight = False

    def _repl_job(self) -> None:
        db = self.db
        try:
            follower = getattr(db, "_follower", None)
            if follower is not None:
                db.errors.run_job(follower.drain, "repl_apply")
        finally:
            with self._state_lock:
                self._repl_inflight = False

    def _pick_and_lock(self):
        db = self.db
        with self._pick_lock:
            # quarantined tables are pick-excluded exactly like locked ones:
            # rewriting them would read the corrupt bytes and fail forever
            picked = self.compactor.pick(
                db.versions.locked_files() | db.versions.quarantined_files()
            )
            if picked is None:
                return None
            level, inputs, overlaps = picked
            if not db.versions.try_lock_files(
                [f.file_no for f in inputs + overlaps]
            ):  # pragma: no cover - pick() already excluded locked files
                return None
            return picked

    def _job_done(self, job: Job) -> None:
        db = self.db
        with db.mutex:
            db.writer_cv.notify_all()  # stalled writers re-check triggers
        self.maybe_schedule()

    # -- job bodies -------------------------------------------------------
    def _flush_job(self) -> None:
        db = self.db
        try:
            with db.mutex:
                mem = db.immutables[0] if db.immutables else None
            if mem is not None:
                res = db.errors.run_job(
                    lambda: self.compactor.flush_memtable(mem), "flush"
                )
                if res is JOB_ABORTED:
                    return  # immutable stays queued for the next edge
                with db.mutex:
                    # crash-close may have cleared the list under us
                    if db.immutables and db.immutables[0] is mem:
                        db.immutables.pop(0)
        finally:
            with self._state_lock:
                self._flush_inflight = False

    def _compaction_job(self, picked) -> None:
        level, inputs, overlaps = picked
        db = self.db
        try:
            db.errors.run_job(
                lambda: self.compactor.run(
                    level, inputs, overlaps, subtasks=self.run_subtasks
                ),
                "compaction",
            )
        finally:
            db.versions.unlock_files([f.file_no for f in inputs + overlaps])
            with self._state_lock:
                self._compactions_inflight -= 1

    def _maybe_schedule_gc(self) -> None:
        db = self.db
        cfg = db.cfg
        # auto-GC needs a second low-priority thread: the pass occupies one
        # for its whole duration, and compactions must keep draining L0 or
        # GC's own rewrites could hard-stall against a pool with no room.
        # The _closed check keeps close()'s drain from launching a fresh
        # full-keyspace GC scan that would only bail at its first file.
        if (
            not cfg.gc_auto
            or self._stopping
            or getattr(db, "_closed", False)
            or cfg.background_threads < 2
            # replicas never GC: their value files mirror the primary's id
            # space byte for byte, and a local rewrite would fork it — the
            # primary's own GC rewrites arrive through the stream instead
            or getattr(db, "_role", "primary") != "primary"
            # a primary with live followers pauses auto-GC too: GC moves
            # value bytes to new file ids without shipping WAL records, so
            # already-shipped pointers would dangle on the replica side.
            # Detach (or rebootstrap) resumes reclamation.
            or (getattr(db, "_repl", None) is not None and db._repl.active)
        ):
            return
        with self._state_lock:
            if self._gc_inflight:
                return
            live = {q.file_id for q in db.bvalue.queues} | set(
                db.versions.quarantined_bvalues
            )
            cands = db.dead_tracker.candidates(cfg.gc_dead_ratio_trigger, exclude=live)
            if not cands:
                return
            if (
                self._gc_stuck is not None
                and db.dead_tracker.signature(cands) == self._gc_stuck
            ):
                return  # same uncollectable set a full pass just failed on
                # (more deaths in these files change the signature → retry)
            self._gc_inflight = True
        if not self.sched.submit("gc", self._gc_job, PRI_LOW, "gc"):
            with self._state_lock:
                self._gc_inflight = False

    def _gc_job(self) -> None:
        """One auto-GC slice: rewrite at most ``gc_slice_bytes`` of live
        values, then yield the LOW thread — the completion edge schedules
        the next slice (which resumes this slice's work list, no repeated
        keyspace scan) while compactions interleave, so one huge candidate
        file can't monopolize a background thread for seconds."""
        from .gc import BValueGC

        db = self.db
        try:
            with self._gc_lock:
                gc = BValueGC(
                    db,
                    db.cfg.gc_dead_ratio_trigger,
                    max_rewrite_bytes=db.cfg.gc_slice_bytes,
                    resume=self._gc_resume,
                )
                res = db.errors.run_job(gc.collect, "gc")
                if res is JOB_ABORTED:
                    # a corrupt file was quarantined mid-pass; keep the
                    # progress counters the pass banked before aborting
                    res = gc._stats()
                self._gc_resume = gc.resume_state
            if res["sliced"]:
                db.stats.add("gc_slices")
            # rewritten_bytes counts every successful move (collected_files
            # only files actually unlinked): a pass that relocated values
            # but couldn't prove any file clean still made progress
            progressed = (
                res["sliced"] or res["collected_files"] or res["rewritten_bytes"]
            )
            with self._state_lock:
                if progressed:
                    self._gc_stuck = None
                else:
                    live = {q.file_id for q in db.bvalue.queues} | set(
                        db.versions.quarantined_bvalues
                    )
                    self._gc_stuck = db.dead_tracker.signature(
                        db.dead_tracker.candidates(
                            db.cfg.gc_dead_ratio_trigger, exclude=live
                        )
                    )
        finally:
            with self._state_lock:
                self._gc_inflight = False

    def submit_scrub(self) -> bool:
        """Queue one integrity scrub (``DB.verify_integrity``) on the
        low-priority pool; its block/value reads are additionally paced by
        the shared I/O token bucket at PRI_LOW."""
        db = self.db
        return self.sched.submit(
            "scrub", lambda: db.errors.run_job(db._scrub, "scrub"), PRI_LOW, "scrub"
        )

    def run_gc(self, threshold: float, max_rewrite_bytes: int = 0) -> dict:
        """One GC pass (``max_rewrite_bytes`` > 0 = one paced slice);
        shared lock means a manual ``gc_collect`` and the auto-triggered
        job can never run concurrently."""
        from .gc import BValueGC

        with self._gc_lock:
            return BValueGC(self.db, threshold, max_rewrite_bytes).collect()

    # -- subcompactions ---------------------------------------------------
    def run_subtasks(self, fns: list) -> list:
        """Run shard thunks for one compaction: the calling job thread
        executes the first shard itself; the rest go to a small shared
        pool (concurrent compaction jobs share it — shards are pure
        functions, so queuing behind each other cannot deadlock)."""
        if len(fns) == 1:
            return [fns[0]()]
        with self._state_lock:  # two jobs racing the lazy init would leak
            if self._subpool is None:  # the loser's executor thread
                from concurrent.futures import ThreadPoolExecutor

                self._subpool = ThreadPoolExecutor(
                    max_workers=max(1, self.db.cfg.max_subcompactions - 1),
                    thread_name_prefix="lsm-subcompact",
                )
        futs = [self._subpool.submit(fn) for fn in fns[1:]]
        out = [fns[0]()]
        out.extend(f.result() for f in futs)
        return out

    # -- idle / lifecycle -------------------------------------------------
    def _idle_locked(self, compactions: bool) -> bool:
        db = self.db
        if db.immutables or self._flush_inflight or self._repl_inflight:
            return False
        if self.sched._outstanding[PRI_HIGH] > 0:
            return False
        if compactions:
            if self.sched._outstanding[PRI_LOW] > 0:
                return False
            if self._compactions_inflight or self._gc_inflight:
                return False
        return True

    def wait_idle(self, compactions: bool = True, timeout: float = 120.0) -> None:
        """Block until background work is quiescent — CV-signalled by job
        completion, no sleep-polling and no ``pick()`` probing while idle
        (scheduling is exhaustive at every completion edge)."""
        deadline = time.monotonic() + timeout
        self.maybe_schedule()
        with self.sched.condition:
            while True:
                if self.sched.error is not None:
                    raise BackgroundError("background job failed") from self.sched.error
                if self._idle_locked(compactions):
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("wait_idle timed out")
                # bounded wait only as a safety net against lost wakeups
                self.sched.condition.wait(timeout=min(remaining, 1.0))

    def stop(self, crash: bool = False) -> None:
        """Shut the pool down. Non-crash: drain all queued/produced work
        first (close() semantics: pending flushes and compactions finish).
        Crash: discard queued jobs; running ones complete."""
        if not crash:
            try:
                self.wait_idle(compactions=True, timeout=60.0)
            except (TimeoutError, RuntimeError):
                pass
        self._stopping = True
        self.sched.stop(discard_queued=crash)
        if self._subpool is not None:
            self._subpool.shutdown(wait=True)
