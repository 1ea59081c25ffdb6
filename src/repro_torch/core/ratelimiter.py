"""Shared token-bucket rate limiter — one device model for every byte.

Every background byte written — compaction output, MemTable→L0 flush, GC
value rewrites — draws tokens from one bucket (``DBConfig.
bg_io_bytes_per_sec``), so a compaction burst can never monopolize the
device bandwidth the foreground WAL/BValue fsyncs need. This is the
RocksDB ``GenericRateLimiter`` idea, simplified:

* The bucket refills continuously at ``bytes_per_sec`` up to a small burst
  allowance; a request may drive the balance negative (deficit model), in
  which case *later* requests wait for the balance to recover — large
  writes are never split, they just push their cost onto the next caller.
* Three priorities, in descending order of entitlement:

  - ``PRI_FG`` (foreground value-log writes, WAL-time separation): charged
    but **never blocked** — a user write must not stall on a background
    budget. Instead the limiter folds foreground traffic into an EWMA
    bytes/sec estimate and *shrinks the refill* available to background
    work to ``rate - fg_rate`` (floored at ``bg_min_fraction * rate``), so
    value-log and compaction I/O genuinely share one device budget. The
    instantaneous deficit a FG charge may create is clamped to one burst —
    foreground awareness must dampen background work, not wedge it behind
    an unbounded debt.
  - ``PRI_HIGH`` (flush — it unblocks writers, so making it wait would
    turn background throttling into foreground stop-stalls): *accounted
    but never blocked*; its deficit pushes back on LOW.
  - ``PRI_LOW`` (compaction / GC): queues FIFO until the balance recovers.
    GC's value rewrites **inherit** this priority when they re-enter the
    foreground write path (priority inheritance — the charge belongs to
    the initiator, not the code path).
* ``bytes_per_sec == 0`` disables limiting entirely: ``request`` is a
  no-op, so the default configuration has zero overhead.

Waits are accounted to ``EngineStats`` (``rate_limiter_waits`` /
``rate_limiter_wait_seconds``; foreground charges under
``rate_limiter_fg_bytes``) so the stability and write-amp benchmarks can
show how much work was deferred and how the device budget split.
"""
from __future__ import annotations

import threading
import time
from collections import deque

PRI_HIGH = 0  # flush: unblocks foreground writers
PRI_LOW = 1  # compaction / GC: pure background
PRI_FG = 2  # foreground value-log writes: shape the budget, never block

#: background writers charge the limiter in chunks of at most this many
#: bytes, so a single huge request can't stall the bucket for seconds
IO_CHUNK = 256 << 10

#: seconds of smoothing on the foreground bytes/sec estimate
_FG_EWMA_TAU_S = 1.0


class RateLimiter:
    def __init__(
        self,
        bytes_per_sec: int,
        refill_period_s: float = 0.005,
        stats=None,
        bg_min_fraction: float = 0.1,
    ):
        self.rate = int(bytes_per_sec)
        self._period = refill_period_s
        self._stats = stats
        self._bg_min_fraction = bg_min_fraction
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._waiters: deque = deque()  # LOW requests, FIFO
        self._available = float(max(0, self.rate) * refill_period_s)
        self._burst = max(float(IO_CHUNK), self.rate * 0.05)
        self._last_refill = time.monotonic()
        # foreground-awareness state: bytes charged at PRI_FG since the
        # last refill edge, and the smoothed foreground bytes/sec they
        # imply (shrinks the background refill)
        self._fg_acc = 0
        self._fg_rate = 0.0

    @property
    def enabled(self) -> bool:
        return self.rate > 0

    def fg_rate_estimate(self) -> float:
        """Smoothed foreground (PRI_FG) bytes/sec — observability."""
        with self._lock:
            return self._fg_rate

    def request(self, nbytes: int, priority: int = PRI_LOW) -> float:
        """Block until ``nbytes`` of I/O budget is granted.

        Returns the seconds spent waiting (0.0 on the fast path; FG and
        HIGH never wait). Unlimited (rate 0) or non-positive requests
        return immediately.
        """
        if self.rate <= 0 or nbytes <= 0:
            return 0.0
        me = object()
        t0 = None
        with self._cv:
            if priority == PRI_FG:
                # account + adapt, never wait: the EWMA shrinks the
                # background refill; the immediate deficit an FG charge
                # adds is clamped to one burst so FG bursts dampen LOW
                # instead of wedging it — but the clamp must never RAISE
                # a balance a HIGH/LOW deficit already drove deeper, or
                # foreground traffic would erase the pushback on
                # background work instead of adding to it
                self._fg_acc += nbytes
                self._refill_locked()
                self._available = min(
                    self._available, max(self._available - nbytes, -self._burst)
                )
                if self._stats is not None:
                    self._stats.add("rate_limiter_fg_bytes", nbytes)
                return 0.0
            if priority == PRI_HIGH:
                # charge the bucket but never wait: the deficit defers
                # queued LOW work instead of stalling the flush path
                self._refill_locked()
                self._available -= nbytes
                return 0.0
            self._waiters.append(me)
            while True:
                self._refill_locked()
                if self._available > 0.0 and self._waiters[0] is me:
                    self._available -= nbytes  # may go negative: deficit
                    self._waiters.popleft()
                    self._cv.notify_all()
                    break
                if t0 is None:
                    t0 = time.monotonic()
                # wake at the next refill edge (or when the head changes)
                self._cv.wait(timeout=self._period)
        if t0 is None:
            return 0.0
        waited = time.monotonic() - t0
        if self._stats is not None:
            self._stats.add("rate_limiter_waits")
            self._stats.add("rate_limiter_wait_seconds", waited)
        return waited

    def _refill_locked(self) -> None:
        now = time.monotonic()
        dt = now - self._last_refill
        if dt <= 0:
            return
        # fold foreground bytes into the smoothed fg bytes/sec estimate
        alpha = min(1.0, dt / _FG_EWMA_TAU_S)
        self._fg_rate = (1.0 - alpha) * self._fg_rate + alpha * (self._fg_acc / dt)
        self._fg_acc = 0
        effective = max(self.rate * self._bg_min_fraction, self.rate - self._fg_rate)
        self._available = min(self._burst, self._available + dt * effective)
        self._last_refill = now
