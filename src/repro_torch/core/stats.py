"""Engine statistics: byte counters per I/O class (wal / flush / compaction /
bvalue), stall accounting, and a throughput timeline recorder used to
reproduce the paper's Fig. 2 / Fig. 9 instant-vs-average plots.

``write_amp`` = total device bytes / user payload bytes — the paper's core
metric.

Group-commit accounting (write pipeline): ``record_group`` tracks a
power-of-two histogram of writers-per-group, and ``fsyncs_per_write``
(= (wal_fsyncs + bvalue_fsyncs) / user_writes) measures how well the
leader/follower commit amortizes durability barriers — 1.0 means every
write paid its own fsync; well-batched sync workloads sit far below 0.5.

Pipelined-commit accounting (write pipeline v2): ``record_pipeline_depth``
histograms the number of commit groups in flight at group-formation time
(a max > 1 proves fsync/encode overlap actually happened), and the
``gauges`` dict carries the adaptive controller's live state —
``wal_group_effective_bytes`` (current latency-targeted byte cap) and
``wal_persist_ewma_s`` (smoothed group persist latency). ``wal_fsync_skips``
counts groups whose durability was covered by a later-started fsync.
"""
from __future__ import annotations

import random
import threading
import time
from collections import defaultdict


class EngineStats:
    """Thread-safe engine counters; read a consistent copy via ``snapshot()``.

    Counter names (``snapshot()`` keys; all monotonic):

    * ``user_writes`` / ``user_bytes`` — acknowledged entries / payload
    * ``wal_bytes`` / ``wal_records`` / ``wal_fsyncs`` — WAL I/O;
      ``wal_fsync_skips`` — groups covered by a later-started fsync
    * ``bvalue_bytes`` / ``bvalue_fsyncs`` — BValue store I/O
    * ``flush_bytes`` / ``flush_count`` — MemTable→L0 flushes
    * ``compaction_bytes`` / ``compaction_read_bytes`` / ``compaction_count``
    * ``trivial_moves`` / ``trivial_move_bytes`` — no-overlap files promoted
      by manifest edit alone (zero rewrite); ``compaction_bytes_written`` /
      ``user_bytes_written`` — aliases of ``compaction_bytes`` /
      ``user_bytes`` (the write-amp benchmark's canonical names)
    * ``gc_slices`` — auto-GC passes that yielded early on the slice budget
    * ``group_commits`` / ``group_writers`` / ``group_entries`` — group
      commit totals; ``memtable_shard_applies`` — groups applied sharded
    * ``job_{flush,compaction,gc}_count`` (+ the ``jobs`` table with wall
      seconds per kind) — background scheduler jobs; ``subcompactions`` —
      key-range shards fanned out by partitioned compactions
    * ``rate_limiter_waits`` / ``rate_limiter_wait_seconds`` — background
      I/O token-bucket backpressure; ``rate_limiter_fg_bytes`` — foreground
      value-log bytes charged to the unified budget (accounted, never
      blocked)
    * ``wal_truncated_bytes`` — torn WAL tail bytes truncated at recovery
    * ``bg_retries`` — transient background-job errors retried with backoff;
      ``bg_errors_hard`` / ``bg_errors_transient_exhausted`` — errors that
      latched the DB read-only; ``resumes`` — successful ``DB.resume()``
      calls clearing the latch
    * ``corruptions_detected`` / ``files_quarantined`` — CRC-verified reads
      that failed and the files quarantined for it
    * ``stall_stop_seconds`` / ``stall_delay_seconds`` — hard stops vs
      delayed-write-controller delays; ``stall_hist`` (pow2 ms bucket →
      count) and ``stall_p99_ms`` — the stall tail
    * ``block_cache_hits`` / ``block_cache_misses`` /
      ``block_cache_evictions`` / ``block_cache_bytes`` /
      ``block_cache_entries`` / ``block_cache_hit_rate`` — shared block
      cache (pulled live from the registered BlockCache; all-zero when the
      cache is disabled). Every ratio in ``snapshot()`` reads 0.0 on a
      fresh DB rather than dividing by zero.

    Derived (properties, also in ``snapshot()``): ``device_bytes``,
    ``write_amp``, ``fsyncs_per_write``, ``avg_group_size``,
    ``pipeline_depth_max``. Structures: ``group_size_hist`` (pow2 bucket →
    count), ``pipeline_depth_hist`` (depth → count), ``gauges`` (last-value,
    e.g. ``wal_group_effective_bytes`` / ``wal_persist_ewma_s``),
    ``timeline`` (t, acked bytes) feeding ``interval_throughput``, and
    stall accounting (``stall_seconds`` / ``stall_events``).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: dict[str, int] = defaultdict(int)
        self.stall_seconds = 0.0
        self.stall_events = 0
        self._t0 = time.monotonic()
        self.timeline: list[tuple[float, int]] = []  # (t, user_bytes_acked)
        self.group_size_hist: dict[int, int] = defaultdict(int)  # pow2 bucket -> count
        self.pipeline_depth_hist: dict[int, int] = defaultdict(int)  # depth -> count
        self.stall_hist: dict[int, int] = defaultdict(int)  # pow2 ms bucket -> count
        self._stall_samples: list[float] = []  # capped reservoir for p99
        self.job_seconds: dict[str, float] = defaultdict(float)  # kind -> wall s
        self.gauges: dict[str, float] = {}  # last-value gauges (adaptive caps, ...)
        self._block_cache = None  # BlockCache; its counters merge into snapshot()

    def register_block_cache(self, cache) -> None:
        """Attach the DB's shared BlockCache so ``snapshot()`` carries its
        hit/miss/eviction counters (the cache keeps them shard-local for
        lock-free-ish reads; we pull on demand instead of pushing per-get)."""
        self._block_cache = cache

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def add_stall(self, seconds: float, kind: str = "stall") -> None:
        """One writer stall/delay event. ``kind`` splits hard stops from
        controller delays (``stall_stop_seconds`` / ``stall_delay_seconds``)
        and every event lands in the pow2-millisecond ``stall_hist`` plus a
        capped sample reservoir feeding ``stall_p99_ms``."""
        with self._lock:
            self.stall_seconds += seconds
            self.stall_events += 1
            self.counters[f"stall_{kind}_seconds"] += seconds
            ms = seconds * 1e3
            self.stall_hist[1 << max(0, int(ms).bit_length())] += 1
            # true reservoir sample: every event over the run has equal
            # probability of being retained, so stall_p99_ms reflects the
            # whole run, not just its first 10k events
            if len(self._stall_samples) < 10_000:
                self._stall_samples.append(seconds)
            else:
                j = random.randrange(self.stall_events)
                if j < 10_000:
                    self._stall_samples[j] = seconds

    def record_job(self, kind: str, seconds: float) -> None:
        """Completion of one background job (flush/compaction/gc): counts
        and total wall seconds per kind feed the ``jobs`` snapshot table."""
        with self._lock:
            self.counters[f"job_{kind}_count"] += 1
            self.job_seconds[kind] += seconds

    def stall_p99_ms(self) -> float:
        with self._lock:
            samples = sorted(self._stall_samples)
        if not samples:
            return 0.0
        return samples[min(len(samples) - 1, int(len(samples) * 0.99))] * 1e3

    def mark_user_write(self, nbytes: int) -> None:
        self.mark_user_writes(1, nbytes)

    def mark_user_writes(self, count: int, nbytes: int) -> None:
        """Bulk ack: one lock acquisition + one timeline point per group."""
        with self._lock:
            self.counters["user_writes"] += count
            self.counters["user_bytes"] += nbytes
            self.timeline.append((time.monotonic() - self._t0, self.counters["user_bytes"]))

    def record_group(self, n_writers: int, n_entries: int) -> None:
        """One group commit: n_writers batches merged into one WAL write."""
        with self._lock:
            self.counters["group_commits"] += 1
            self.counters["group_writers"] += n_writers
            self.counters["group_entries"] += n_entries
            self.group_size_hist[1 << max(0, n_writers - 1).bit_length()] += 1

    def record_pipeline_depth(self, depth: int) -> None:
        """Commit groups in flight (incl. this one) when a group formed."""
        with self._lock:
            self.pipeline_depth_hist[depth] += 1

    def set_gauge(self, name: str, value: float) -> None:
        """Publish a last-value gauge (e.g. the adaptive group-size cap)."""
        with self._lock:
            self.gauges[name] = value

    @property
    def pipeline_depth_max(self) -> int:
        return max(self.pipeline_depth_hist, default=0)

    @property
    def device_bytes(self) -> int:
        c = self.counters
        return (
            c["wal_bytes"]
            + c["flush_bytes"]
            + c["compaction_bytes"]
            + c["bvalue_bytes"]
        )

    @property
    def write_amp(self) -> float:
        user = self.counters["user_bytes"]
        return self.device_bytes / user if user else 0.0

    @property
    def fsyncs_per_write(self) -> float:
        # fresh DB (zero writes) must read 0.0, never ZeroDivisionError
        writes = self.counters["user_writes"]
        syncs = self.counters["wal_fsyncs"] + self.counters["bvalue_fsyncs"]
        return syncs / writes if writes else 0.0

    @property
    def avg_group_size(self) -> float:
        groups = self.counters["group_commits"]
        return self.counters["group_writers"] / groups if groups else 0.0

    @property
    def block_cache_hit_rate(self) -> float:
        if self._block_cache is None:
            return 0.0
        return self._block_cache.stats()["block_cache_hit_rate"]

    def interval_throughput(self, interval_s: float = 10.0) -> list[tuple[float, float]]:
        """(t_end, MB/s) per interval — the paper's 10-second instant curve."""
        out = []
        if not self.timeline:
            return out
        t_end = interval_s
        prev_bytes = 0
        i = 0
        last_t = self.timeline[-1][0]
        while t_end <= last_t + interval_s:
            while i < len(self.timeline) and self.timeline[i][0] <= t_end:
                i += 1
            cur = self.timeline[i - 1][1] if i > 0 else 0
            out.append((t_end, (cur - prev_bytes) / interval_s / 1e6))
            prev_bytes = cur
            t_end += interval_s
        return out

    def snapshot(self) -> dict:
        with self._lock:
            d = dict(self.counters)
            hist = dict(sorted(self.group_size_hist.items()))
            depth_hist = dict(sorted(self.pipeline_depth_hist.items()))
            stall_hist = dict(sorted(self.stall_hist.items()))
            jobs = {
                kind: {
                    "count": self.counters.get(f"job_{kind}_count", 0),
                    "seconds": secs,
                }
                for kind, secs in sorted(self.job_seconds.items())
            }
            gauges = dict(self.gauges)
        for k in (
            "wal_bytes",
            "flush_bytes",
            "compaction_bytes",
            "bvalue_bytes",
            "user_bytes",
            "user_writes",
            "wal_fsyncs",
            "bvalue_fsyncs",
            "group_commits",
        ):
            d.setdefault(k, 0)
        d["device_bytes"] = self.device_bytes
        d["write_amp"] = self.write_amp
        d["stall_seconds"] = self.stall_seconds
        d["stall_events"] = self.stall_events
        d.setdefault("wal_fsync_skips", 0)
        d["fsyncs_per_write"] = self.fsyncs_per_write
        d["avg_group_size"] = self.avg_group_size
        d["group_size_hist"] = hist
        d["pipeline_depth_hist"] = depth_hist
        d["pipeline_depth_max"] = max(depth_hist, default=0)
        d["stall_hist"] = stall_hist
        d["stall_p99_ms"] = self.stall_p99_ms()
        d["jobs"] = jobs
        d.setdefault("rate_limiter_waits", 0)
        d.setdefault("rate_limiter_wait_seconds", 0.0)
        d.setdefault("rate_limiter_fg_bytes", 0)
        d.setdefault("subcompactions", 0)
        d.setdefault("trivial_moves", 0)
        d.setdefault("trivial_move_bytes", 0)
        d.setdefault("gc_slices", 0)
        d.setdefault("wal_truncated_bytes", 0)
        d.setdefault("bg_retries", 0)
        d.setdefault("bg_errors_hard", 0)
        d.setdefault("bg_errors_transient_exhausted", 0)
        d.setdefault("corruptions_detected", 0)
        d.setdefault("files_quarantined", 0)
        for k in (
            "repl_batches_shipped",
            "repl_bytes_shipped",
            "repl_batches_applied",
            "repl_frames_corrupt",
            "repl_frames_duplicate",
            "repl_catchups",
            "repl_crc_checks",
            "repl_divergence_detected",
            "repl_rebootstraps",
            "repl_ship_errors",
            "repl_lag_warnings",
            "repl_wals_retained",
            "repl_value_fetch_misses",
            "promotions",
        ):
            d.setdefault(k, 0)
        d.setdefault("resumes", 0)
        # canonical names for the write-amp trajectory (BENCH_writeamp.json):
        # device bytes compaction wrote vs. bytes the user actually stored
        d["compaction_bytes_written"] = d["compaction_bytes"]
        d["user_bytes_written"] = d["user_bytes"]
        d["gauges"] = gauges
        if self._block_cache is not None:
            d.update(self._block_cache.stats())
        else:
            d.update(
                block_cache_hits=0, block_cache_misses=0, block_cache_evictions=0,
                block_cache_bytes=0, block_cache_entries=0, block_cache_hit_rate=0.0,
                block_cache_promotions=0, block_cache_ghost_hits=0,
                block_cache_a1_bytes=0,
            )
        return d

    # ``db.stats`` is this object (attribute access keeps working for every
    # existing caller); making it callable lets ``db.stats()`` satisfy the
    # KVStore protocol's ``stats() -> dict`` the same way ShardedDB's real
    # method does.
    __call__ = snapshot
