"""DBConfig — one config selects among the paper's three systems.

``separation_mode``:

* ``"none"``  — RocksDB baseline: values ride WAL → MemTable → every level.
* ``"flush"`` — BlobDB/WiscKey baseline: separation at MemTable→L0 flush
  (full value still in WAL + MemTable).
* ``"wal"``   — **BVLSM**: separation before the WAL append; only
  Key-ValueOffset goes downstream.

``wal_mode``: ``"sync" | "async" | "off"`` — the paper's R-WS/R-WA/R-WO axes.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(slots=True)
class DBConfig:
    """Every engine knob, grouped by subsystem. The full table — each knob,
    its default, and one line of meaning — lives in
    ``docs/ARCHITECTURE.md``; the constructors ``rocksdb_like`` /
    ``blobdb_like`` / ``bvlsm`` pin ``separation_mode`` to the paper's
    three systems."""
    # --- the paper's variable ---
    separation_mode: str = "wal"  # none | flush | wal
    value_threshold: int = 4096  # bytes; >= threshold → separated
    # --- durability ---
    wal_mode: str = "sync"  # sync | async | off
    wal_flush_interval_s: float = 0.05
    wal_flush_bytes: int = 1 << 20
    # --- write pipeline (RocksDB-style leader/follower group commit) ---
    # When enabled, concurrent writers enqueue and the queue head ("leader")
    # commits every queued batch with ONE WAL write + fsync, then applies all
    # entries to the MemTable in bulk. False restores the pre-pipeline
    # one-record-one-fsync path (benchmark baseline).
    wal_group_commit: bool = True
    wal_group_max_batches: int = 128  # max writers merged into one group
    wal_group_max_entries: int = 4096  # max KV entries per group
    wal_group_max_bytes: int = 4 << 20  # hard ceiling on WAL payload bytes/group
    # --- pipelined commit (write pipeline v2) ---
    # The leader hands the writer queue off as soon as it has drained its
    # group: the next leader encodes + writes its WAL batch while the
    # previous group's fsync is still in flight. Groups publish (memtable
    # apply + follower wakeup) strictly in sequence order. False restores
    # the single-outstanding-group pipeline (≡ depth 1).
    wal_pipelined_commit: bool = True
    wal_pipeline_depth: int = 4  # max commit groups in flight at once
    # don't hand off into a near-empty queue: while an earlier group is
    # still in flight, a new group only forms once this many writers are
    # queued (or the pipeline drains) — tiny groups would pay full
    # per-group overhead for no extra amortization.
    wal_pipeline_min_fill: int = 4
    # --- adaptive group sizing ---
    # Replaces the fixed byte cap with a latency-target controller: the
    # effective cap grows (×1.5) while the persist-latency EWMA sits under
    # half the target and shrinks (×0.7) when it overshoots, clamped to
    # [wal_group_min_bytes, wal_group_max_bytes]. Entry/batch caps above
    # stay as hard ceilings.
    wal_group_adaptive: bool = True
    wal_group_target_latency_s: float = 0.004  # persist (write+fsync) target
    wal_group_min_bytes: int = 32 << 10  # adaptive cap floor
    wal_group_init_bytes: int = 256 << 10  # adaptive cap starting point
    # --- memtable ---
    memtable_size: int = 8 << 20  # paper: 128 MiB; scaled default for tests
    max_immutables: int = 2  # paper setup: 1 immutable (+5 mutable pool)
    # sharded apply: a commit group with at least this many entries is
    # partitioned by key hash across a small worker pool instead of applied
    # serially (0 disables). Keys never split across shards, so the result
    # is identical to the serial apply.
    memtable_shard_apply_entries: int = 4096
    memtable_apply_shards: int = 4
    # --- levels / compaction ---
    num_levels: int = 7
    l0_compaction_trigger: int = 4
    l0_slowdown_trigger: int = 8
    l0_stop_trigger: int = 12
    level1_max_bytes: int = 64 << 20
    level_size_multiplier: int = 10
    max_compaction_input_bytes: int = 256 << 20
    # --- write-amp-aware compaction picking ---
    # "overlap": among levels over their trigger, pick the candidate whose
    # job moves the most bytes per byte rewritten (urgency discounted by
    # 1 + overlap_bytes/input_bytes, the job's write amplification).
    # "fullness": the legacy policy — hottest level first, round-robin file
    # pointer within the level (the write-amp benchmark's ablation baseline).
    compaction_pick_policy: str = "overlap"  # overlap | fullness
    # a picked file with ZERO overlap at the target level is promoted by a
    # manifest edit alone — no read, no rewrite, no new tables. False
    # restores rewrite-everything (ablation baseline).
    trivial_move: bool = True
    # a trivial move is skipped (the file is rewritten instead) when the
    # moved file would overlap more than this many grandparent-level bytes
    # — parking a wide file at Ln+1 just makes the future Ln+1→Ln+2 job
    # more expensive than the rewrite it avoided. 0 = no limit.
    trivial_move_max_gp_bytes: int = 64 << 20
    # --- background job scheduler ---
    # flush jobs run on a dedicated high-priority pool so a long compaction
    # can never starve the flush that unblocks writers; compaction and GC
    # jobs share the low-priority pool (its width is also the cap on
    # concurrent compaction jobs — inputs are lock-disjoint).
    flush_threads: int = 1
    background_threads: int = 2
    # one compaction splits its key range into up to this many shards, each
    # merging + writing its own output tables; all shards commit as one
    # atomic manifest edit. 1 disables partitioning.
    max_subcompactions: int = 2
    # adaptive shard count: the number of shards is chosen from the live
    # input size and the historical per-shard merge throughput (EWMA), so
    # tiny compactions run unsharded (no fan-out overhead) and huge ones
    # use the full budget. False always fans out to max_subcompactions.
    subcompaction_adaptive: bool = True
    # target wall time for one shard: shards sized ewma_bytes_per_s × this
    subcompaction_target_seconds: float = 0.5
    # floor on the per-shard input size (also the pre-history default
    # target): inputs below this never shard at all
    subcompaction_min_bytes: int = 256 << 10
    # --- background I/O rate limiter ---
    # shared token bucket for every background byte written (compaction
    # output, flush, GC rewrites); flushes draw at high priority. 0 =
    # unlimited (limiter disabled, zero overhead).
    bg_io_bytes_per_sec: int = 0
    bg_io_refill_period_s: float = 0.005
    # unified device model: foreground BValue queue writes (WAL-time value
    # separation) charge the same token bucket at a foreground priority
    # that is accounted but never blocked — sustained value-log traffic
    # shrinks the refill available to compaction/GC (floored at
    # bg_io_min_fraction) instead of the two competing blindly for the
    # device. GC's value rewrites inherit LOW priority (they block on the
    # bucket like any background work). False restores the
    # background-only budget.
    unified_io_budget: bool = True
    # fraction of the bucket rate background work always keeps, no matter
    # how hard the foreground writes (starvation floor)
    bg_io_min_fraction: float = 0.1
    # --- delayed-write controller (replaces binary slowdown stalls) ---
    # above l0_slowdown_trigger / soft_pending_compaction_bytes, writers pay
    # a per-byte delay at a rate that decays ×0.8 while the backlog grows
    # and recovers ×1.25 as compaction catches up; at l0_stop_trigger /
    # hard_pending_compaction_bytes they block outright.
    delayed_write_rate: int = 32 << 20  # initial/max delayed rate, bytes/s
    delayed_write_min_rate: int = 1 << 20  # decay floor
    soft_pending_compaction_bytes: int = 64 << 20
    hard_pending_compaction_bytes: int = 256 << 20
    # overlap-aware debt estimate: pending-compaction bytes count not just
    # each level's excess but the target- and grandparent-level bytes the
    # excess will drag through rewrites on its way down (cascaded, each
    # step's overlap ratio clamped at level_size_multiplier) — the
    # controller sees real write debt instead of just displaced bytes.
    # False restores the excess-only estimate.
    pending_debt_overlap_aware: bool = True
    # --- background BValue GC ---
    # when enabled, a GC pass is scheduled (low priority) as soon as a
    # sealed BValue file's dead ratio crosses the trigger — typically right
    # after a compaction drops superseded pointers. The manual
    # ``DB.gc_collect`` API stays as a synchronous wrapper either way.
    gc_auto: bool = False
    gc_dead_ratio_trigger: float = 0.7
    # auto-GC pacing: one scheduled GC job rewrites at most this many live
    # bytes, then yields its LOW thread; the remaining candidates are
    # picked up by follow-up job slices (scheduled at the completion
    # edge), so one huge candidate file can't monopolize a background
    # thread for seconds. 0 = unsliced (one job runs the whole pass).
    # Manual ``gc_collect`` is always unsliced.
    gc_slice_bytes: int = 8 << 20
    # --- sstable ---
    block_size: int = 4096
    compression: bool = False
    # on-disk block format the WRITERS emit: 4 = v3 + prefix-compressed
    # keys inside restart intervals, 3 = v2 + range-tombstone side block
    # and multi-version (user_key, seq desc) runs, 2 = restart-point blocks
    # (intra-block binary search), 1 = the pre-restart linear format.
    # Readers always decode all four, so mixed-version DB directories are
    # fine — but range deletes require v3+ (delete_range raises below it).
    sstable_format_version: int = 4
    block_restart_interval: int = 16  # entries per restart point (v2 blocks)
    # --- batched reads ---
    # DB.multi_get slices caller batches to this size so one huge batch
    # can't pin a version/memtable set for an unbounded stretch.
    multi_get_max_batch: int = 1024
    # --- MVCC: snapshots / cursors / range deletes / checkpoint ---
    # hard cap on concurrently live Snapshot objects (cursors pin one
    # each). Every live snapshot widens memtable/compaction version
    # retention, so an unbounded leak would grow space forever; exceeding
    # the cap raises instead of silently degrading.
    max_snapshots: int = 1024
    # compaction clips range tombstones at output-table boundaries, which
    # fragments a wide delete across tables. When True, fragments of the
    # same tombstone (same seq) that touch or overlap are re-coalesced
    # before a table's range block is written, bounding fragmentation
    # growth across repeated compactions.
    range_tombstone_coalesce: bool = True
    # checkpoint(dir) hard-links SSTables + value files into the target
    # directory when the filesystem supports it; False (or a cross-device
    # link error) falls back to copying bytes.
    checkpoint_hardlink: bool = True
    # --- shared block cache (read path) ---
    # LRU over decoded data blocks, shared by gets/scans/compaction across
    # every SSTable, keyed (file_no, block_idx), charged by decoded bytes.
    # 0 disables caching entirely.
    block_cache_bytes: int = 8 << 20
    block_cache_shards: int = 8  # independent lock+LRU shards
    # compaction streams read THROUGH the cache but do not populate it, so
    # a one-shot merge can't evict the foreground working set. False lets
    # compaction warm the cache (useful when compaction output is hot).
    block_cache_compaction_bypass: bool = True
    # admission policy: "2q" (default) holds first-touch blocks in a
    # probationary FIFO (A1in) and only promotes to the main LRU (Am) on
    # re-reference — or on readmission while the block's key is still in
    # the A1out ghost history — so one-shot cursor sweeps can't flush the
    # point-get working set. "lru" restores the plain LRU.
    block_cache_policy: str = "2q"  # 2q | lru
    # fraction of each shard's capacity reserved for the A1in probationary
    # queue (2Q only); the ghost list remembers ~cap/avg_block_size
    # recently evicted probationary keys at zero byte cost.
    block_cache_a1_fraction: float = 0.25
    # charge compaction's block READS against the unified I/O budget at
    # LOW priority when the bucket is enabled (bg_io_bytes_per_sec > 0),
    # so a read-heavy merge can no longer starve foreground unseen. False
    # restores write-only metering.
    compaction_read_metering: bool = True
    # --- BValue multi-queue store (paper §III-C) ---
    num_bvalue_queues: int = 4
    bvalue_dispatch: str = "round_robin"  # round_robin | least_loaded
    bvalue_page_size: int = 4096
    bvalue_batch_bytes: int = 1 << 20
    bvalue_max_file_bytes: int = 256 << 20
    bvalue_gather_window_s: float = 0.02
    # --- BVCache (paper §III-D) ---
    bvcache_bytes: int = 8 << 20  # paper: equal to MemTable capacity
    bvcache_policy: str = "lru"  # lru | lfu
    bvcache_enabled: bool = True  # ablation: False bypasses optimization
    # hits (pinned/unpersisted entries are still consulted — correctness)
    # --- failure handling (docs/ARCHITECTURE.md §Failure model & recovery) ---
    # pluggable filesystem layer: every open/write/fsync/rename/unlink/
    # listdir the engine performs goes through this Env. None = the real
    # filesystem (core.env.DEFAULT_ENV); tests pass a FaultInjectionEnv to
    # inject errors, simulate ENOSPC, drop unsynced writes on simulated
    # crash, and flip bytes for corruption checks.
    env: object | None = None
    # background jobs retry transient I/O errors this many times with
    # exponential backoff (base doubling each attempt, capped, ×jitter in
    # [0.5, 1.5)) before the error escalates to hard and latches the DB
    # read-only. 0 disables retries.
    bg_error_max_retries: int = 3
    bg_error_backoff_ms: float = 20.0
    bg_error_backoff_max_ms: float = 2000.0
    # --- replication (docs/ARCHITECTURE.md §Replication & failover) ---
    # path of the primary this instance follows. Setting it opens the DB as
    # a replica (equivalent to DB(path, cfg, role="replica")): user writes
    # are rejected until promote(), and replication.attach() uses it as the
    # default source for WAL catch-up reads.
    replica_of: str | None = None
    # target size of one shipped frame: a commit group larger than this is
    # split into multiple frames so a single fault (drop/corrupt) costs at
    # most this many bytes of retransmission via catch-up.
    repl_batch_bytes: int = 256 << 10
    # follower lag (in sequence numbers) above which each apply round bumps
    # the repl_lag_warnings counter — the observability hook a deployment
    # would alarm on.
    repl_lag_warn_seqs: int = 10_000
    # divergence detection: the stream carries a rolling CRC over each run
    # of this many consecutive sequence numbers; the follower folds the
    # same CRC over what it applied and re-bootstraps on mismatch instead
    # of silently forking.
    repl_crc_interval: int = 128
    # --- sharding router (core.sharded.ShardedDB; docs §Sharding) ---
    # each shard gets block_cache_bytes/N and bvcache_bytes/N so a sharded
    # store consumes the same total cache memory the config names. False
    # gives every shard the full budget (N× total memory — deliberate
    # over-provisioning for benchmarks or small N).
    shard_divide_cache_budget: bool = True
    # cross-shard WriteBatch durability log (ROUTER_LOG): once it grows
    # past this size with no batch in flight, the router flushes the
    # shards (their WALs then cover everything logged) and truncates it.
    router_log_max_bytes: int = 4 << 20
    # fan multi-shard operations (write apply, multi_get, flush/checkpoint
    # barriers) across a small thread pool instead of looping serially —
    # per-shard WAL fsyncs overlap. False keeps the router single-threaded
    # (deterministic orderings for debugging).
    router_parallel_fanout: bool = True
    # --- misc ---
    paranoid_checks: bool = False  # CRC-verify SSTable block + BValue reads
    sync_flush_io: bool = True

    def level_max_bytes(self, level: int) -> int:
        if level <= 0:
            return self.l0_compaction_trigger * self.memtable_size
        b = self.level1_max_bytes
        for _ in range(level - 1):
            b *= self.level_size_multiplier
        return b

    @staticmethod
    def rocksdb_like(**kw) -> "DBConfig":
        return DBConfig(separation_mode="none", **kw)

    @staticmethod
    def blobdb_like(**kw) -> "DBConfig":
        return DBConfig(separation_mode="flush", **kw)

    @staticmethod
    def bvlsm(**kw) -> "DBConfig":
        return DBConfig(separation_mode="wal", **kw)
