"""Flush + leveled compaction, run as jobs on the background scheduler.

The write-amplification mechanics the paper targets live here: with
``separation_mode="none"`` every compaction rewrites full values across
levels; with ``"flush"`` (BlobDB) values leave the pipeline at flush time;
with ``"wal"`` (BVLSM) they never enter it. All three modes share this exact
code — the benchmark deltas isolate the separation stage.

Write-amp-aware picking asks one question of every candidate job: how many
bytes must the device rewrite per byte this job actually moves down?

* **Overlap-ratio scoring** (``compaction_pick_policy="overlap"``) — a
  job's write amplification is ``1 + overlap_bytes / input_bytes`` (the
  target-level bytes it drags through the merge). Each over-trigger
  level's urgency (fullness) is discounted by its cheapest job's
  amplification, and within a level the file with the smallest overlap
  ratio is picked — the same debt is cleared for fewer device writes.
  ``"fullness"`` restores the legacy hottest-level / round-robin-file
  policy (the write-amp benchmark's ablation baseline).
* **Trivial moves** — a picked file with zero target-level overlap is
  promoted by ONE manifest edit: no read, no merge, no tables written
  (guarded by a grandparent-overlap cap so a wide file is not parked
  where it makes the next level's future jobs more expensive). Safety
  rests on the per-file locks plus an interval argument: every concurrent
  job's output span is closed over the files it locked at pick time, none
  of which touched the moved file's range — so no later output can
  straddle it and break sorted-level disjointness.

Jitter engineering (the paper's Fig. 9 claim) is layered on top:

* **Lock-aware picking** — :meth:`Compactor.pick` skips files whose
  compaction lock (see :class:`~repro_torch.core.manifest.VersionSet`) is held by
  a running job, so several compaction jobs proceed concurrently on
  disjoint input sets. Levels are tried in descending score order: if the
  hottest level is locked out, the next-most-urgent one runs instead.
* **Partitioned subcompactions** — one level-N→N+1 compaction splits its
  key range at input-file boundaries into up to ``max_subcompactions``
  shards; each shard heap-merges only its range and writes its own output
  tables. All shards commit as ONE atomic manifest edit, so a crash
  mid-subcompaction leaves either the old file set or the new one — never
  a mix (orphan outputs are swept on reopen). The shard count is adaptive
  (``subcompaction_adaptive``): chosen from the live input size and an
  EWMA of historical per-shard merge throughput, so tiny jobs skip the
  fan-out entirely and big ones target ``subcompaction_target_seconds``
  of wall time per shard.
* **Rate-limited writes** — every flush/compaction output byte draws from
  the DB's shared token bucket (:mod:`.ratelimiter`), flushes at high
  priority, compactions at low, so a merge burst cannot starve foreground
  WAL/BValue fsyncs.
"""
from __future__ import annotations

import heapq
import time
from bisect import bisect_left

from .ratelimiter import IO_CHUNK, PRI_HIGH, PRI_LOW
from .record import ValueOffset, kTypeDeletion, kTypeValue, kTypeValuePtr
from .sstable import SSTableWriter, table_path


def _merge_iters(iters):
    """Heap-merge (key, seq, type, value) streams; newest version first per
    key; yields every version (caller dedups)."""
    heap = []
    for i, it in enumerate(iters):
        it = iter(it)
        for key, seq, type_, value in it:
            heapq.heappush(heap, (key, -seq, i, type_, value, it))
            break
    while heap:
        key, nseq, i, type_, value, it = heapq.heappop(heap)
        yield key, -nseq, type_, value
        for k2, s2, t2, v2 in it:
            heapq.heappush(heap, (k2, -s2, i, t2, v2, it))
            break


def _coalesce_tombstones(tombs):
    """Merge same-seq touching/overlapping range-tombstone fragments back
    into maximal runs (compaction clipping fragments them; re-coalescing
    keeps the per-table range blocks from growing without bound). Returns
    a new list sorted by (start, end, seq)."""
    by_seq: dict[int, list[tuple[bytes, bytes]]] = {}
    for seq, start, end in tombs:
        by_seq.setdefault(seq, []).append((start, end))
    out: list[tuple[int, bytes, bytes]] = []
    for seq, frags in by_seq.items():
        frags.sort()
        cs, ce = frags[0]
        for s, e in frags[1:]:
            if s <= ce:
                ce = max(ce, e)
            else:
                out.append((seq, cs, ce))
                cs, ce = s, e
        out.append((seq, cs, ce))
    out.sort(key=lambda t: (t[1], t[2], t[0]))
    return out


class Compactor:
    def __init__(self, db):
        self.db = db  # back-reference; uses db.versions, db.cfg, db.stats
        # historical per-shard merge throughput (EWMA, bytes of input per
        # shard-second) — feeds the adaptive subcompaction shard count
        self._shard_bytes_per_s = 0.0

    # ------------------------------------------------------------------
    # flush
    # ------------------------------------------------------------------
    def flush_memtable(self, mem) -> None:
        db = self.db
        cfg = db.cfg
        limiter = db.rate_limiter
        file_no = db.versions.new_file_no()
        writer = SSTableWriter(
            table_path(db.path, file_no), cfg.block_size, cfg.compression,
            cfg.sstable_format_version, cfg.block_restart_interval,
            env=db.env,
        )
        n_written = 0
        try:
            pending_io = 0
            for key, seq, type_, value in mem.sorted_items():
                if (
                    cfg.separation_mode == "flush"
                    and type_ == kTypeValue
                    and len(value) >= cfg.value_threshold
                ):
                    # BlobDB/WiscKey: separate at flush — value goes to the value
                    # log now; only the pointer reaches L0. Under the unified
                    # budget the BValue dispatch charges the value's bytes
                    # itself, so the flush only accounts the pointer entry here.
                    voff = db.bvalue.put(key, value, sync=cfg.sync_flush_io)
                    enc = voff.encode()
                    writer.add(key, seq, kTypeValuePtr, enc)
                    pending_io += len(key) + (
                        len(enc) if db.bvalue.limiter is not None else len(value)
                    )
                else:
                    writer.add(key, seq, type_, value)
                    pending_io += len(key) + len(value)
                n_written += 1
                if pending_io >= IO_CHUNK:
                    limiter.request(pending_io, PRI_HIGH)
                    pending_io = 0
            limiter.request(pending_io, PRI_HIGH)
            tombs = mem.range_tombstones
            if tombs and cfg.range_tombstone_coalesce:
                tombs = _coalesce_tombstones(tombs)
            if n_written == 0 and not tombs:
                writer.abandon()
                return
            meta = writer.finish(file_no, tombs)
        except BaseException:
            # remove the partial output so a retry of this flush (transient
            # error policy) starts from a clean slate with a fresh file_no
            try:
                writer.abandon()
            except OSError:
                pass
            raise
        db.stats.add("flush_bytes", meta.size)
        db.stats.add("flush_count")
        # value-durability barrier: under a buffered WAL the memtable's
        # ValueOffset entries may point at values still sitting in the
        # BValue queue buffers — the manifest commit below makes those
        # pointers durable, so their values must be durable FIRST, or a
        # crash leaves a live table full of dangling pointers.
        db.bvalue.flush()
        db.versions.log_and_apply(
            {
                "add": [(0, meta.to_wire())],
                "last_seq": mem.last_seq,
                "bvalue_next_file_id": db.bvalue.next_file_id,
            }
        )
        # this memtable's WAL — and, for a memtable rebuilt by recovery, the
        # replayed logs it carried — are now redundant: the data is durable
        # in the L0 table the manifest just committed. Delete them only now;
        # deleting earlier would widen the crash window. (With followers
        # attached, _release_wal retains segments a lagging replica still
        # needs for catch-up instead of unlinking.)
        logs = list(getattr(mem, "recovery_logs", None) or ())
        if getattr(mem, "wal_no", None) is not None:
            logs.append(db._wal_path(mem.wal_no))
        for log_path in logs:
            db._release_wal(log_path, mem.last_seq)

    # ------------------------------------------------------------------
    # compaction picking
    # ------------------------------------------------------------------
    def pick(self, locked=frozenset()):
        """Returns (level, [input files Ln], [input files Ln+1]) or None,
        never selecting a file whose compaction lock is held (``locked``).

        ``compaction_pick_policy="fullness"``: levels are tried in
        descending fullness order and the first pickable one wins (the
        legacy, write-amp-blind policy). ``"overlap"``: every
        over-trigger level nominates its cheapest job and the winner is
        the one clearing the most urgency per byte rewritten — fullness
        divided by the job's write amplification (1 + overlap/input)."""
        db = self.db
        cfg = db.cfg
        v = db.versions.current
        scored: list[tuple[float, int]] = []
        score0 = len(v.levels[0]) / cfg.l0_compaction_trigger
        if score0 >= 1.0:
            scored.append((score0, 0))
        for level in range(1, cfg.num_levels - 1):
            score = v.level_bytes(level) / cfg.level_max_bytes(level)
            if score > 1.0:
                scored.append((score, level))
        scored.sort(reverse=True)
        if cfg.compaction_pick_policy != "overlap":
            for _score, level in scored:
                picked = self._pick_level(v, level, locked)
                if picked is not None:
                    return picked
            return None
        best = None
        best_score = 0.0
        for fullness, level in scored:
            picked = self._pick_level(v, level, locked)
            if picked is None:
                continue
            _lvl, inputs, overlaps = picked
            in_bytes = max(1, sum(f.size for f in inputs))
            ov_bytes = sum(f.size for f in overlaps)
            score = fullness / (1.0 + ov_bytes / in_bytes)
            if best is None or score > best_score:
                best, best_score = picked, score
        if best is not None and best[0] >= 1:
            # advance the legacy rotation pointer for the WINNING level
            # only (evaluated-but-skipped candidates never ran), so
            # flipping back to "fullness" resumes from a sane position
            db.versions.compaction_ptr[best[0]] = best[1][0].smallest
        return best

    def _pick_level(self, v, level: int, locked):
        db = self.db
        cfg = db.cfg
        if level == 0:
            inputs = list(v.levels[0])
            if not inputs or any(f.file_no in locked for f in inputs):
                # L0 files overlap arbitrarily — at most one L0 job at a time
                return None
            smallest = min(f.smallest for f in inputs)
            largest = max(f.largest for f in inputs)
            overlaps = v.files_touching(1, smallest, largest)
            if any(f.file_no in locked for f in overlaps):
                return None
            return 0, inputs, overlaps
        files = v.levels[level]
        if not files:
            return None
        if cfg.compaction_pick_policy == "overlap":
            return self._pick_file_overlap(v, level, files, locked)
        # round-robin pointer within the level (LevelDB style), skipping
        # files locked by running jobs. The full Ln+1 overlap set always
        # rides along: truncating it (as the pre-scheduler code did) left
        # the merged output overlapping the dropped files, breaking the
        # sorted-level disjointness that point lookups binary-search on.
        # max_compaction_input_bytes instead steers the *choice*: prefer a
        # file whose job fits the cap, falling back to the smallest
        # oversized one so progress is still guaranteed.
        ptr = db.versions.compaction_ptr.get(level, b"")
        start = next((i for i, f in enumerate(files) if f.smallest > ptr), 0)
        fallback = None  # (total, pick_file, overlaps) of the smallest oversized job
        for off in range(len(files)):
            pick_file = files[(start + off) % len(files)]
            if pick_file.file_no in locked:
                continue
            overlaps = v.files_touching(level + 1, pick_file.smallest, pick_file.largest)
            if any(f.file_no in locked for f in overlaps):
                continue
            total = pick_file.size + sum(f.size for f in overlaps)
            if total > cfg.max_compaction_input_bytes:
                if fallback is None or total < fallback[0]:
                    fallback = (total, pick_file, overlaps)
                continue
            db.versions.compaction_ptr[level] = pick_file.smallest
            return level, [pick_file], overlaps
        if fallback is not None:
            _total, pick_file, overlaps = fallback
            db.versions.compaction_ptr[level] = pick_file.smallest
            return level, [pick_file], overlaps
        return None

    def _pick_file_overlap(self, v, level: int, files, locked):
        """Within-level choice under overlap scoring: the unlocked file
        whose job rewrites the fewest target-level bytes per input byte
        (tie-broken by smaller total job size). The full overlap set
        always rides along — ``max_compaction_input_bytes`` steers the
        choice among cap-fitting jobs; if none fits, the smallest
        oversized job runs so progress is still guaranteed."""
        db = self.db
        cfg = db.cfg
        best = None  # (ratio, total, pick_file, overlaps), job fits the cap
        fallback = None  # (total, pick_file, overlaps), smallest oversized
        for pick_file in files:
            if pick_file.file_no in locked:
                continue
            overlaps = v.files_touching(level + 1, pick_file.smallest, pick_file.largest)
            if any(f.file_no in locked for f in overlaps):
                continue
            ov_bytes = sum(f.size for f in overlaps)
            total = pick_file.size + ov_bytes
            if total > cfg.max_compaction_input_bytes:
                if fallback is None or total < fallback[0]:
                    fallback = (total, pick_file, overlaps)
                continue
            ratio = ov_bytes / max(1, pick_file.size)
            if best is None or (ratio, total) < (best[0], best[1]):
                best = (ratio, total, pick_file, overlaps)
                if ov_bytes == 0:
                    break  # zero overlap is the minimum — a trivial-move
                    # candidate; no later file can score better on ratio
        if best is not None:
            _ratio, _total, pick_file, overlaps = best
        elif fallback is not None:
            _total, pick_file, overlaps = fallback
        else:
            return None
        return level, [pick_file], overlaps

    # ------------------------------------------------------------------
    # compaction run
    # ------------------------------------------------------------------
    def run(self, level: int, inputs, overlaps, subtasks=None) -> None:
        """Merge ``inputs`` (Ln) + ``overlaps`` (Ln+1) into new Ln+1 tables
        and commit the swap as one atomic manifest edit — unless the job
        qualifies as a **trivial move** (single input, zero target-level
        overlap), which promotes the file by manifest edit alone.

        ``subtasks`` (callable: list of thunks → list of results) fans the
        key-range shards out across the scheduler's subcompaction pool;
        None runs them sequentially (same result, one thread)."""
        db = self.db
        cfg = db.cfg
        if self._maybe_trivial_move(level, inputs, overlaps):
            return
        out_level = level + 1
        v = db.versions.current
        bottom = all(not v.levels[lvl] for lvl in range(out_level + 1, cfg.num_levels))
        fill = not cfg.block_cache_compaction_bypass
        read_bytes = sum(f.size for f in inputs + overlaps)
        # snapshot-aware dedup: sample the live snapshot seqs ONCE per job.
        # Any snapshot taken after this point holds a seq >= every sequence
        # in these (already flushed) inputs, so it reads each key's newest
        # input version — which the stripe dedup below always keeps.
        snaps = sorted(db.snapshot_seqs())

        bounds = self._subcompaction_bounds(
            inputs, overlaps, self._choose_shards(read_bytes)
        )
        ranges = list(zip([None] + bounds, bounds + [None]))

        def shard_thunk(lo, hi):
            def go():
                t0 = time.monotonic()
                try:
                    metas = self._run_range(
                        level, inputs, overlaps, lo, hi, bottom, fill, snaps
                    )
                    return metas, None, time.monotonic() - t0
                except BaseException as e:
                    return [], e, time.monotonic() - t0

            return go

        thunks = [shard_thunk(lo, hi) for lo, hi in ranges]
        if len(thunks) == 1 or subtasks is None:
            results = [t() for t in thunks]
        else:
            results = subtasks(thunks)
            db.stats.add("subcompactions", len(thunks))
        metas = []
        err: BaseException | None = None
        shard_seconds = 0.0
        for shard_metas, shard_err, shard_s in results:
            metas.extend(shard_metas)
            shard_seconds += shard_s
            if shard_err is not None and err is None:
                err = shard_err
        if err is None:
            self._note_shard_rate(read_bytes, shard_seconds)
        if err is not None:
            # no manifest edit happened: drop every shard's output so the
            # live process never leaks tables (reopen would sweep them too)
            for m in metas:
                try:
                    db.env.unlink(table_path(db.path, m.file_no))
                except OSError:
                    pass
            raise err
        metas.sort(key=lambda m: m.smallest)

        written = sum(m.size for m in metas)
        db.stats.add("compaction_bytes", written)
        db.stats.add("compaction_read_bytes", read_bytes)
        db.stats.add("compaction_count")
        edit = {
            "add": [(out_level, m.to_wire()) for m in metas],
            "delete": [(level, f.file_no) for f in inputs]
            + [(out_level, f.file_no) for f in overlaps],
        }
        db.versions.log_and_apply(edit)
        for f in inputs + overlaps:
            db.versions.drop_reader(f.file_no)
            try:
                # an open cursor pins the pre-edit version: its input files
                # stay on disk (and their readers parked) until it unpins
                db.versions.defer_or_unlink(table_path(db.path, f.file_no))
            except OSError:
                pass

    def _maybe_trivial_move(self, level: int, inputs, overlaps) -> bool:
        """Promote a no-overlap single file to the next level by manifest
        edit alone — zero bytes read, zero bytes written, no new tables.

        Eligibility: exactly one input, an empty target-level overlap set,
        and (when ``trivial_move_max_gp_bytes`` > 0) bounded grandparent
        overlap — parking a file on top of a wide grandparent range only
        converts this job's savings into a more expensive future job one
        level down. Safe under concurrency: the input is compaction-locked
        and every running job's output span is interval-closed over files
        that were live (and not overlapping this range) at its own pick
        time, so no concurrent commit can slide a target-level file under
        the move (see the module docstring)."""
        db = self.db
        cfg = db.cfg
        out_level = level + 1
        if (
            not cfg.trivial_move
            or overlaps
            or len(inputs) != 1
            or out_level >= cfg.num_levels
        ):
            return False
        f = inputs[0]
        if cfg.trivial_move_max_gp_bytes > 0 and out_level + 1 < cfg.num_levels:
            v = db.versions.current
            gp = v.overlap_bytes(out_level + 1, f.smallest, f.largest)
            if gp > cfg.trivial_move_max_gp_bytes:
                return False
        db.versions.log_and_apply(
            {
                "add": [(out_level, f.to_wire())],
                "delete": [(level, f.file_no)],
            }
        )
        db.stats.add("trivial_moves")
        db.stats.add("trivial_move_bytes", f.size)
        return True

    def _choose_shards(self, input_bytes: int) -> int:
        """Adaptive subcompaction fan-out: shard count follows the live
        input size over a per-shard byte target — the historical per-shard
        merge throughput (EWMA) times ``subcompaction_target_seconds``,
        floored at ``subcompaction_min_bytes`` (also the cold-start
        target). Tiny inputs degrade to 1 (no fan-out overhead); the
        result never exceeds ``max_subcompactions``."""
        cfg = self.db.cfg
        if cfg.max_subcompactions <= 1:
            return 1
        if not cfg.subcompaction_adaptive:
            return cfg.max_subcompactions
        target = max(1, cfg.subcompaction_min_bytes)
        if self._shard_bytes_per_s > 0.0:
            target = max(
                target, int(self._shard_bytes_per_s * cfg.subcompaction_target_seconds)
            )
        self.db.stats.set_gauge("subcompaction_target_bytes", target)
        return int(min(cfg.max_subcompactions, max(1, input_bytes // target)))

    def _note_shard_rate(self, input_bytes: int, shard_seconds: float) -> None:
        """Fold one completed compaction into the per-shard throughput
        EWMA (input bytes per cumulative shard-second)."""
        if shard_seconds <= 1e-6 or input_bytes <= 0:
            return
        rate = input_bytes / shard_seconds
        self._shard_bytes_per_s = (
            rate
            if self._shard_bytes_per_s == 0.0
            else 0.7 * self._shard_bytes_per_s + 0.3 * rate
        )
        self.db.stats.set_gauge("subcompaction_bytes_per_s", self._shard_bytes_per_s)

    def _subcompaction_bounds(self, inputs, overlaps, max_shards: int) -> list[bytes]:
        """Choose up to ``max_shards - 1`` split keys from the input files'
        natural boundaries, weighted by file size so shards carry roughly
        equal bytes. When file boundaries alone can't split the range —
        the common L0→L1 case where every L0 file spans the whole key
        window — fall back to sampling block boundaries from the largest
        input's index. Returns an ascending list of keys; shard i covers
        ``[bounds[i-1], bounds[i])`` (half-open, first/last unbounded)."""
        if max_shards <= 1:
            return []
        points = sorted((f.smallest, f.size) for f in inputs + overlaps)
        total = sum(sz for _, sz in points)
        if len(points) < 2 or total <= 0:
            return []
        bounds: list[bytes] = []
        acc = 0
        target = total / min(max_shards, len(points))
        for key, sz in points:
            if acc >= target * (len(bounds) + 1) and (not bounds or key > bounds[-1]):
                bounds.append(key)
                if len(bounds) >= max_shards - 1:
                    break
            acc += sz
        if len(bounds) < max_shards - 1:
            bounds = self._augment_bounds_from_index(
                inputs + overlaps, bounds, max_shards
            )
        return bounds

    def _augment_bounds_from_index(self, files, bounds: list[bytes], max_shards: int):
        """Merge index-block boundary keys of the largest input into the
        split set and re-pick evenly — overlapping inputs then still shard
        into balanced ranges. Best-effort: any failure (reader gone, empty
        index) keeps the file-boundary bounds."""
        try:
            big = max(files, key=lambda f: f.size)
            index = self.db.versions.reader(big.file_no).index
            if len(index) < 2:
                return bounds
            lo, hi = min(f.smallest for f in files), max(f.largest for f in files)
            cand = sorted(
                {k for k, _off, _len in index[:-1] if lo < k <= hi} | set(bounds)
            )
            if not cand:
                return bounds
            n = min(max_shards - 1, len(cand))
            step = len(cand) / (n + 1)
            picked = sorted({cand[min(len(cand) - 1, int(step * (i + 1)))] for i in range(n)})
            return picked
        except Exception:
            return bounds

    def _run_range(self, level, inputs, overlaps, lo, hi, bottom, fill, snaps=()):
        """One subcompaction shard: merge keys in ``[lo, hi)`` (None =
        unbounded) into fresh Ln+1 tables; returns their FileMetadata.
        Shards touch disjoint key ranges, so per-shard version dedup and
        dead-pointer tracking are exactly as correct as the serial merge.

        ``snaps`` is the sorted live snapshot seq list sampled at job start.
        It partitions sequence space into *stripes* (RocksDB-style): a
        version is droppable only against a newer version/tombstone in the
        SAME stripe — no snapshot can observe the difference. With no
        snapshots everything is one stripe and the dedup degenerates to the
        classic newest-version-wins.

        Range tombstones from the input files are clipped to the shard,
        drop covered same-stripe entries, and are redistributed to the
        output tables clipped at each table's first key — so a sorted
        level's (tombstone-extended) file ranges stay disjoint-or-touching
        and a point lookup finds any covering tombstone in the same
        candidate file(s) it already reads."""
        db = self.db
        cfg = db.cfg
        limiter = db.rate_limiter
        # meter the merge's block READS against the unified budget at LOW
        # priority, charged at pread time (cache hits never pay). Batched
        # into IO_CHUNK lumps like the write side so the token bucket's
        # lock isn't taken once per 4 KiB block.
        meter = None
        pending_read = 0
        if cfg.compaction_read_metering and limiter.enabled:

            def meter(nbytes: int) -> None:
                nonlocal pending_read
                pending_read += nbytes
                if pending_read >= IO_CHUNK:
                    limiter.request(pending_read, PRI_LOW)
                    db.stats.add("compaction_read_metered_bytes", pending_read)
                    pending_read = 0

        iters = []
        shard_tombs: list[tuple[int, bytes, bytes]] = []
        for f in inputs + overlaps:
            if lo is not None and f.largest < lo:
                continue
            if hi is not None and f.smallest >= hi:
                continue
            r = db.versions.reader(f.file_no)
            for ts, a, b in r.range_tombstones:
                a2 = a if lo is None else max(a, lo)
                b2 = b if hi is None else min(b, hi)
                if a2 < b2:
                    shard_tombs.append((ts, a2, b2))
            iters.append(
                r.iter_from(lo, fill_cache=fill, meter=meter)
                if lo is not None
                else r.iter_all(fill_cache=fill, meter=meter)
            )

        def bucket(seq):
            return bisect_left(snaps, seq)  # snapshots strictly below seq

        def covering(key, seq):
            """OLDEST collected tombstone newer than ``seq`` covering ``key``
            (0 if none). The minimal such ts is the one to test for
            droppability: ``bucket`` is monotone in ts, so the entry shares a
            stripe with SOME covering tombstone iff it shares one with the
            oldest — using the max instead would let a newer cross-stripe
            tombstone mask an in-stripe one, keeping the entry while the
            in-stripe tombstone gets dropped at the bottom (resurrection).
            Tombstone lists are small; linear is fine."""
            best = 0
            for ts, a, b in shard_tombs:
                if ts > seq and a <= key < b and (best == 0 or ts < best):
                    best = ts
            return best

        # a bottom-level tombstone with no snapshot below it has done its
        # work (every covered entry is droppable, below) — drop it from the
        # output; it still participates in `covering` either way
        out_tombs = [
            t for t in shard_tombs if not (bottom and bucket(t[0]) == 0)
        ]
        if out_tombs and cfg.range_tombstone_coalesce:
            out_tombs = _coalesce_tombstones(out_tombs)
        pending = sorted(out_tombs, key=lambda t: (t[1], t[2]))

        target = max(cfg.memtable_size, 4 << 20)
        writer = None
        file_no = None
        metas = []

        def roll(boundary):
            """Finish the current table. ``boundary`` (the next table's
            first key, or None at shard end) splits the surviving range
            tombstones: fragments below it land in this table, the rest
            carry over — every table's range block stays inside its own
            key span."""
            nonlocal writer, file_no, pending
            if boundary is None:
                mine, pending = pending, []
            else:
                mine, rest = [], []
                for ts, a, b in pending:
                    if a < boundary:
                        mine.append((ts, a, min(b, boundary)))
                        if b > boundary:
                            rest.append((ts, boundary, b))
                    else:
                        rest.append((ts, a, b))
                pending = rest
            if writer is None and mine:
                # tombstone-only table: a shard can drop every point entry
                # yet still owe its tombstones to deeper levels
                file_no = db.versions.new_file_no()
                writer = SSTableWriter(
                    table_path(db.path, file_no), cfg.block_size, cfg.compression,
                    cfg.sstable_format_version, cfg.block_restart_interval,
                    env=db.env,
                )
            if writer is not None and (writer._count > 0 or mine):
                metas.append(writer.finish(file_no, mine))
                writer = None
            elif writer is not None:
                writer.abandon()
                writer = None

        last_key = None
        last_bucket = None  # stripe of the last kept/suppressing version
        pending_io = 0
        try:
            for key, seq, type_, value in _merge_iters(iters):
                if hi is not None and key >= hi:
                    break  # the next shard owns [hi, ...)
                new_key = key != last_key
                if new_key:
                    last_key = key
                    last_bucket = None
                elif last_bucket is not None and bucket(seq) == last_bucket:
                    if type_ == kTypeValuePtr:  # shadowed big value → dead
                        db.dead_tracker.on_dead(ValueOffset.decode(value))
                    continue  # older version in an already-served stripe
                b = bucket(seq)
                ts = covering(key, seq)
                if ts and bucket(ts) == b:
                    # range-tombstone covered with no snapshot in between;
                    # safe at ANY level — the tombstone itself survives in
                    # the output until it reaches the bottom
                    if type_ == kTypeValuePtr:
                        db.dead_tracker.on_dead(ValueOffset.decode(value))
                    last_bucket = b  # same-stripe older versions drop too
                    continue
                if type_ == kTypeDeletion and bottom and b == 0:
                    last_bucket = b
                    continue  # tombstone reached the bottom, no snapshot below
                if new_key and writer is not None and writer._offset >= target:
                    # roll only between user keys: a key's version run never
                    # splits across tables, and the incoming key becomes the
                    # next table's first key = this table's tombstone clip
                    roll(key)
                if writer is None:
                    file_no = db.versions.new_file_no()
                    writer = SSTableWriter(
                        table_path(db.path, file_no), cfg.block_size, cfg.compression,
                        cfg.sstable_format_version, cfg.block_restart_interval,
                        env=db.env,
                    )
                writer.add(key, seq, type_, value)
                last_bucket = b
                pending_io += len(key) + len(value)
                if pending_io >= IO_CHUNK:
                    limiter.request(pending_io, PRI_LOW)
                    pending_io = 0
            roll(None)
        except BaseException:
            # a failed shard must not leak its outputs: abandon the
            # in-progress writer (closes + unlinks) and drop the tables it
            # already rolled — run() only cleans up *returned* metas
            if writer is not None:
                try:
                    writer.abandon()
                except OSError:
                    pass
            for m in metas:
                try:
                    db.env.unlink(table_path(db.path, m.file_no))
                except OSError:
                    pass
            raise
        limiter.request(pending_io, PRI_LOW)
        if pending_read:
            limiter.request(pending_read, PRI_LOW)
            db.stats.add("compaction_read_metered_bytes", pending_read)
        return metas
