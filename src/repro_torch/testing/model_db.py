"""Model-based differential testing for the MVCC surface.

:class:`ModelDB` is the executable specification: a dict of per-key version
lists plus a range-tombstone list, ~80 lines with no trees, files, or
threads — obviously correct by inspection. The engine under test must agree
with it at EVERY read point: latest reads, pinned snapshots, forward
cursors, reverse cursors, and checkpoint copies.

:func:`run_differential` drives both through the same randomized op stream
(puts straddling the separation threshold, deletes, range deletes, atomic
batches, snapshots taken/released, flushes, compactions, GC passes, crash
reopens, checkpoints) and cross-checks after every op — so a divergence
pinpoints the op sequence that caused it, not just "some state was wrong
at the end". Plain ``random`` only: the harness runs in CI and where
``hypothesis`` is not installed alike (the reference's
``tests/test_mvcc.py`` layers hypothesis's stateful shrinking on top where
the dependency exists).

Run standalone::

    PYTHONPATH=src python -m repro_torch.testing.model_db --examples 500
"""
from __future__ import annotations

import argparse
import bisect
import os
import random
import shutil
import tempfile
import time

from repro_torch.core import DB, DBConfig, ShardedDB, WriteBatch

LATEST = (1 << 56) - 1  # MAX_SEQ: the "no snapshot" read point


class ModelDB:
    """Dict-of-versions reference model.

    Sequence numbers are the model's own op counter — they need not equal
    the engine's internal sequences (GC rewrites consume engine seqs the
    model never sees); a comparison only ever pairs an engine read point
    (``None`` or a ``Snapshot``) with the model read point captured at the
    same instant, and visible state is what must match."""

    def __init__(self) -> None:
        self.seq = 0
        # key -> [(seq, value-or-None)] appended in seq order (None = delete)
        self.versions: dict[bytes, list[tuple[int, bytes | None]]] = {}
        self.range_tombs: list[tuple[int, bytes, bytes]] = []

    # -- writes (each returns the op's model seq) ------------------------
    def put(self, key: bytes, value: bytes) -> int:
        self.seq += 1
        self.versions.setdefault(key, []).append((self.seq, value))
        return self.seq

    def delete(self, key: bytes) -> int:
        self.seq += 1
        self.versions.setdefault(key, []).append((self.seq, None))
        return self.seq

    def delete_range(self, start: bytes, end: bytes) -> int:
        self.seq += 1
        self.range_tombs.append((self.seq, start, end))
        return self.seq

    def write_batch(self, ops: list[tuple[str, bytes, bytes]]) -> int:
        """Atomic batch: every op shares ONE seq; within the batch, later
        ops win for point writes, and a range delete does not cover puts
        of the same batch (tombstones cover strictly-older seqs)."""
        self.seq += 1
        for kind, a, b in ops:
            if kind == "put":
                self.versions.setdefault(a, []).append((self.seq, b))
            elif kind == "del":
                self.versions.setdefault(a, []).append((self.seq, None))
            else:  # "delrange"
                self.range_tombs.append((self.seq, a, b))
        # collapse same-seq duplicates per key: later op in the batch wins
        for kind, a, _b in ops:
            if kind in ("put", "del"):
                vs = self.versions[a]
                dups = [i for i, (s, _) in enumerate(vs) if s == self.seq]
                for i in reversed(dups[:-1]):
                    vs.pop(i)
        return self.seq

    def snapshot(self) -> int:
        return self.seq

    # -- reads -----------------------------------------------------------
    def _tomb_seq(self, key: bytes, read_seq: int) -> int:
        best = 0
        for seq, start, end in self.range_tombs:
            if seq <= read_seq and start <= key < end and seq > best:
                best = seq
        return best

    def get(self, key: bytes, read_seq: int = LATEST) -> bytes | None:
        hit = None
        for seq, value in reversed(self.versions.get(key, ())):
            if seq <= read_seq:
                hit = (seq, value)
                break
        if hit is None or hit[1] is None or hit[0] < self._tomb_seq(key, read_seq):
            return None
        return hit[1]

    def items_at(self, read_seq: int = LATEST) -> list[tuple[bytes, bytes]]:
        out = []
        for key in sorted(self.versions):
            v = self.get(key, read_seq)
            if v is not None:
                out.append((key, v))
        return out

    def scan(
        self, start: bytes, count: int, read_seq: int = LATEST
    ) -> list[tuple[bytes, bytes]]:
        items = [kv for kv in self.items_at(read_seq) if kv[0] >= start]
        return items[:count]

    def prev_key(self, bound: bytes | None, read_seq: int = LATEST):
        """Largest visible key strictly below ``bound`` (None = unbounded),
        with its value — the reverse-cursor step."""
        keys = [k for k, _ in self.items_at(read_seq)]
        i = len(keys) if bound is None else bisect.bisect_left(keys, bound)
        if i == 0:
            return None
        k = keys[i - 1]
        return k, self.get(k, read_seq)


# ---------------------------------------------------------------------------
# differential runner
# ---------------------------------------------------------------------------

def _mkcfg(rng: random.Random) -> DBConfig:
    cfg = DBConfig.bvlsm(
        value_threshold=64,
        memtable_size=rng.choice((1024, 4096)),  # tiny: constant flux
        num_bvalue_queues=2,
    )
    cfg.l0_compaction_trigger = 2
    cfg.gc_dead_ratio_trigger = 0.4
    return cfg


def _check_point_reads(db, model, read_pairs, keys, rng, diverge):
    """Compare a sample of gets at every live read point — via single
    ``get`` and via ``multi_get`` (which a ShardedDB fans out per shard),
    so the batched path is differentially checked too."""
    for snap, mseq in read_pairs:
        sample = rng.sample(keys, min(6, len(keys)))
        want = [model.get(k, LATEST if mseq is None else mseq) for k in sample]
        for k, w in zip(sample, want):
            got = db.get(k, snapshot=snap)
            if got != w:
                diverge.append(
                    f"get({k!r}) @ {'latest' if mseq is None else mseq}: "
                    f"model {w!r} != db {got!r}"
                )
        got_many = db.multi_get(sample, snapshot=snap)
        if got_many != want:
            diverge.append(
                f"multi_get({sample!r}) @ {'latest' if mseq is None else mseq}: "
                f"model {want!r} != db {got_many!r}"
            )


def _check_scan(db, model, snap, mseq, start, count, diverge):
    want = model.scan(start, count, LATEST if mseq is None else mseq)
    if snap is None:
        got = list(db.range(start, limit=count))
    else:
        got = []
        with db.iterator(snap) as cur:
            ok = cur.seek(start)
            while ok and len(got) < count:
                got.append((cur.key, cur.value))
                ok = cur.next()
    if got != want:
        diverge.append(
            f"scan({start!r}, {count}) @ {'latest' if mseq is None else mseq}: "
            f"model {[k for k, _ in want]!r} != db {[k for k, _ in got]!r}"
        )


def _check_reverse(db, model, snap, mseq, bound, steps, diverge):
    """Walk ``steps`` reverse-cursor hops from ``bound`` on both sides."""
    rseq = LATEST if mseq is None else mseq
    with db.iterator(snap) as cur:
        if bound is not None:
            # position the cursor: seek lands on first key >= bound
            cur.seek(bound)
        want_bound = cur.key if cur.valid else None
        mb = want_bound
        for _ in range(steps):
            ok = cur.prev()
            want = model.prev_key(mb, rseq)
            if not ok:
                if want is not None:
                    diverge.append(
                        f"prev from {mb!r} @ {rseq}: model {want[0]!r}, db exhausted"
                    )
                return
            if want is None:
                diverge.append(f"prev from {mb!r} @ {rseq}: db {cur.key!r}, model exhausted")
                return
            if (cur.key, cur.value) != want:
                diverge.append(
                    f"prev from {mb!r} @ {rseq}: model {want[0]!r} != db {cur.key!r}"
                )
                return
            mb = cur.key


def run_example(
    seed: int, base_dir: str, n_ops: int = 60, trace=None, shards: int = 0
) -> list[str]:
    """One differential example: fresh DB + model, ``n_ops`` random ops
    with cross-checks after each. Returns divergence strings (empty = ok).
    ``trace`` (a callable taking one string) logs each op as it executes —
    replay a diverging seed with ``trace=print`` to see the exact op
    sequence; it consumes no randomness, so the stream is unchanged.

    ``shards > 0`` runs the same spec against a ``ShardedDB`` of that
    many engines (hash partitioning): every batch then exercises the
    cross-shard commit protocol, every range delete spans shard
    boundaries, and every scan/reverse walk goes through the merged
    cursor — the model doesn't change at all, which is the point."""
    t = trace if trace is not None else (lambda s: None)
    rng = random.Random(seed)
    path = os.path.join(base_dir, f"ex{seed}")

    def _open(p: str):
        if shards > 0:
            return ShardedDB.open(p, shards=shards, config=_mkcfg(rng))
        return DB.open(p, _mkcfg(rng))

    db = _open(path)
    model = ModelDB()
    keys = [f"k{i:03d}".encode() for i in range(rng.randrange(12, 40))]
    # live read points: [(db Snapshot | None, model seq | None)]; the
    # (None, None) pair is the always-present latest read point
    snaps: list[tuple[object, int]] = []
    diverge: list[str] = []

    def val() -> bytes:
        size = rng.choice((8, 8, 24, 80, 300))
        return (f"v{rng.randrange(1 << 28)}_".encode() * 40)[:size]

    try:
        for _op in range(n_ops):
            r = rng.random()
            if r < 0.40:
                k = rng.choice(keys)
                v = val()
                t(f"put {k} {len(v)}B")
                db.put(k, v)
                model.put(k, v)
            elif r < 0.50:
                k = rng.choice(keys)
                t(f"del {k}")
                db.delete(k)
                model.delete(k)
            elif r < 0.60:
                a, b = sorted(rng.sample(keys, 2))
                b = b + b"\x00" if rng.random() < 0.5 else b
                t(f"delrange {a}..{b}")
                db.delete_range(a, b)
                model.delete_range(a, b)
            elif r < 0.68:
                ops = []
                wb = WriteBatch()
                for _ in range(rng.randrange(1, 6)):
                    rr = rng.random()
                    if rr < 0.6:
                        k, v = rng.choice(keys), val()
                        wb.put(k, v)
                        ops.append(("put", k, v))
                    elif rr < 0.8:
                        k = rng.choice(keys)
                        wb.delete(k)
                        ops.append(("del", k, b""))
                    else:
                        a, b = sorted(rng.sample(keys, 2))
                        b = b + b"\x00"
                        wb.delete_range(a, b)
                        ops.append(("delrange", a, b))
                t(f"batch {[(o[0], o[1]) for o in ops]}")
                db.write(wb)
                model.write_batch(ops)
            elif r < 0.74:
                if len(snaps) < 4:
                    snaps.append((db.snapshot(), model.snapshot()))
                    dseq = getattr(snaps[-1][0], "seq", None)
                    if dseq is None:  # ShardedSnapshot: one seq per shard
                        dseq = snaps[-1][0].seqs
                    t(f"snapshot db={dseq} model={snaps[-1][1]}")
                elif snaps:
                    s, _ = snaps.pop(rng.randrange(len(snaps)))
                    s.release()
                    t("release")
            elif r < 0.82:
                t("flush")
                db.flush()
            elif r < 0.86:
                t("compact")
                db.compact_all()
            elif r < 0.90:
                t("gc")
                db.gc_collect(threshold=0.3)
            elif r < 0.96:
                # crash-free reopen: snapshots/cursors do not survive it
                for s, _ in snaps:
                    s.release()
                snaps.clear()
                t("reopen")
                db.flush()
                db.close()
                db = _open(path)
            else:
                t("checkpoint")
                ck = os.path.join(base_dir, f"ck{seed}_{_op}")
                db.checkpoint(ck)
                cdb = _open(ck)
                try:
                    got = list(cdb.range())
                    want = model.items_at(LATEST)
                    if got != want:
                        diverge.append(
                            f"checkpoint scan: model {[k for k, _ in want]!r}"
                            f" != ckpt {[k for k, _ in got]!r}"
                        )
                finally:
                    cdb.close()
                    shutil.rmtree(ck, ignore_errors=True)

            read_pairs = [(None, None)] + snaps
            _check_point_reads(db, model, read_pairs, keys, rng, diverge)
            if rng.random() < 0.35:
                snap, mseq = read_pairs[rng.randrange(len(read_pairs))]
                _check_scan(db, model, snap, mseq, rng.choice(keys), 8, diverge)
            if rng.random() < 0.15:
                snap, mseq = read_pairs[rng.randrange(len(read_pairs))]
                _check_reverse(
                    db, model, snap, mseq, rng.choice(keys), 4, diverge
                )
            if diverge:
                diverge.insert(0, f"seed={seed} op={_op}")
                return diverge
        # final full-state comparison at every live read point
        for snap, mseq in [(None, None)] + snaps:
            _check_scan(db, model, snap, mseq, b"", 1 << 20, diverge)
        if diverge:
            diverge.insert(0, f"seed={seed} op=final")
    finally:
        for s, _ in snaps:
            s.release()
        db.close()
        shutil.rmtree(path, ignore_errors=True)
    return diverge


def run_differential(
    examples: int = 500,
    seed: int = 0,
    n_ops: int = 60,
    verbose: bool = False,
    shards: int = 0,
) -> dict:
    base = tempfile.mkdtemp(prefix="mvccdiff_")
    failures: list[list[str]] = []
    t0 = time.monotonic()
    try:
        for i in range(examples):
            d = run_example(seed * 1_000_003 + i, base, n_ops, shards=shards)
            if d:
                failures.append(d)
            if verbose and ((i + 1) % 50 == 0 or d):
                print(f"[{i + 1}/{examples}] divergences={len(failures)}", flush=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return {
        "examples": examples,
        "shards": shards,
        "failures": failures,
        "seconds": round(time.monotonic() - t0, 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--examples", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ops", type=int, default=60)
    ap.add_argument(
        "--shards", type=int, default=0,
        help="run the spec against a ShardedDB of N engines (0 = plain DB)",
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    rep = run_differential(
        args.examples, args.seed, args.ops, args.verbose, shards=args.shards
    )
    print(
        f"{rep['examples']} examples (shards={rep['shards']}), "
        f"{len(rep['failures'])} diverging, {rep['seconds']}s"
    )
    for f in rep["failures"]:
        for line in f:
            print(f"  {line}")
    return 1 if rep["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
