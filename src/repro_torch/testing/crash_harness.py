"""Randomized crash-loop durability harness.

Each iteration builds a small DB on a :class:`FaultInjectionEnv`, runs a
randomized workload (puts / overwrites / deletes / range deletes, values
straddling the separation threshold, occasional flush / GC / checkpoint
kicks so every pipeline stage is live), and arms a **crash point**: after N
env operations — N random, the op set and path filter random too, so the
kill lands on WAL appends, WAL fsyncs, SSTable writes, manifest appends,
BValue pwrites, renames, unlinks and checkpoint hard-links alike — every
further mutating filesystem op raises ``SimulatedCrashError``. The iteration then simulates the machine dying:
``drop_unsynced()`` rewinds every file to its last-fsynced prefix (undoing
overwrites of previously-synced bytes, RocksDB FaultInjectionTestFS style),
and the DB is reopened on the survivor state.

Checked invariants, every iteration:

* **reopen succeeds** — recovery must handle any torn state the crash left;
* **no lost acked writes** (sync WAL): every ``put``/``delete`` that
  returned before the crash reads back exactly its last acked value;
* **no resurrected stale values** (async WAL): a recovered value must be
  *some* prefix state of that key's history — never a value that was
  superseded before an acked later write, and never garbage;
* **the reopened DB is writable** and a full scan completes;
* **acked checkpoints commit atomically**: every ``checkpoint(dir)`` call
  that returned keeps its MANIFEST (the rename is the commit marker), and
  any checkpoint dir holding a MANIFEST — acked or not — opens as a valid
  DB whose full scan completes; a crash between the hard-links and the
  rename leaves a manifest-less dir that is simply not a DB.

Run standalone::

    PYTHONPATH=src python -m repro_torch.testing.crash_harness --iters 200

or from tests via :func:`run_crash_loop`.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import random
import shutil
import sys
import tempfile
import time

from repro_torch.core import DB, DBConfig, FaultInjectionEnv

#: crash-point op filters the fuzzer draws from — each (ops, path_substr)
#: pair aims the kill at one pipeline edge
CRASH_TARGETS = [
    (("write", "sync", "rename", "unlink", "truncate"), None),  # anywhere
    (("write",), "wal_"),        # WAL append
    (("sync",), "wal_"),         # WAL group fsync
    (("write",), ".sst"),        # flush / compaction output
    (("sync",), ".sst"),         # table durability barrier
    (("write",), "MANIFEST"),    # version edit append
    (("sync",), "MANIFEST"),     # manifest commit fsync
    (("write",), "bvalue"),      # value-log pwrite
    (("sync",), "bvalue"),       # value-log fsync
    (("unlink",), None),         # log/file deletion edges
    (("rename",), None),         # atomic-replace edges
    (("link",), None),           # checkpoint hard-link fan-out
    (("rename",), "MANIFEST"),   # checkpoint commit: MANIFEST.tmp → MANIFEST
    (("write", "sync"), "_ck"),  # anything inside a checkpoint target dir
]


def _mkcfg(wal_mode: str, env: FaultInjectionEnv) -> DBConfig:
    cfg = DBConfig.bvlsm(
        wal_mode=wal_mode,
        value_threshold=64,
        memtable_size=4096,  # tiny: every iteration exercises rotation+flush
        num_bvalue_queues=2,
    )
    cfg.env = env
    cfg.bg_error_backoff_ms = 1.0  # crashing jobs shouldn't sleep long
    cfg.gc_dead_ratio_trigger = 0.3
    return cfg


def run_iteration(seed: int, wal_mode: str, base_dir: str) -> dict:
    """One crash/recover/check cycle. Returns a result dict with
    ``violations`` (list of strings, empty = pass)."""
    rng = random.Random(seed)
    path = os.path.join(base_dir, f"it{seed}")
    env = FaultInjectionEnv(seed=seed)
    db = DB(path, _mkcfg(wal_mode, env))

    keys = [f"key{i:03d}".encode() for i in range(rng.randrange(8, 48))]
    # acked[k]: last value whose put/delete RETURNED before the crash
    # history[k]: every state k ever held (for the async-WAL prefix check)
    acked: dict[bytes, bytes | None] = {}
    history: dict[bytes, set] = {k: {None} for k in keys}
    # checkpoint dirs whose checkpoint() call RETURNED before the crash —
    # each must reopen as a valid read-only DB after the crash
    acked_ckpts: list[str] = []
    attempted_ckpts: list[str] = []

    ops, substr = CRASH_TARGETS[rng.randrange(len(CRASH_TARGETS))]
    env.set_crash_after(rng.randrange(5, 400), ops=ops, path_substr=substr)

    crashed = False
    n_ops = rng.randrange(50, 500)
    for _i in range(n_ops):
        k = keys[rng.randrange(len(keys))]
        try:
            r = rng.random()
            if r < 0.08:
                db.delete(k)
                acked[k] = None
                history[k].add(None)
            elif r < 0.12:
                a, b = sorted(rng.sample(keys, 2))
                b = b + b"\x00" if rng.random() < 0.5 else b
                db.delete_range(a, b)
                for kk in keys:
                    if a <= kk < b:
                        acked[kk] = None
                        history[kk].add(None)
            elif r < 0.16:
                db.flush()
                continue
            elif r < 0.17:
                db.gc_collect(threshold=0.2)
                continue
            elif r < 0.19:
                ck = os.path.join(base_dir, f"it{seed}_ck{_i}")
                attempted_ckpts.append(ck)
                db.checkpoint(ck)
                acked_ckpts.append(ck)
                continue
            else:
                # mix of inline and separated (>= threshold) values
                size = rng.choice((8, 8, 40, 200, 700))
                v = (f"s{seed}v{rng.randrange(1 << 30)}_".encode() * 8)[:size]
                db.put(k, v)
                acked[k] = v
                history[k].add(v)
        except Exception:
            crashed = True
            break
    # the machine dies here (whether or not the armed point fired): no
    # orderly shutdown, unsynced state is gone
    try:
        db.close(crash=True)
    except Exception:
        pass
    env.drop_unsynced()
    env.disarm_crash()
    env.clear_faults()
    env.reset_tracking()

    violations: list[str] = []
    db2 = None
    try:
        db2 = DB(path, _mkcfg(wal_mode, env))
    except Exception as e:
        violations.append(f"reopen failed: {type(e).__name__}: {e}")
    if db2 is not None:
        for k, want in acked.items():
            try:
                got = db2.get(k)
            except Exception as e:
                violations.append(f"get({k!r}) failed: {type(e).__name__}: {e}")
                continue
            if wal_mode == "sync":
                if got != want:
                    violations.append(
                        f"lost acked write {k!r}: want {want!r} got {got!r}"
                    )
            else:
                # async WAL: acked ≠ durable; any prefix state is legal,
                # anything NOT in the history is corruption/resurrection
                if got not in history[k]:
                    violations.append(
                        f"non-prefix value for {k!r}: got {got!r}"
                    )
        try:
            list(db2.range())
            db2.put(b"post-crash-probe", b"ok")
            if db2.get(b"post-crash-probe") != b"ok":
                violations.append("post-recovery write not readable")
            db2.close()
        except Exception as e:
            violations.append(f"post-recovery use failed: {type(e).__name__}: {e}")
    # every checkpoint whose call RETURNED must open as a valid DB: the
    # MANIFEST rename is the commit marker, and everything it references
    # was hard-linked from fsynced files before the rename
    for ck in attempted_ckpts:
        committed = os.path.exists(os.path.join(ck, "MANIFEST"))
        if ck in acked_ckpts and not committed:
            violations.append(f"acked checkpoint lost its MANIFEST: {ck}")
        if committed:
            try:
                cdb = DB(ck, _mkcfg(wal_mode, env))
                list(cdb.range())
                cdb.close()
            except Exception as e:
                violations.append(
                    f"checkpoint {os.path.basename(ck)} does not open clean: "
                    f"{type(e).__name__}: {e}"
                )
        shutil.rmtree(ck, ignore_errors=True)
    shutil.rmtree(path, ignore_errors=True)
    return {
        "seed": seed,
        "wal_mode": wal_mode,
        "crashed_mid_workload": crashed,
        "acked": len(acked),
        "checkpoints": len(acked_ckpts),
        "violations": violations,
    }


def run_crash_loop(
    iters: int = 200,
    seed: int = 0,
    wal_modes: tuple[str, ...] = ("sync", "async"),
    verbose: bool = False,
) -> dict:
    """Run ``iters`` randomized crash cycles; returns an aggregate report
    (``failures`` empty = all invariants held)."""
    base = tempfile.mkdtemp(prefix="crashloop_")
    failures = []
    crashed_mid = 0
    t0 = time.monotonic()
    try:
        for i in range(iters):
            mode = wal_modes[i % len(wal_modes)]
            # worker-thread tracebacks from simulated crashes are expected
            # noise — keep the harness output to the verdict
            with contextlib.redirect_stderr(io.StringIO()):
                res = run_iteration(seed * 1_000_003 + i, mode, base)
            crashed_mid += res["crashed_mid_workload"]
            if res["violations"]:
                failures.append(res)
            if verbose and ((i + 1) % 25 == 0 or res["violations"]):
                print(
                    f"[{i + 1}/{iters}] mode={mode} acked={res['acked']} "
                    f"violations={len(res['violations'])}",
                    flush=True,
                )
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return {
        "iterations": iters,
        "crashed_mid_workload": crashed_mid,
        "failures": failures,
        "seconds": round(time.monotonic() - t0, 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wal-mode", choices=("sync", "async", "both"), default="both")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    modes = ("sync", "async") if args.wal_mode == "both" else (args.wal_mode,)
    rep = run_crash_loop(args.iters, args.seed, modes, verbose=args.verbose)
    print(
        f"{rep['iterations']} iterations, {rep['crashed_mid_workload']} crashed "
        f"mid-workload, {len(rep['failures'])} failing, {rep['seconds']}s"
    )
    for f in rep["failures"]:
        print(f"  seed={f['seed']} mode={f['wal_mode']}:", file=sys.stderr)
        for v in f["violations"]:
            print(f"    {v}", file=sys.stderr)
    return 1 if rep["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
