"""Randomized primary/replica failover harness.

Each iteration builds a primary and a checkpoint-bootstrapped replica on
*separate* :class:`FaultInjectionEnv` instances (two machines sharing only
the replication stream), runs a randomized workload with transport faults
armed (drop / duplicate / reorder / corrupt frames in flight), and then
plays one scenario:

* **converge** — clear the faults, nudge, wait for catch-up (re-bootstrap
  if a retention hole was flagged) and require the two full scans to be
  byte-identical;
* **crash_primary** — arm a crash point on the primary's env (the op set
  includes ``ship``, so the kill can land exactly on the publish→ship
  edge), let the machine die mid-workload, ``drop_unsynced()`` its disk,
  then ``promote()`` the replica and check the failover invariants;
* **crash_promote** — same, but a second crash point on the *replica's*
  env fires during the promotion itself; the replica is then reopened and
  promoted again (promotion must be re-runnable after a torn attempt);
* **crash_replica** — the replica's machine dies mid-apply; it is
  reopened from its own surviving state, re-attached, and must converge
  (re-bootstrapping if the primary pruned WAL it now needs);
* **diverge** — the replica's applied-payload CRC state is tampered with
  (simulating an apply bug or a post-CRC bit flip); the rolling check must
  flag divergence rather than let the fork ride, and a ``rebootstrap()``
  must restore byte-identical convergence.

Checked invariants, every iteration:

* **no acked-sync write lost after failover**: in sync WAL mode every
  ``put``/``delete`` that returned before the primary died reads back
  exactly its acked value on the promoted replica;
* **async failover serves a prefix**: a promoted replica's value for any
  key is *some* state that key actually held — never garbage, never a
  resurrected overwrite;
* **no silent divergence**: whenever both sides are alive and caught up,
  their full scans match — any fork must have raised ``diverged`` /
  ``needs_rebootstrap`` (and re-bootstrapping must then heal it);
* **the promoted replica is writable** and promotion is idempotent.

Run standalone::

    PYTHONPATH=src python -m repro_torch.testing.failover_harness --iters 200
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
from repro_torch.core.replication import attach, bootstrap_replica

#: primary-side crash-point targets — ``ship`` aims the kill at the
#: publish→transport edge (after durability, before/inside the send)
PRIMARY_TARGETS = [
    (("write", "sync", "rename", "unlink", "truncate", "ship"), None),
    (("ship",), None),
    (("write",), "wal_"),
    (("sync",), "wal_"),
    (("write",), "bvalue"),
    (("sync",), "bvalue"),
]

#: replica-side targets — the apply path's own I/O (value mirror pwrite,
#: local WAL append, memtable-flush outputs)
REPLICA_TARGETS = [
    (("write", "sync", "rename", "unlink", "truncate"), None),
    (("write",), "wal_"),
    (("sync",), "wal_"),
    (("write",), "bvalue"),
]

SCENARIOS = ("converge", "crash_primary", "crash_promote", "crash_replica",
             "diverge")


def _mkcfg(wal_mode: str, env: FaultInjectionEnv) -> DBConfig:
    cfg = DBConfig.bvlsm(
        wal_mode=wal_mode,
        value_threshold=64,
        memtable_size=4096,
        num_bvalue_queues=2,
    )
    cfg.env = env
    cfg.bg_error_backoff_ms = 1.0
    cfg.repl_batch_bytes = 4096       # many small frames → more fault edges
    cfg.repl_crc_interval = 16        # frequent divergence checks
    return cfg


def _scan_all(db: DB) -> list:
    return list(db.range())


def _compare_scans(primary: DB, replica: DB, what: str) -> str | None:
    """Full-scan equality check; an exception on either side is itself a
    violation (a converged replica must be fully readable)."""
    try:
        ps = _scan_all(primary)
    except Exception as e:
        return f"primary scan failed ({what}): {type(e).__name__}: {e}"
    try:
        rs = _scan_all(replica)
    except Exception as e:
        return f"replica scan failed ({what}): {type(e).__name__}: {e}"
    if ps != rs:
        return f"silent divergence {what}"
    return None


def _wait_converged(primary: DB, link, timeout: float = 10.0) -> str | None:
    """Drive the replica to the primary's seq, re-bootstrapping if the
    stream flagged a hole. Returns an error string or None."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        link.nudge()
        if link.follower.wait_caught_up(primary._seq, timeout=1.0):
            return None
        if link.follower.needs_rebootstrap or link.follower.diverged:
            try:
                link.rebootstrap()
            except Exception as e:
                return f"rebootstrap failed: {type(e).__name__}: {e}"
    return f"never converged: lag={link.lag}"


def run_iteration(seed: int, wal_mode: str, base_dir: str) -> dict:
    """One replication cycle. Returns a result dict with ``violations``
    (empty list = pass)."""
    rng = random.Random(seed)
    ppath = os.path.join(base_dir, f"p{seed}")
    rpath = os.path.join(base_dir, f"r{seed}")
    penv = FaultInjectionEnv(seed=seed)
    renv = FaultInjectionEnv(seed=seed + 1)
    scenario = SCENARIOS[rng.randrange(len(SCENARIOS))]

    primary = DB(ppath, _mkcfg(wal_mode, penv))
    keys = [f"key{i:03d}".encode() for i in range(rng.randrange(8, 32))]
    acked: dict[bytes, bytes | None] = {}
    history: dict[bytes, set] = {k: {None} for k in keys}

    def workload(db: DB, n: int) -> bool:
        """Run ``n`` random ops; True if the machine died mid-way."""
        for _i in range(n):
            k = keys[rng.randrange(len(keys))]
            try:
                r = rng.random()
                if r < 0.08:
                    db.delete(k)
                    acked[k] = None
                    history[k].add(None)
                elif r < 0.11:
                    a, b = sorted(rng.sample(keys, 2))
                    db.delete_range(a, b)
                    for kk in keys:
                        if a <= kk < b:
                            acked[kk] = None
                            history[kk].add(None)
                elif r < 0.15:
                    db.flush()
                else:
                    size = rng.choice((8, 40, 200, 700))
                    v = (f"s{seed}v{rng.randrange(1 << 30)}_".encode() * 8)[:size]
                    db.put(k, v)
                    acked[k] = v
                    history[k].add(v)
            except Exception:
                return True
        return False

    # seed data so the bootstrap checkpoint is non-trivial
    workload(primary, rng.randrange(20, 80))
    if rng.random() < 0.5:
        primary.flush()

    replica = bootstrap_replica(primary, rpath, cfg=_mkcfg(wal_mode, renv))
    link = attach(primary, replica)

    # transport faults for the streaming phase (never enough to stall
    # forever: catch-up bridges anything the wire loses)
    if rng.random() < 0.7:
        penv.set_transport_faults(
            drop=rng.uniform(0, 0.2),
            duplicate=rng.uniform(0, 0.15),
            reorder=rng.uniform(0, 0.15),
            corrupt=rng.uniform(0, 0.1),
        )

    violations: list[str] = []
    n_ops = rng.randrange(40, 200)

    if scenario in ("crash_primary", "crash_promote"):
        ops, substr = PRIMARY_TARGETS[rng.randrange(len(PRIMARY_TARGETS))]
        penv.set_crash_after(rng.randrange(5, 300), ops=ops, path_substr=substr)
        workload(primary, n_ops)
        try:
            primary.close(crash=True)
        except Exception:
            pass
        penv.drop_unsynced()
        # the machine is dead but its disk survives: the failover catch-up
        # reads the durable WAL from it, so reads must work again
        penv.disarm_crash()
        penv.set_transport_faults()  # wire gone with the machine

        if scenario == "crash_promote":
            # second kill: the promotion itself dies mid-way on the replica
            ops, substr = REPLICA_TARGETS[rng.randrange(len(REPLICA_TARGETS))]
            renv.set_crash_after(rng.randrange(2, 60), ops=ops, path_substr=substr)
            try:
                replica.promote()
            except Exception:
                pass
            try:
                replica.close(crash=True)
            except Exception:
                pass
            renv.drop_unsynced()
            renv.reset()
            try:
                replica = DB(rpath, _mkcfg(wal_mode, renv), role="replica")
            except Exception as e:
                violations.append(
                    f"replica reopen after torn promote failed: "
                    f"{type(e).__name__}: {e}"
                )
                replica = None
            if replica is not None:
                # re-run the failover: a fresh follower re-reads the dead
                # primary's durable WAL from scratch for the final catch-up
                from repro_torch.core.replication import Follower

                replica._follower = Follower(replica, ppath,
                                             primary_env=renv)
                try:
                    replica.promote()
                except Exception as e:
                    violations.append(
                        f"re-promote failed: {type(e).__name__}: {e}"
                    )
        else:
            try:
                replica.promote()
            except Exception as e:
                violations.append(f"promote failed: {type(e).__name__}: {e}")

        if replica is not None and not violations:
            if replica.replication_status()["role"] != "primary":
                violations.append("promoted replica did not flip role")
            for k, want in acked.items():
                try:
                    got = replica.get(k)
                except Exception as e:
                    violations.append(
                        f"get({k!r}) failed: {type(e).__name__}: {e}")
                    continue
                if wal_mode == "sync":
                    if got != want:
                        violations.append(
                            f"lost acked-sync write {k!r}: "
                            f"want {want!r} got {got!r}")
                elif got not in history[k]:
                    violations.append(f"non-prefix value for {k!r}: {got!r}")
            try:
                replica.promote()  # idempotent
                replica.put(b"post-failover-probe", b"ok")
                if replica.get(b"post-failover-probe") != b"ok":
                    violations.append("post-failover write not readable")
            except Exception as e:
                violations.append(
                    f"promoted replica unusable: {type(e).__name__}: {e}")
        if replica is not None:
            with contextlib.suppress(Exception):
                replica.close()

    elif scenario == "crash_replica":
        ops, substr = REPLICA_TARGETS[rng.randrange(len(REPLICA_TARGETS))]
        renv.set_crash_after(rng.randrange(5, 200), ops=ops, path_substr=substr)
        workload(primary, n_ops)
        link.detach()
        try:
            replica.close(crash=True)
        except Exception:
            pass
        renv.drop_unsynced()
        renv.reset()
        penv.set_transport_faults()
        try:
            replica = DB(rpath, _mkcfg(wal_mode, renv), role="replica")
        except Exception as e:
            violations.append(
                f"replica reopen failed: {type(e).__name__}: {e}")
            replica = None
        if replica is not None:
            link = attach(primary, replica)
            workload(primary, rng.randrange(10, 50))
            err = _wait_converged(primary, link)
            if err:
                violations.append(err)
            else:
                replica = link.replica
                err = _compare_scans(primary, replica, "after replica crash")
                if err:
                    violations.append(err)
            with contextlib.suppress(Exception):
                replica.close()
        primary.close()

    elif scenario == "diverge":
        workload(primary, n_ops // 2)
        penv.set_transport_faults()
        err = _wait_converged(primary, link)
        follower = link.follower
        interval = max(1, replica.cfg.repl_crc_interval)
        # poison the CRC fold of a run that has not STARTED yet: the seeds
        # the follower will fold real payloads onto are now wrong, so the
        # digest the primary ships for that run cannot match (an apply bug
        # in effigy — the frame CRC sees nothing)
        target_run = primary._seq // interval + 1
        with follower._lock:
            follower._runs[target_run] = 0x5A5A5A5A
        # push the stream well past the poisoned run so it completes and
        # its digest rides a later frame out
        for i in range(interval * 3):
            primary.put(f"div{i:04d}".encode(), b"d" * 80)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not follower.diverged:
            link.nudge()
            time.sleep(0.02)
        if err is None and not follower.diverged:
            violations.append("tampered CRC fold never flagged divergence")
        if follower.diverged and not follower.needs_rebootstrap:
            violations.append("diverged without needs_rebootstrap")
        try:
            replica = link.rebootstrap()
        except Exception as e:
            violations.append(f"rebootstrap failed: {type(e).__name__}: {e}")
            replica = None
        if replica is not None:
            err = _wait_converged(primary, link)
            if err:
                violations.append(f"post-rebootstrap {err}")
            else:
                err = _compare_scans(primary, replica, "after rebootstrap")
                if err:
                    violations.append(err)
            with contextlib.suppress(Exception):
                replica.close()
        primary.close()

    else:  # converge
        workload(primary, n_ops)
        penv.set_transport_faults()
        err = _wait_converged(primary, link)
        if err:
            violations.append(err)
        else:
            replica = link.replica
            err = _compare_scans(primary, replica, "in steady state")
            if err:
                f = link.follower
                if not (f.diverged or f.needs_rebootstrap):
                    violations.append(err)
            if replica.replication_status().get("lag", 0) != 0:
                violations.append("caught-up replica reports non-zero lag")
        with contextlib.suppress(Exception):
            link.replica.close()
        primary.close()

    for p in (ppath, rpath, rpath + ".rebase"):
        shutil.rmtree(p, ignore_errors=True)
    return {
        "seed": seed,
        "wal_mode": wal_mode,
        "scenario": scenario,
        "acked": len(acked),
        "violations": violations,
    }


def run_failover_loop(
    iters: int = 200,
    seed: int = 0,
    wal_modes: tuple[str, ...] = ("sync", "async"),
    verbose: bool = False,
) -> dict:
    """Run ``iters`` randomized replication/failover cycles; returns an
    aggregate report (``failures`` empty = all invariants held)."""
    base = tempfile.mkdtemp(prefix="failover_")
    failures = []
    by_scenario: dict[str, int] = {}
    t0 = time.monotonic()
    try:
        for i in range(iters):
            mode = wal_modes[i % len(wal_modes)]
            with contextlib.redirect_stderr(io.StringIO()):
                res = run_iteration(seed * 1_000_003 + i, mode, base)
            by_scenario[res["scenario"]] = by_scenario.get(res["scenario"], 0) + 1
            if res["violations"]:
                failures.append(res)
            if verbose and ((i + 1) % 25 == 0 or res["violations"]):
                print(
                    f"[{i + 1}/{iters}] mode={mode} scenario={res['scenario']} "
                    f"violations={len(res['violations'])}",
                    flush=True,
                )
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return {
        "iterations": iters,
        "scenarios": by_scenario,
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
    rep = run_failover_loop(args.iters, args.seed, modes, verbose=args.verbose)
    print(
        f"{rep['iterations']} iterations {rep['scenarios']}, "
        f"{len(rep['failures'])} failing, {rep['seconds']}s"
    )
    for f in rep["failures"]:
        print(f"  seed={f['seed']} mode={f['wal_mode']} "
              f"scenario={f['scenario']}:", file=sys.stderr)
        for v in f["violations"]:
            print(f"    {v}", file=sys.stderr)
    return 1 if rep["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
