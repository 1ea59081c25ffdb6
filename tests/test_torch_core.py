"""The port's BVLSM engine (``repro_torch.core``) against the reference's
(``repro.core``) on the CPU: the reference's differential spec run against
the port's engine, the two engines in lockstep over one seeded op stream
(every read equal, byte-identical directories, equal byte counters), each
engine opening the other's directory after a clean close and after a
simulated crash, and the port's MessagePack codec byte-equal to ``msgpack``
on the engine's own MANIFEST edits, SST index and range-tombstone blocks,
``ShardedDB``'s ``ROUTER`` and ``ROUTER_LOG`` records and replication
frames."""
import os

import msgpack
import numpy as np
import pytest

import repro.core as ref_core
import repro.testing.model_db as model_db
import repro_torch.core as port_core
from repro_torch import _msgpack
from repro_torch.core import db as port_db
from repro_torch.core import manifest as port_manifest
from repro_torch.core import replication as port_replication
from repro_torch.core import sharded as port_sharded
from repro_torch.core import sstable as port_sstable

CORES = {"ref": ref_core, "port": port_core}
THRESHOLD = 1024
# sizes on both sides of the separation threshold, and a value many blocks long
SIZES = (16, 200, THRESHOLD - 1, THRESHOLD, THRESHOLD + 1, 5000, 70_000)


def _cfg(core):
    """A memtable no op stream here fills and one compaction shard: files
    change only at the stream's flush, compaction and GC points, so both
    engines lay out the same files whatever their threads' timing."""
    return core.DBConfig.bvlsm(value_threshold=THRESHOLD, memtable_size=4 << 20, num_bvalue_queues=2,
                               l0_compaction_trigger=3, max_subcompactions=1)


@pytest.fixture
def opened():
    """Opens engines for a test and closes every one still open after it:
    background threads left running would hang the run."""
    dbs = []

    def open_(core, path):
        db = core.DB.open(str(path), _cfg(core))
        dbs.append(db)
        return db

    yield open_
    for db in dbs:
        db.close()


def _value(rng, size):
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def _same(dbs, fn, point=None):
    """``fn(db, snapshot)`` on the reference's engine and on the port's, at
    one read point (None: the latest; else an engine → snapshot dict):
    equal results."""
    a, b = (fn(dbs[name], point[name] if point else None) for name in ("ref", "port"))
    assert a == b
    return a


def _cursor_walk(db, snap, start, rng_steps):
    out = []
    with db.iterator(snap) as cur:
        cur.seek(start)
        out.append(cur.key if cur.valid else None)
        for step in rng_steps:
            if not cur.valid:
                break
            (cur.next if step else cur.prev)()
            out.append((cur.key, cur.value) if cur.valid else None)
    return out


def _check_reads(dbs, snaps, keys, rng):
    for point in [None] + snaps:
        some = [keys[j] for j in rng.integers(0, len(keys), 4)]
        for k in some:
            _same(dbs, lambda db, snap, k=k: db.get(k, snapshot=snap), point)
        _same(dbs, lambda db, snap: db.multi_get(some, snapshot=snap), point)
        a, b = sorted(keys[j] for j in rng.integers(0, len(keys), 2))
        limit = int(rng.integers(1, 12))
        _same(dbs, lambda db, snap: list(db.range(a, b + b"\x00", limit=limit, snapshot=snap)), point)
        steps = [bool(s) for s in rng.integers(0, 2, 5)]
        _same(dbs, lambda db, snap: _cursor_walk(db, snap, a, steps), point)


def _run_stream(dbs, rng, keys, n_ops, reopen):
    """The seeded op stream on both engines, reads checked after every op.
    Returns {key: value} as acknowledged (sync WAL: as durable)."""
    snaps: list[dict] = []
    acked: dict = {}
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.45:
            k, v = keys[rng.integers(len(keys))], _value(rng, SIZES[rng.integers(len(SIZES))])
            _same(dbs, lambda db, _: db.put(k, v))
            acked[k] = v
        elif r < 0.53:
            k = keys[rng.integers(len(keys))]
            _same(dbs, lambda db, _: db.delete(k))
            acked[k] = None
        elif r < 0.60:
            a, b = sorted(keys[j] for j in rng.choice(len(keys), 2, replace=False))
            _same(dbs, lambda db, _: db.delete_range(a, b))
            acked.update({k: None for k in keys if a <= k < b})
        elif r < 0.68:
            ops = [(int(rng.integers(3)), keys[rng.integers(len(keys))],
                    _value(rng, SIZES[rng.integers(len(SIZES))])) for _ in range(int(rng.integers(1, 6)))]

            def batch(db, core):
                wb = core.WriteBatch()
                for kind, k, v in ops:
                    (wb.put(k, v) if kind < 2 else wb.delete(k))
                db.write(wb)

            batch(dbs["ref"], ref_core)
            batch(dbs["port"], port_core)
            for kind, k, v in ops:
                acked[k] = v if kind < 2 else None
        elif r < 0.74:
            if len(snaps) < 3:
                snaps.append({name: db.snapshot() for name, db in dbs.items()})
            else:
                for s in snaps.pop(int(rng.integers(len(snaps)))).values():
                    s.release()
        elif r < 0.82:
            _same(dbs, lambda db, _: (db.flush(), db.wait_idle()))
        elif r < 0.86:
            _same(dbs, lambda db, _: db.compact_all())
        elif r < 0.90:
            res = _same(dbs, lambda db, _: db.gc_collect(threshold=0.3))
            assert isinstance(res, dict)
        elif r < 0.93 and reopen is not None:
            for pair in snaps:
                for s in pair.values():
                    s.release()
            snaps.clear()
            reopen()
        else:
            k = keys[rng.integers(len(keys))]
            _same(dbs, lambda db, _: db.get(k))
        _check_reads(dbs, snaps, keys, rng)
    for pair in snaps:
        for s in pair.values():
            s.release()
    return acked


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


COUNTERS = ("user_writes", "user_bytes", "wal_bytes", "bvalue_bytes", "flush_bytes", "compaction_bytes")


@pytest.mark.parametrize("seed", [0, 1])
def test_lockstep_with_reference_engine(tmp_path, opened, seed):
    """One seeded stream of puts straddling the threshold, deletes, range
    deletes, batches, snapshots, flushes, compactions, GC passes and
    re-opens through both engines: every get, multi_get, range and cursor
    read equal; the byte counters equal; after flush, wait_idle and
    compact_all, both directories hold the same files, byte for byte."""
    rng = np.random.default_rng(seed)
    keys = [f"key{i:03d}".encode() for i in range(40)]
    paths = {name: tmp_path / name for name in CORES}
    dbs = {name: opened(CORES[name], paths[name]) for name in CORES}

    def reopen():
        for name in CORES:
            dbs[name].close()
            dbs[name] = opened(CORES[name], paths[name])

    _run_stream(dbs, rng, keys, 260, reopen)
    for db in dbs.values():
        db.flush()
        db.wait_idle()
        db.compact_all()
    stats = {name: db.stats() for name, db in dbs.items()}
    assert {k: stats["ref"][k] for k in COUNTERS} == {k: stats["port"][k] for k in COUNTERS}
    assert stats["port"]["bvalue_bytes"] > 0 and stats["port"]["flush_bytes"] > 0
    _same(dbs, lambda db, _: list(db.range()))
    for db in dbs.values():
        db.close()
    ref_files, port_files = _tree(paths["ref"]), _tree(paths["port"])
    assert sorted(ref_files) == sorted(port_files)
    assert any(f.endswith(".sst") for f in port_files) and any("bvalue" in f for f in port_files)
    differ = [f for f in ref_files if ref_files[f] != port_files[f]]
    assert not differ, f"files that differ: {differ}"


@pytest.mark.parametrize("how", ["clean", "crash"])
def test_each_engine_opens_the_others_directory(tmp_path, opened, how):
    """The same stream through both engines (sync WAL), then a clean close or
    a simulated crash (no memtable flush): the port's engine opens the
    reference's directory and the reference's the port's, and each reads
    every acknowledged write, takes a new one and passes its scrub."""
    rng = np.random.default_rng(7)
    keys = [f"key{i:03d}".encode() for i in range(30)]
    paths = {name: tmp_path / name for name in CORES}
    dbs = {name: opened(CORES[name], paths[name]) for name in CORES}
    acked = _run_stream(dbs, rng, keys, 120, None)
    for db in dbs.values():
        db.close(crash=how == "crash")
    for reader, writer in (("port", "ref"), ("ref", "port")):
        db = opened(CORES[reader], paths[writer])
        assert db.multi_get(list(acked)) == list(acked.values()), f"{reader} reading {writer}'s directory"
        assert [k for k, _ in db.range()] == sorted(k for k, v in acked.items() if v is not None)
        db.put(b"after", b"x" * 5000)
        db.flush()
        assert db.get(b"after") == b"x" * 5000
        assert db.verify_integrity()["findings"] == []
        db.close()


def test_reference_differential_spec_runs_clean_on_the_port_engine(monkeypatch):
    """``repro.testing.model_db``'s executable spec, checked after every op,
    with the engine swapped for the port's: 100 examples, no divergence."""
    monkeypatch.setattr(model_db, "DB", port_core.DB)
    monkeypatch.setattr(model_db, "DBConfig", port_core.DBConfig)
    monkeypatch.setattr(model_db, "WriteBatch", port_core.WriteBatch)
    res = model_db.run_differential(examples=100, seed=3)
    assert res["examples"] == 100 and res["failures"] == []


# ---------------------------------------------------------------------------
# the codec on the engine's own records
# ---------------------------------------------------------------------------

class _Recorded:
    """Stands in for ``msgpack`` in one engine module: encodes and decodes
    with the port's codec and records each call beside ``msgpack``'s."""

    def __init__(self, site, calls):
        self.site, self.calls = site, calls

    def packb(self, obj, **kw):
        ours = _msgpack.packb(obj, **kw)
        self.calls.append((self.site, "packb", obj, ours, msgpack.packb(obj, **kw)))
        return ours

    def unpackb(self, data, **kw):  # the engine passes raw=False by keyword
        ours = _msgpack.unpackb(data, **kw)
        self.calls.append((self.site, "unpackb", bytes(data), ours, msgpack.unpackb(data, **kw)))
        return ours


@pytest.fixture(scope="module")
def codec_calls(tmp_path_factory):
    """Every MessagePack call of a port engine that flushes, range-deletes,
    compacts, takes a checkpoint and reopens (MANIFEST replayed, SSTs read);
    of a range-partitioned port ``ShardedDB`` that takes single- and
    cross-shard batches and reopens (``ROUTER`` and ``ROUTER_LOG`` written
    and read); and of a port primary shipping to a replica (frames packed
    and read)."""
    calls = []
    mp = pytest.MonkeyPatch()
    for site, mod in (("manifest", port_manifest), ("sstable", port_sstable), ("db", port_db),
                      ("sharded", port_sharded), ("replication", port_replication)):
        mp.setattr(mod, "msgpack", _Recorded(site, calls))
    root = tmp_path_factory.mktemp("codec")
    rng = np.random.default_rng(3)
    db = port_core.DB.open(str(root / "db"), _cfg(port_core))
    try:
        for i in range(300):
            db.put(f"k{i % 97:04d}".encode(), _value(rng, SIZES[i % len(SIZES)]))
            if i % 60 == 59:
                db.delete_range(f"k{i % 50:04d}".encode(), f"k{i % 50 + 9:04d}".encode())
                db.flush()
        db.compact_all()
        db.checkpoint(str(root / "image"))
    finally:
        db.close()
    for path in (root / "db", root / "image"):
        db = port_core.DB.open(str(path), _cfg(port_core))
        try:
            assert len(list(db.range())) > 0
        finally:
            db.close()
    for _ in range(2):  # create, then reopen: the ROUTER read back, ROUTER_LOG replayed
        sdb = port_core.ShardedDB.open(str(root / "sharded"), shards=3, config=_cfg(port_core),
                                       partitioner="range", boundaries=[b"k0030", b"k0060"])
        try:
            for i in range(0, 90, 7):
                sdb.write(port_core.WriteBatch().put(f"k{i:04d}".encode(), _value(rng, 2000))
                          .put(f"k{(i + 31) % 90:04d}".encode(), _value(rng, 300)))
                sdb.put(f"k{i + 1:04d}".encode(), b"single")
            sdb.delete_range(b"k0010", b"k0070")
            assert len(list(sdb.range())) > 0
        finally:
            sdb.close()
    primary = port_core.DB.open(str(root / "primary"), _cfg(port_core))
    replica = port_core.bootstrap_replica(primary, str(root / "replica"), cfg=_cfg(port_core))
    try:
        link = port_core.attach(primary, replica)
        for i in range(40):
            primary.put(f"r{i:04d}".encode(), _value(rng, SIZES[i % len(SIZES)]))
        assert link.wait_caught_up(timeout=30)
    finally:
        primary.close()
        replica.close()
    mp.undo()
    return calls


def _is_range_block(obj):
    return isinstance(obj, list) and obj and isinstance(obj[0], list) and isinstance(obj[0][0], int)


CODEC_SITES = {
    "manifest edits written": lambda c: c[0] == "manifest" and c[1] == "packb",
    "manifest edits replayed": lambda c: c[0] == "manifest" and c[1] == "unpackb",
    "checkpoint manifest": lambda c: c[0] == "db" and c[1] == "packb",
    "sst index blocks": lambda c: c[0] == "sstable" and c[1] == "packb" and not _is_range_block(c[2]),
    "sst range-tombstone blocks": lambda c: c[0] == "sstable" and c[1] == "packb" and _is_range_block(c[2]),
    "sst blocks read": lambda c: c[0] == "sstable" and c[1] == "unpackb",
    "ROUTER manifest written": lambda c: c[0] == "sharded" and c[1] == "packb" and "shards" in c[2],
    "ROUTER manifest read": lambda c: c[0] == "sharded" and c[1] == "unpackb" and "shards" in c[3],
    "ROUTER_LOG records written": lambda c: c[0] == "sharded" and c[1] == "packb" and "t" in c[2],
    "ROUTER_LOG records read": lambda c: c[0] == "sharded" and c[1] == "unpackb" and "t" in c[3],
    "replication frames shipped": lambda c: c[0] == "replication" and c[1] == "packb",
    "replication frames read": lambda c: c[0] == "replication" and c[1] == "unpackb",
}


@pytest.mark.parametrize("site", list(CODEC_SITES))
def test_codec_matches_msgpack_on_engine_records(codec_calls, site):
    """The port's codec writes what ``msgpack.packb(obj, use_bin_type=True)``
    writes, and reads what ``msgpack.unpackb(raw, raw=False)`` reads, on
    every record of that kind the engine wrote or read."""
    calls = [c for c in codec_calls if CODEC_SITES[site](c)]
    assert calls, f"the workload made no {site}"
    for _, _, _, ours, theirs in calls:
        assert ours == theirs


def test_codec_rejects_the_settings_the_engine_never_uses():
    with pytest.raises(ValueError):
        _msgpack.packb(b"x", use_bin_type=False)
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb("x"), raw=True)
