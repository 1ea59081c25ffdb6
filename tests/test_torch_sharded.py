"""The port's ``ShardedDB`` (``repro_torch.core.sharded``) against the
reference's (``repro.core.sharded``) on the CPU: the two routers in lockstep
over one seeded op stream under both partitioners (every read equal, summed
counters equal, byte-identical ``ROUTER``, ``ROUTER_LOG`` and ``shard_*``
directories and checkpoint images), each package opening the other's
sharded directory after a clean close and after a crash that leaves an
uncommitted cross-shard intent in ``ROUTER_LOG``, the reference's
differential spec with the port's names swapped in and the port's own copy
of it, and the paper's configs field for field."""
import dataclasses
import os

import numpy as np
import pytest

import repro.configs.bvlsm_paper as ref_paper
import repro.core as ref_core
import repro.testing.model_db as ref_model_db
import repro_torch.configs.bvlsm_paper as port_paper
import repro_torch.core as port_core
import repro_torch.testing.model_db as port_model_db
from repro_torch import _msgpack
from repro_torch.core.record import iter_framed_records

CORES = {"ref": ref_core, "port": port_core}
SHARDS = 3
THRESHOLD = 1024
# sizes on both sides of the separation threshold, and a value many blocks long
SIZES = (16, 200, THRESHOLD - 1, THRESHOLD, THRESHOLD + 1, 5000, 70_000)
KEYS = [f"key{i:03d}".encode() for i in range(40)]
PARTITIONERS = {"hash": {}, "range": {"partitioner": "range", "boundaries": [b"key013", b"key026"]}}


def _cfg(core):
    """tests/test_torch_core.py's: no op stream here fills a memtable, and
    compactions run in one piece, so each shard's files change only at the
    stream's flush, compaction and GC points whatever the threads' timing.
    ``router_parallel_fanout`` stays at its default (on): each shard is
    written by one thread at a time, so the fan-out reorders nothing that a
    shard's files record."""
    return core.DBConfig.bvlsm(value_threshold=THRESHOLD, memtable_size=4 << 20, num_bvalue_queues=2,
                               l0_compaction_trigger=3, max_subcompactions=1)


@pytest.fixture
def opened():
    """Opens sharded stores for a test and closes every one still open
    after it: background threads left running would hang the run."""
    stores = []

    def open_(core, path, **kw):
        sdb = core.ShardedDB.open(str(path), shards=SHARDS, config=_cfg(core), **kw)
        stores.append(sdb)
        return sdb

    yield open_
    for sdb in stores:
        sdb.close()


def _value(rng, size):
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def _same(dbs, fn, point=None):
    """``fn(store, snapshot)`` on the reference's router and on the port's,
    at one read point (None: the latest): equal results."""
    a, b = (fn(dbs[name], point[name] if point else None) for name in ("ref", "port"))
    assert a == b
    return a


def _cursor_walk(sdb, snap, start, steps):
    """A merged cursor from ``start``, then ``next``/``prev`` by ``steps``,
    and from past the end backwards (an invalid cursor's ``prev``)."""
    out = []
    with sdb.iterator(snap) as cur:
        cur.seek(start)
        out.append(cur.key if cur.valid else None)
        for step in steps:
            if not cur.valid:
                break
            (cur.next if step else cur.prev)()
            out.append((cur.key, cur.value) if cur.valid else None)
    with sdb.iterator(snap) as cur:
        cur.seek(b"\xff")
        for _ in range(3):
            cur.prev()
            out.append(cur.key if cur.valid else None)
    return out


def _check_reads(dbs, snaps, rng):
    for point in [None] + snaps:
        some = [KEYS[j] for j in rng.integers(0, len(KEYS), 5)]
        for k in some[:3]:
            _same(dbs, lambda db, snap, k=k: db.get(k, snapshot=snap), point)
        _same(dbs, lambda db, snap: db.multi_get(some, snapshot=snap), point)
        a, b = sorted(KEYS[j] for j in rng.integers(0, len(KEYS), 2))
        limit = int(rng.integers(1, 14))
        _same(dbs, lambda db, snap: list(db.range(a, b + b"\x00", limit=limit, snapshot=snap)), point)
        steps = [bool(s) for s in rng.integers(0, 2, 6)]
        _same(dbs, lambda db, snap: _cursor_walk(db, snap, a, steps), point)


def _batch_ops(rng, shard_of, single_shard):
    """1–6 puts and deletes, all on one shard or spread over several; a
    spread batch sometimes carries a range delete too."""
    keys = KEYS
    if single_shard:
        home = shard_of(KEYS[rng.integers(len(KEYS))])
        keys = [k for k in KEYS if shard_of(k) == home]
    ops = [(int(rng.integers(3)), keys[rng.integers(len(keys))], _value(rng, SIZES[rng.integers(len(SIZES))]))
           for _ in range(int(rng.integers(1, 7)))]
    if not single_shard and rng.random() < 0.3:
        a, b = sorted(KEYS[j] for j in rng.choice(len(KEYS), 2, replace=False))
        ops.append((3, a, b))
    return ops


def _apply_batch(dbs, ops):
    for name, sdb in dbs.items():
        wb = CORES[name].WriteBatch()
        for kind, k, v in ops:
            if kind < 2:
                wb.put(k, v)
            elif kind == 2:
                wb.delete(k)
            else:
                wb.delete_range(k, v)
        sdb.write(wb)


def _run_stream(dbs, rng, n_ops, reopen, images):
    """The seeded op stream on both routers, reads checked after every op.
    Returns {key: value} as acknowledged (sync WAL: as durable)."""
    snaps: list[dict] = []
    acked: dict = {}
    shard_of = dbs["port"].shard_of
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.36:
            k, v = KEYS[rng.integers(len(KEYS))], _value(rng, SIZES[rng.integers(len(SIZES))])
            _same(dbs, lambda db, _: db.put(k, v))
            acked[k] = v
        elif r < 0.42:
            k = KEYS[rng.integers(len(KEYS))]
            _same(dbs, lambda db, _: db.delete(k))
            acked[k] = None
        elif r < 0.48:
            a, b = sorted(KEYS[j] for j in rng.choice(len(KEYS), 2, replace=False))
            _same(dbs, lambda db, _: db.delete_range(a, b))
            acked.update({k: None for k in KEYS if a <= k < b})
        elif r < 0.62:
            ops = _batch_ops(rng, shard_of, single_shard=rng.random() < 0.4)
            _apply_batch(dbs, ops)
            for kind, k, v in ops:
                if kind == 3:
                    acked.update({key: None for key in KEYS if k <= key < v})
                else:
                    acked[k] = v if kind < 2 else None
        elif r < 0.68:
            if len(snaps) < 3:
                snaps.append({name: db.snapshot() for name, db in dbs.items()})
            else:
                for s in snaps.pop(int(rng.integers(len(snaps)))).values():
                    s.release()
        elif r < 0.76:
            _same(dbs, lambda db, _: (db.flush(), db.wait_idle()))
        elif r < 0.80:
            _same(dbs, lambda db, _: db.compact_all())
        elif r < 0.83:
            res = _same(dbs, lambda db, _: db.gc_collect(threshold=0.3))
            assert len(res["per_shard"]) == SHARDS
        elif r < 0.86 and images is not None:
            for name, db in dbs.items():
                # an online image holds the files the shards have at that
                # instant: the checkpoint's own flush can reach the L0
                # trigger, and whether the compaction it starts lands in the
                # image is the threads' timing, in either package. Flushed
                # and idle first, the checkpoint flushes nothing.
                db.flush()
                db.wait_idle()
                db.checkpoint(str(images[name] / f"image{len(os.listdir(images[name]))}"))
        elif r < 0.89 and reopen is not None:
            for pair in snaps:
                for s in pair.values():
                    s.release()
            snaps.clear()
            reopen()
        else:
            k = KEYS[rng.integers(len(KEYS))]
            _same(dbs, lambda db, _: db.get(k))
        _check_reads(dbs, snaps, rng)
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


def _assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    differ = [f for f in ta if ta[f] != tb[f]]
    assert not differ, f"files that differ: {differ}"
    return ta


COUNTERS = ("user_writes", "user_bytes", "wal_bytes", "bvalue_bytes", "flush_bytes", "compaction_bytes")


@pytest.mark.parametrize("partitioner", list(PARTITIONERS))
def test_lockstep_with_reference_router(tmp_path, opened, partitioner):
    """One seeded stream of puts straddling the threshold, deletes, range
    deletes, single- and cross-shard batches (some with a range delete),
    snapshots, flushes, compactions, GC passes, checkpoints and re-opens
    through both routers at 3 shards: every get, multi_get, range and merged
    cursor read (both ways) equal; the summed byte counters and the router's
    counters equal; after flush, wait_idle and compact_all both directories
    (``ROUTER``, ``ROUTER_LOG``, every ``shard_*``) and every checkpoint image
    hold the same files, byte for byte, and each image reads as its source
    did."""
    rng = np.random.default_rng(11)
    kw = PARTITIONERS[partitioner]
    paths = {name: tmp_path / name for name in CORES}
    images = {name: tmp_path / f"{name}_images" for name in CORES}
    for d in images.values():
        d.mkdir()
    dbs = {name: opened(CORES[name], paths[name], **kw) for name in CORES}

    def reopen():
        for name in CORES:
            dbs[name].close()
            dbs[name] = opened(CORES[name], paths[name])  # the ROUTER names the partitioner

    _run_stream(dbs, rng, 240, reopen, images)
    for db in dbs.values():
        db.flush()
        db.wait_idle()
        db.compact_all()
    stats = {name: db.stats() for name, db in dbs.items()}
    agg = {name: {k: s["aggregate"][k] for k in COUNTERS} for name, s in stats.items()}
    assert agg["ref"] == agg["port"]
    assert (stats["ref"]["router"], stats["ref"]["router_log_bytes"]) == (stats["port"]["router"],
                                                                          stats["port"]["router_log_bytes"])
    assert stats["port"]["router"]["cross_shard_batches"] > 0 and stats["port"]["router"]["single_shard_batches"] > 0
    assert stats["port"]["aggregate"]["bvalue_bytes"] > 0
    everything = _same(dbs, lambda db, _: list(db.range()))
    for db in dbs.values():
        db.close()
    files = _assert_same_tree(paths["ref"], paths["port"])
    assert {"ROUTER", "ROUTER_LOG"} <= set(files)
    assert {f.split(os.sep)[0] for f in files if f.startswith("shard_")} == {f"shard_{i:05d}" for i in range(SHARDS)}
    for i in range(SHARDS):
        assert any(f.startswith(f"shard_{i:05d}{os.sep}bvalue") for f in files), f"shard {i} holds no BValue file"
    assert any(f.endswith(".sst") for f in files)
    assert _msgpack.unpackb(files["ROUTER"])["partitioner"] == partitioner
    names = sorted(os.listdir(images["port"]))
    assert names and names == sorted(os.listdir(images["ref"]))
    for name in names:
        _assert_same_tree(images["ref"] / name, images["port"] / name)
    # the last image, opened as a store of its own, is a point the stream passed through
    for core, root in ((port_core, images["ref"]), (ref_core, images["port"])):
        img = core.ShardedDB.open(str(root / names[-1]), config=_cfg(core))
        try:
            assert img.verify_integrity()["findings"] == [] and len(list(img.range())) > 0
        finally:
            img.close()
    reopened = {name: opened(CORES[name], paths[name]) for name in CORES}
    assert _same(reopened, lambda db, _: list(db.range())) == everything


def _crash_mid_cross_shard_batch(sdb, core, ops):
    """A cross-shard batch whose intent reaches ``ROUTER_LOG`` and whose
    apply dies after the first shard's sub-batch, with no commit record:
    the machine stops there."""
    real_fan = sdb._fan

    def dying_fan(fns):
        fns[0]()
        raise core.SimulatedCrashError("the machine died mid-apply")

    sdb._fan = dying_fan
    wb = core.WriteBatch()
    for k, v in ops:
        wb.put(k, v)
    with pytest.raises(core.SimulatedCrashError):
        sdb.write(wb)
    sdb._fan = real_fan


@pytest.mark.parametrize("how", ["clean", "crash"])
def test_each_router_opens_the_others_directory(tmp_path, opened, how):
    """The same stream through both routers (sync WAL), then a clean close,
    or a crash in the middle of a cross-shard batch: its intent is in
    ``ROUTER_LOG`` without a commit record, one shard holds its piece and
    the others do not, and no memtable is flushed. The port opens the
    reference's directory and the reference the port's; each completes the
    batch from the log, reads every acknowledged write and the whole batch,
    takes a new cross-shard write and passes its scrub."""
    rng = np.random.default_rng(7)
    paths = {name: tmp_path / name for name in CORES}
    dbs = {name: opened(CORES[name], paths[name]) for name in CORES}
    acked = _run_stream(dbs, rng, 100, None, None)
    if how == "crash":
        shard_of = dbs["port"].shard_of
        torn = [(k, _value(rng, 3000)) for k in KEYS[:8]]
        assert len({shard_of(k) for k, _ in torn}) == SHARDS
        for name, sdb in dbs.items():
            _crash_mid_cross_shard_batch(sdb, CORES[name], torn)
            sdb.close(crash=True)
            log = (paths[name] / "ROUTER_LOG").read_bytes()
            recs = [_msgpack.unpackb(p) for p in iter_framed_records(log)]
            assert [r["t"] for r in recs][-1:] == ["i"], f"{name}: the last record is an uncommitted intent"
        acked.update(torn)
    else:
        for sdb in dbs.values():
            sdb.close()
    for reader, writer in (("port", "ref"), ("ref", "port")):
        sdb = opened(CORES[reader], paths[writer])
        assert sdb.stats()["router"]["replayed_batches"] == (1 if how == "crash" else 0)
        assert sdb.multi_get(list(acked)) == list(acked.values()), f"{reader} reading {writer}'s directory"
        assert [k for k, _ in sdb.range()] == sorted(k for k, v in acked.items() if v is not None)
        wb = CORES[reader].WriteBatch()
        for k in KEYS[-6:]:
            wb.put(k + b"after", b"x" * 5000)
        sdb.write(wb)
        sdb.flush()
        assert sdb.multi_get([k + b"after" for k in KEYS[-6:]]) == [b"x" * 5000] * 6
        assert sdb.verify_integrity()["findings"] == []
        sdb.close()


def test_reference_differential_spec_runs_clean_on_the_port_router(monkeypatch):
    """``repro.testing.model_db``'s executable spec at 3 shards, checked after
    every op, with the engine, router and batch swapped for the port's."""
    for name in ("DB", "DBConfig", "ShardedDB", "WriteBatch"):
        monkeypatch.setattr(ref_model_db, name, getattr(port_core, name))
    res = ref_model_db.run_differential(examples=20, seed=5, shards=SHARDS)
    assert res["examples"] == 20 and res["shards"] == SHARDS and res["failures"] == []


@pytest.mark.parametrize("shards", [0, SHARDS])
def test_port_differential_spec_runs_clean(shards):
    """The port's own copy of the spec (``repro_torch.testing.model_db``),
    on one engine and on a 3-shard router."""
    assert port_model_db.ShardedDB is port_core.ShardedDB and port_model_db.DB is port_core.DB
    res = port_model_db.run_differential(examples=20, seed=9, shards=shards)
    assert res["examples"] == 20 and res["shards"] == shards and res["failures"] == []


def test_port_differential_cli_exits_clean(capsys):
    assert port_model_db.main(["--examples", "4", "--shards", "3"]) == 0
    assert "4 examples (shards=3), 0 diverging" in capsys.readouterr().out


def test_router_rejects_a_mismatched_reopen(tmp_path, opened):
    """The ``ROUTER`` written by either package pins the shard count and
    partitioner for the other."""
    opened(ref_core, tmp_path / "r", **PARTITIONERS["range"]).close()
    with pytest.raises(ValueError, match="shard-count mismatch"):
        port_core.ShardedDB.open(str(tmp_path / "r"), shards=4, config=_cfg(port_core))
    with pytest.raises(ValueError, match="no sharded store"):
        port_core.ShardedDB.open(str(tmp_path / "missing"), config=_cfg(port_core))
    sdb = opened(port_core, tmp_path / "r")
    assert sdb.partitioner.name == "range" and sdb.partitioner.boundaries == [b"key013", b"key026"]


@pytest.mark.parametrize("preset", ["paper_exact", "container_scaled"])
@pytest.mark.parametrize("separation_mode,wal_mode", [("wal", "async"), ("wal", "sync"), ("flush", "async"),
                                                      ("none", "off")])
def test_paper_configs_equal_the_reference(preset, separation_mode, wal_mode):
    port = getattr(port_paper, preset)(separation_mode, wal_mode)
    ref = getattr(ref_paper, preset)(separation_mode, wal_mode)
    assert isinstance(port, port_core.DBConfig)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port_paper.KEY_SIZE, port_paper.VALUE_SIZES, port_paper.PAPER_DATASET_BYTES) == (
        ref_paper.KEY_SIZE, ref_paper.VALUE_SIZES, ref_paper.PAPER_DATASET_BYTES)
