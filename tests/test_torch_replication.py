"""The port's replication (``repro_torch.core.replication``) against the
reference's (``repro.core.replication``) on the CPU: the reference's
failover harness on the port's engine (every name it builds with swapped,
the torn-promote scenario's ``Follower`` too), the port's own copy of the
harness giving the reference's result per seed in both WAL modes, two
primaries (one per package) in lockstep shipping byte-equal frames to their
replicas, and the port's codec on those frames cut short or with a bit
flipped: it raises, or reads what ``msgpack`` reads."""
import contextlib
import io

import msgpack
import numpy as np
import pytest

import repro.core as ref_core
import repro.core.replication as ref_replication
import repro.testing.failover_harness as ref_failover
import repro_torch.core as port_core
import repro_torch.core.replication as port_replication
import repro_torch.testing.failover_harness as port_failover
from repro_torch import _msgpack
from repro_torch.core.record import iter_framed_records

CORES = {"ref": (ref_core, ref_replication), "port": (port_core, port_replication)}
# Seeds 0–7 hold every scenario: crash_replica (0), crash_primary (1, 3),
# converge (2), diverge (5, 6) and crash_promote (7). Seed 4 is left out: its
# async iteration's ``flush`` waits out the engine's 120 s ``wait_idle``
# limit after the simulated crash, in the reference as in the port.
SEEDS = (0, 1, 2, 3, 5, 6, 7)
MODES = ("sync", "async")


def _results(harness, tmp_path):
    out = {}
    for seed in SEEDS:
        for mode in MODES:
            # worker-thread tracebacks from the simulated crashes are expected
            with contextlib.redirect_stderr(io.StringIO()):
                res = harness.run_iteration(seed, mode, str(tmp_path))
            out[seed, mode] = {k: res[k] for k in ("scenario", "acked", "violations")}
    return out


@pytest.fixture(scope="module")
def reference_results(tmp_path_factory):
    """The reference's harness on the reference's engine."""
    res = _results(ref_failover, tmp_path_factory.mktemp("ref_failover"))
    assert {r["scenario"] for r in res.values()} == set(ref_failover.SCENARIOS)
    return res


def test_reference_failover_harness_on_the_port_engine(monkeypatch, tmp_path, reference_results):
    """``repro.testing.failover_harness.run_iteration`` with ``DB``,
    ``DBConfig``, ``FaultInjectionEnv``, ``attach``, ``bootstrap_replica``
    and the ``Follower`` that its torn-promote scenario imports from
    ``repro.core.replication`` all taken from the port: no violation, and
    per seed the scenario and acknowledged count of the reference's run."""
    for name in ("DB", "DBConfig", "FaultInjectionEnv"):
        monkeypatch.setattr(ref_failover, name, getattr(port_core, name))
    for name in ("attach", "bootstrap_replica"):
        monkeypatch.setattr(ref_failover, name, getattr(port_replication, name))
    monkeypatch.setattr(ref_replication, "Follower", port_replication.Follower)
    built = []
    real_init = port_replication.Follower.__init__

    def counting_init(self, db, *a, **kw):
        assert isinstance(db, port_core.DB)
        built.append(type(self))
        real_init(self, db, *a, **kw)

    monkeypatch.setattr(port_replication.Follower, "__init__", counting_init)
    assert _results(ref_failover, tmp_path) == reference_results
    # attach() builds one per iteration; the torn-promote scenario one more
    assert len(built) > len(SEEDS) * len(MODES)


def test_port_failover_harness_gives_the_reference_results(tmp_path, reference_results):
    """``repro_torch.testing.failover_harness`` (the port's copy, on the
    port's engine): per seed and WAL mode, the scenario, the acknowledged
    count and no violation, as the reference's harness on its engine."""
    assert port_failover.DB is port_core.DB and port_failover.attach is port_core.attach
    got = _results(port_failover, tmp_path)
    assert got == reference_results
    assert all(r["violations"] == [] for r in got.values())


def test_port_failover_cli_exits_clean(capsys):
    assert port_failover.main(["--iters", "4", "--seed", "2"]) == 0
    assert "0 failing" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the stream, byte for byte
# ---------------------------------------------------------------------------

THRESHOLD = 1024
SIZES = (16, 200, THRESHOLD - 1, THRESHOLD + 1, 5000, 70_000)


def _cfg(core):
    """A small CRC run, so that digests ride the frames, and frames cut at
    4 KiB of payload."""
    cfg = core.DBConfig.bvlsm(value_threshold=THRESHOLD, memtable_size=4 << 20, num_bvalue_queues=2,
                              l0_compaction_trigger=3, max_subcompactions=1)
    cfg.repl_crc_interval = 8
    cfg.repl_batch_bytes = 4 << 10
    return cfg


def _recording(repl, primary, wires):
    class Recording(repl.InProcessTransport):
        def send(self, wire):
            wires.append(bytes(wire))
            super().send(wire)

    return Recording(primary.env, "repl://lockstep")


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    """One seeded stream through a reference primary and a port primary,
    each with a replica bootstrapped from it and attached through a
    transport that records every frame; both replicas then promoted after
    their primaries crash. Returns {package: (frames, primary reads,
    replica reads, status before the promote, promoted reads)}."""
    root = tmp_path_factory.mktemp("lockstep")
    rng = np.random.default_rng(5)
    keys = [f"key{i:03d}".encode() for i in range(30)]
    ops = []
    for _ in range(220):
        r = rng.random()
        k = keys[rng.integers(len(keys))]
        if r < 0.7:
            ops.append(("put", k, rng.integers(0, 256, SIZES[rng.integers(len(SIZES))], dtype=np.uint8).tobytes()))
        elif r < 0.8:
            ops.append(("delete", k, None))
        elif r < 0.86:
            a, b = sorted(keys[j] for j in rng.choice(len(keys), 2, replace=False))
            ops.append(("delete_range", a, b))
        elif r < 0.96:
            ops.append(("batch", [(keys[j], bytes([j]) * int(rng.integers(1, 3000)))
                                  for j in rng.integers(0, len(keys), 4)], None))
        else:
            ops.append(("flush", None, None))
    out = {}
    for name, (core, repl) in CORES.items():
        primary = core.DB.open(str(root / f"{name}_p"), _cfg(core))
        for op, a, b in ops[:40]:  # before the bootstrap: in the image, not the stream
            if op == "put":
                primary.put(a, b)
        replica = repl.bootstrap_replica(primary, str(root / f"{name}_r"), cfg=_cfg(core))
        wires = []
        link = repl.attach(primary, replica, transport=_recording(repl, primary, wires))
        for op, a, b in ops[40:]:
            if op == "put":
                primary.put(a, b)
            elif op == "delete":
                primary.delete(a)
            elif op == "delete_range":
                primary.delete_range(a, b)
            elif op == "batch":
                wb = core.WriteBatch()
                for k, v in a:
                    wb.put(k, v)
                primary.write(wb)
            else:
                primary.flush()
        assert link.wait_caught_up(timeout=30)
        reads = list(primary.range())
        replica_reads = list(replica.range())
        stats = primary.stats()
        primary.close(crash=True)
        status = replica.replication_status()
        replica.promote()
        replica.put(b"after", b"y" * 5000)
        promoted = list(replica.range())
        assert replica.verify_integrity()["findings"] == []
        replica.close()
        out[name] = (wires, reads, replica_reads, status, promoted, stats)
    return out


def test_lockstep_primaries_ship_byte_equal_frames(lockstep):
    """The two primaries frame the same groups into the same bytes (the
    ``(seq, payload)`` tuples as MessagePack arrays, the CRC digests beside
    them); each replica caught up with lag 0 reads what its primary reads,
    and, promoted after its primary's crash, reads the same as the other."""
    (ref_wires, ref_reads, ref_replica, ref_status, ref_promoted, ref_stats) = lockstep["ref"]
    (wires, reads, replica, status, promoted, stats) = lockstep["port"]
    assert len(wires) > 100 and wires == ref_wires
    assert reads == ref_reads == replica == ref_replica
    assert promoted == ref_promoted and (b"after", b"y" * 5000) in promoted
    assert status["role"] == "replica" and status["lag"] == 0 and not status["diverged"]
    assert {k: v for k, v in status.items()} == ref_status
    assert stats["repl_bytes_shipped"] == ref_stats["repl_bytes_shipped"] == sum(map(len, wires))
    msgs = [_msgpack.unpackb(next(iter_framed_records(w))) for w in wires]
    assert any(m["c"] for m in msgs) and max(len(m["b"]) for m in msgs) >= 1


def _ingest_parse(unpackb, payload):
    """What ``Follower._ingest`` takes out of a frame's payload."""
    msg = unpackb(payload)
    return [(int(s), bytes(p)) for s, p in msg["b"]], [(int(r), int(c)) for r, c in msg.get("c", ())]


def _theirs(payload):
    return _ingest_parse(lambda raw: msgpack.unpackb(raw, raw=False, strict_map_key=False), payload)


def test_codec_raises_on_cut_or_flipped_frames(lockstep):
    """Every payload of the stream cut short anywhere makes the codec raise
    (``_ingest`` counts such a frame corrupt); with any one bit flipped the
    codec raises or reads what ``msgpack`` reads, never another object."""
    wires = lockstep["port"][0]
    payloads = [next(iter_framed_records(w)) for w in wires]
    picked = [p for p in payloads if _msgpack.unpackb(p)["c"]][:2] + sorted(payloads, key=len)[:2] + payloads[-2:]
    raised = agreed = 0
    for payload in picked:
        assert _ingest_parse(_msgpack.unpackb, payload) == _theirs(payload)
        for cut in range(len(payload)):
            with pytest.raises(Exception):
                _msgpack.unpackb(payload[:cut])
        for pos in range(len(payload)):
            for bit in range(8):
                flipped = bytearray(payload)
                flipped[pos] ^= 1 << bit
                flipped = bytes(flipped)
                try:
                    ours = _ingest_parse(_msgpack.unpackb, flipped)
                except Exception:
                    raised += 1
                    continue
                assert ours == _theirs(flipped), (pos, bit)
                agreed += 1
    assert raised > 0 and agreed > 0


# ---------------------------------------------------------------------------
# value before pointer on the replica
# ---------------------------------------------------------------------------


def test_follower_applies_no_pointer_before_its_value(tmp_path):
    """A value fetch that misses (an async primary's value writer not yet on
    disk, here a read fault on the replica's machine) stops the streaming
    apply before that group: the replica's sequence, its reads and its own
    WAL stay short of the pointer and of every group after it. A crash of
    the replica there loses nothing it must keep; reopened and re-attached
    once the fetch works again, it reads what the primary reads."""
    renv = port_core.FaultInjectionEnv(seed=1)
    rcfg = _cfg(port_core)
    rcfg.env = renv
    primary = port_core.DB.open(str(tmp_path / "p"), _cfg(port_core))
    primary.put(b"small", b"x")
    replica = port_replication.bootstrap_replica(primary, str(tmp_path / "r"), cfg=rcfg)
    link = port_replication.attach(primary, replica)
    primary.put(b"inline", b"y")
    assert link.wait_caught_up(timeout=30)
    held = replica._seq
    renv.add_fault("read", path_substr=str(tmp_path / "p" / "bvalue"), count=None)
    primary.put(b"big", b"v" * 5000)
    primary.put(b"after", b"z")
    assert not link.wait_caught_up(timeout=0.5)
    assert replica._seq == held and replica.get(b"big") is None and replica.get(b"after") is None
    assert replica.stats()["repl_value_fetch_misses"] > 0

    link.detach()
    with contextlib.redirect_stderr(io.StringIO()):
        replica.close(crash=True)
    renv.drop_unsynced()
    renv.reset()
    replica = port_core.DB(str(tmp_path / "r"), rcfg, role="replica")
    assert replica._seq == held and replica.get(b"big") is None
    link = port_replication.attach(primary, replica)
    assert link.wait_caught_up(timeout=30)
    assert list(replica.range()) == list(primary.range())
    assert replica.get(b"big") == b"v" * 5000 and replica.get(b"after") == b"z"
    replica.close()
    primary.close()
