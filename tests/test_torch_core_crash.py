"""The reference's crash harness (``repro.testing.crash_harness``) against
the port's engine: each iteration builds a small DB on a
``FaultInjectionEnv``, kills it at a random filesystem call, drops every
unsynced byte, recovers, and checks the durability contract (sync WAL:
every acknowledged write reads back; async WAL: every key holds a state it
once held) and that every acknowledged checkpoint opens."""
import contextlib
import io

import pytest

import repro.testing.crash_harness as crash_harness
import repro_torch.core as port_core

SEEDS = range(30)


@pytest.mark.parametrize("wal_mode", ["sync", "async"])
def test_reference_crash_harness_on_the_port_engine(monkeypatch, tmp_path, wal_mode):
    monkeypatch.setattr(crash_harness, "DB", port_core.DB)
    monkeypatch.setattr(crash_harness, "DBConfig", port_core.DBConfig)
    monkeypatch.setattr(crash_harness, "FaultInjectionEnv", port_core.FaultInjectionEnv)
    results = []
    for seed in SEEDS:
        # worker-thread tracebacks from the simulated crashes are expected
        with contextlib.redirect_stderr(io.StringIO()):
            results.append(crash_harness.run_iteration(seed, wal_mode, str(tmp_path)))
    assert [(r["seed"], r["violations"]) for r in results if r["violations"]] == []
    assert sum(r["crashed_mid_workload"] for r in results) > 0
    assert sum(r["checkpoints"] for r in results) > 0
