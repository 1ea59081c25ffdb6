"""BVLSM core — the paper's contribution: an LSM-tree KV store with WAL-time
key-value separation, multi-queue BValue store, and BVCache.

The port's own copy of the reference engine (``src/repro/core``): the same
behaviour, ``DBConfig`` fields and on-disk formats (WAL, BValue files,
SSTables v1–v4, MANIFEST, checkpoints), so a directory written by either
engine opens in the other. MessagePack goes through the port's codec
(:mod:`repro_torch._msgpack`), since the machine with the card has no
``msgpack``. ``ShardedDB`` and replication are not part of it yet.

``DBConfig.separation_mode`` selects the three systems the paper compares:
``"none"`` (RocksDB baseline), ``"flush"`` (BlobDB/WiscKey), ``"wal"``
(BVLSM).

Failure handling (see :mod:`.errors` / :mod:`.env`): every filesystem call
routes through a pluggable ``Env`` (``DBConfig.env``), background errors are
severity-classified (transient → bounded retry, hard → read-only mode until
``DB.resume()``, corruption → file quarantine), and ``FaultInjectionEnv``
drives the crash/fault test matrix.
"""
from .api import KVStore
from .config import DBConfig
from .db import DB, Cursor, Snapshot
from .env import DEFAULT_ENV, Env, FaultInjectionEnv, FaultRule
from .errors import (
    BackgroundError,
    CorruptionError,
    DBError,
    DBReadOnlyError,
    ReplicaDivergedError,
    SimulatedCrashError,
    SnapshotUnstableError,
)
from .record import ValueOffset
from .writebatch import WriteBatch

__all__ = [
    "DB",
    "KVStore",
    "Snapshot",
    "Cursor",
    "DBConfig",
    "ValueOffset",
    "WriteBatch",
    "Env",
    "FaultInjectionEnv",
    "FaultRule",
    "DEFAULT_ENV",
    "DBError",
    "DBReadOnlyError",
    "BackgroundError",
    "SnapshotUnstableError",
    "CorruptionError",
    "SimulatedCrashError",
    "ReplicaDivergedError",
]
