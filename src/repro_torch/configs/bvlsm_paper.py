"""The paper's own experimental configurations (Table I / §IV-A), scaled
for a small machine, plus the exact-paper preset for real hardware.

Paper setup: 128 MiB MemTable, 1 immutable (+5 mutable pool), 16 B keys,
values 4–64 KiB, 100 GB datasets, NVMe SSD (Samsung 990 EVO), RocksDB
v9.7.3 baselines.
"""
from __future__ import annotations

from repro_torch.core import DBConfig

KEY_SIZE = 16
VALUE_SIZES = [4096, 8192, 16384, 32768, 65536]
PAPER_DATASET_BYTES = 100 << 30  # 100 GB (scaled down by benchmarks/--mb)


def paper_exact(separation_mode: str = "wal", wal_mode: str = "async") -> DBConfig:
    """The paper's Table I configuration (needs NVMe-class storage)."""
    return DBConfig(
        separation_mode=separation_mode,
        wal_mode=wal_mode,
        value_threshold=4096,
        memtable_size=128 << 20,
        max_immutables=1,
        num_bvalue_queues=4,
        bvcache_bytes=128 << 20,  # §III-D: capacity equal to the MemTable
        bvalue_page_size=4096,
    )


def container_scaled(separation_mode: str = "wal", wal_mode: str = "async") -> DBConfig:
    """Same shape, scaled to a one-core machine."""
    return DBConfig(
        separation_mode=separation_mode,
        wal_mode=wal_mode,
        value_threshold=4096,
        memtable_size=8 << 20,
        max_immutables=2,
        num_bvalue_queues=4,
        bvcache_bytes=8 << 20,
        level1_max_bytes=32 << 20,
    )
