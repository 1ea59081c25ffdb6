"""WriteBatch — atomic multi-op writes, the unit of group commit.

A batch collects ``put``/``delete`` operations and commits them atomically
via :meth:`DB.write`: all entries share one sequence number and are encoded
into a single CRC-framed WAL record, so crash replay recovers the whole
batch or none of it (RocksDB WriteBatch semantics, minus column families).

``DB.put``/``DB.delete`` are single-entry batches under the hood; the write
pipeline's leader merges many batches from concurrent writers into one WAL
write + fsync (see :mod:`.db`).
"""
from __future__ import annotations

from .record import kTypeDeletion, kTypeRangeDeletion, kTypeValue


class WriteBatch:
    """An ordered list of ops committed atomically by :meth:`DB.write`.

    Ops apply in insertion order, so a later ``put``/``delete`` of the same
    key wins within the batch. Chainable: ``put``/``delete`` return
    ``self`` for chaining. A batch is reusable after ``clear()``.
    """

    __slots__ = ("_ops", "_nbytes")

    def __init__(self) -> None:
        self._ops: list[tuple[int, bytes, bytes]] = []
        self._nbytes = 0

    def put(self, key: bytes, value: bytes) -> "WriteBatch":
        """Queue ``key -> value`` (separation decided at commit time)."""
        self._ops.append((kTypeValue, key, value))
        self._nbytes += len(key) + len(value)
        return self

    def delete(self, key: bytes) -> "WriteBatch":
        """Queue a tombstone for ``key``."""
        self._ops.append((kTypeDeletion, key, b""))
        self._nbytes += len(key)
        return self

    def delete_range(self, start: bytes, end: bytes) -> "WriteBatch":
        """Queue a range tombstone deleting every key in ``[start, end)``.
        Rides the WAL as a normal entry (key=start, value=end)."""
        if not start < end:
            raise ValueError("delete_range needs start < end")
        self._ops.append((kTypeRangeDeletion, start, end))
        self._nbytes += len(start) + len(end)
        return self

    @classmethod
    def from_entries(
        cls, entries: list[tuple[int, bytes, bytes]]
    ) -> "WriteBatch":
        """Rebuild a batch from decoded ``(type, key, value)`` entries —
        the shape WAL replay and replication apply produce."""
        batch = cls()
        for type_, key, value in entries:
            batch._ops.append((type_, key, value))
            batch._nbytes += len(key) + len(value)
        return batch

    def __iter__(self):
        """Yield ``(type, key, value)`` ops in insertion order."""
        return iter(self._ops)

    def clear(self) -> None:
        """Drop all queued ops, making the batch reusable."""
        self._ops.clear()
        self._nbytes = 0

    def __len__(self) -> int:
        return len(self._ops)

    @property
    def size_bytes(self) -> int:
        """Approximate user payload bytes in this batch."""
        return self._nbytes
