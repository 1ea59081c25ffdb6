"""KVStore — the one client-facing protocol every store implements.

Both :class:`~repro_torch.core.db.DB` (one engine) and
:class:`~repro_torch.core.sharded.ShardedDB` (N engines behind a router)
satisfy this surface, so everything above the engine — the checkpoint
store, the serving stack, benchmarks, the differential harness — is
written against ``KVStore`` and runs unchanged on either. The protocol
is ``runtime_checkable`` for the conformance test
(``tests/test_api.py``), which parameterizes every behavioural check
over both implementations.

Opaque associated types: ``snapshot()`` returns *some* pinned read
point accepted back by ``get``/``multi_get``/``iterator``/``range`` of
the same store (``Snapshot`` for ``DB``, ``ShardedSnapshot`` for
``ShardedDB``) and released via ``.release()`` / ``with``; likewise
``iterator()`` returns a seek/next/prev cursor (``Cursor`` or
``MergedCursor``). The protocol deliberately types them as ``Any`` —
cross-store mixing is a programming error, not something the type
system promises to catch.

``scan(start, count)`` is NOT part of the protocol: it is deprecated
(both stores keep a ``DeprecationWarning`` shim) in favour of
``range(start, end=None, limit=None)``.
"""
from __future__ import annotations

from typing import Any, Iterator, Protocol, runtime_checkable


@runtime_checkable
class KVStore(Protocol):
    """Client surface shared by ``DB`` and ``ShardedDB``.

    The canonical way to obtain one is the ``open()`` classmethod on the
    concrete class (``DB.open(path, config=None)`` /
    ``ShardedDB.open(path, shards=N, config=None)``).
    """

    def put(self, key: bytes, value: bytes) -> None:
        """Durably (per ``wal_mode``) write ``key -> value``."""
        ...

    def get(self, key: bytes, snapshot: Any | None = None) -> bytes | None:
        """Point lookup at latest, or at a pinned ``snapshot``."""
        ...

    def multi_get(self, keys, snapshot: Any | None = None) -> list[bytes | None]:
        """Batched point lookup; result aligned with ``keys``."""
        ...

    def delete(self, key: bytes) -> None:
        """Tombstone ``key``."""
        ...

    def delete_range(self, start: bytes, end: bytes) -> None:
        """Range-tombstone every key in ``[start, end)``."""
        ...

    def write(self, batch: Any) -> None:
        """Apply a ``WriteBatch`` atomically (see the implementation's
        documented cross-shard semantics for ``ShardedDB``)."""
        ...

    def range(
        self,
        start: bytes = b"",
        end: bytes | None = None,
        limit: int | None = None,
        snapshot: Any | None = None,
    ) -> Iterator[tuple[bytes, bytes]]:
        """Stream live ``(key, value)`` pairs with ``start <= key``
        (``< end`` when given), ascending, up to ``limit``."""
        ...

    def iterator(self, snapshot: Any | None = None) -> Any:
        """A seek/next/prev cursor over a stable read point."""
        ...

    def snapshot(self) -> Any:
        """Pin the current read point; release via ``.release()``."""
        ...

    def checkpoint(self, directory: str) -> None:
        """Materialize a consistent, openable copy in ``directory``."""
        ...

    def stats(self) -> dict:
        """One consistent dict of engine counters/gauges."""
        ...

    def flush(self) -> None:
        """Synchronous durability barrier."""
        ...

    def close(self) -> None:
        """Release every resource; the store is unusable afterwards."""
        ...
