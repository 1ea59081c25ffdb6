"""Block-based SSTable (LevelDB-style layout, simplified).

File layout::

    [data block 0] ... [data block N-1] [filter block] [index block] [footer]

* data block — entries sorted by user key:
  ``varint(klen) key varint(seq) type(1B) varint(vlen) value``;
  1-byte compression flag + optional zstd per block.

  **Format v2** appends a restart-point trailer to the (pre-compression)
  block payload: ``[u32 offset x R][u32 R]`` where each offset points at an
  entry boundary, one per ``restart_interval`` entries. Point lookups
  binary-search the restart array (decoding only one key per probe) and
  then decode at most ``restart_interval`` entries — replacing v1's
  full-block linear decode. v2/v3 entries are not prefix-compressed, so
  every entry boundary is self-parseable.

  **Format v4** prefix-compresses keys inside each restart interval
  (LevelDB-style): ``varint(shared) varint(non_shared) key_suffix
  varint(seq) type(1B) varint(vlen) value`` where ``shared`` is the byte
  length of the prefix reused from the PREVIOUS entry's key. Every restart
  entry writes ``shared = 0`` (full key), so restart offsets stay
  self-parseable and the v2 restart binary search works unchanged; only
  the linear walk between restarts becomes stateful (it rebuilds keys from
  the running previous key).
* filter block — :class:`~repro_torch.core.bloom.BloomFilter` over user keys.
* index block — msgpack list of ``(last_key, offset, length[, crc32])``;
  the optional 4th element is the block's crc32, verified on read under
  ``paranoid_checks`` and by the ``DB.verify_integrity`` scrub. Tables
  written before the CRC existed decode fine (entries are 3-wide).
* range-tombstone block (v3) — msgpack list of ``(seq, start, end)``
  range deletes carried by this table (end exclusive), placed between the
  index block and the footer. Empty list when the table has none.
* footer — v1: fixed 40 B ``filter_off, filter_len, index_off, index_len,
  magic``; v2: fixed 48 B with a ``version`` field before a new magic;
  v3/v4: fixed 64 B adding ``range_off, range_len`` before the version
  field (v4 shares the v3 footer layout and magic — the version field
  disambiguates). Readers dispatch on the trailing magic, so v1 tables
  written by older code keep decoding forever (compat rule: readers
  support every version ≤ FORMAT_VERSION; writers emit
  ``DBConfig.sstable_format_version``).

A user key may appear MULTIPLE times within a table (format v3+ / MVCC):
entries are sorted by (user_key asc, seq desc), so the first occurrence of
a key is its newest version — point lookups still resolve on the first hit.
Single-version tables behave exactly as before.

Decoded blocks are wrapped in :class:`Block` objects so a shared
:class:`~repro_torch.core.blockcache.BlockCache` can hold them across reads: the
first access decodes lazily (restart binary search / early-exit scan), and
a block that is hit again — i.e. one that stayed cached — materializes a
parsed entry list + key index once, making every later lookup a dict/bisect
operation instead of byte parsing.
"""
from __future__ import annotations

import bisect
import os
import struct
import zlib
from dataclasses import dataclass

from repro_torch import _msgpack as msgpack

try:  # optional dep: compression degrades to store-uncompressed when absent
    import zstandard

    _ZCTX = zstandard.ZstdCompressor(level=1)
    _DCTX = zstandard.ZstdDecompressor()
except ImportError:  # pragma: no cover - environment-dependent
    zstandard = None
    _ZCTX = None
    _DCTX = None

from .bloom import BloomFilter
from .env import DEFAULT_ENV
from .errors import CorruptionError
from .record import decode_varint, encode_varint

_FOOTER_V1 = struct.Struct("<QQQQQ")
_FOOTER_V2 = struct.Struct("<QQQQQQ")
_FOOTER_V3 = struct.Struct("<QQQQQQQQ")
_MAGIC_V1 = 0xB7_15_3D_CA_FE_10_57_01
_MAGIC_V2 = 0xB7_15_3D_CA_FE_10_57_02
_MAGIC_V3 = 0xB7_15_3D_CA_FE_10_57_03
_U32 = struct.Struct("<I")

#: newest on-disk format this build writes (and the max it can read)
FORMAT_VERSION = 4


def _shared_prefix_len(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


@dataclass(slots=True)
class FileMetadata:
    file_no: int
    size: int
    smallest: bytes
    largest: bytes
    entries: int

    def to_wire(self):
        return [self.file_no, self.size, self.smallest, self.largest, self.entries]

    @staticmethod
    def from_wire(w) -> "FileMetadata":
        return FileMetadata(w[0], w[1], bytes(w[2]), bytes(w[3]), w[4])


def table_path(directory: str, file_no: int) -> str:
    return os.path.join(directory, f"{file_no:06d}.sst")


class SSTableWriter:
    def __init__(
        self,
        path: str,
        block_size: int = 4096,
        compression: bool = False,
        format_version: int = FORMAT_VERSION,
        restart_interval: int = 16,
        env=None,
    ):
        if not 1 <= format_version <= FORMAT_VERSION:
            raise ValueError(f"unsupported sstable format_version {format_version}")
        self.path = path
        self.block_size = block_size
        self.compression = compression
        self.format_version = format_version
        self.restart_interval = max(1, restart_interval)
        self._env = env or DEFAULT_ENV
        self._f = self._env.open(path, "wb")
        self._block: list[bytes] = []
        self._block_bytes = 0
        self._restarts: list[int] = []
        # index entries are (last_key, offset, length, crc32-of-blob); the
        # crc is a 4th element so v2 tables written before it existed (plain
        # 3-element entries) keep decoding — readers accept both widths.
        self._index: list[tuple[bytes, int, int, int]] = []
        self._keys: list[bytes] = []
        self._offset = 0
        self._count = 0
        self._last_seq: int | None = None
        self.smallest: bytes | None = None
        self.largest: bytes | None = None

    def add(self, key: bytes, seq: int, type_: int, value: bytes) -> None:
        # (user_key asc, seq desc): duplicate user keys are multi-version
        # runs and must arrive newest-first
        assert (
            self.largest is None
            or key > self.largest
            or (key == self.largest and seq < self._last_seq)
        ), "keys must be added in (user_key asc, seq desc) order"
        if self.smallest is None:
            self.smallest = key
        dup = key == self.largest
        prev_key = self.largest
        self.largest = key
        self._last_seq = seq
        at_restart = len(self._block) % self.restart_interval == 0
        if at_restart:
            self._restarts.append(self._block_bytes)
        if self.format_version >= 4:
            # prefix-compress against the previous entry IN THIS BLOCK;
            # restart entries always carry the full key (shared = 0) so
            # restart offsets stay self-parseable
            shared = 0
            if not at_restart and self._block:
                shared = _shared_prefix_len(prev_key, key)
            ent = b"".join(
                (
                    encode_varint(shared),
                    encode_varint(len(key) - shared),
                    key[shared:],
                    encode_varint(seq),
                    bytes([type_]),
                    encode_varint(len(value)),
                    value,
                )
            )
        else:
            ent = b"".join(
                (
                    encode_varint(len(key)),
                    key,
                    encode_varint(seq),
                    bytes([type_]),
                    encode_varint(len(value)),
                    value,
                )
            )
        self._block.append(ent)
        self._block_bytes += len(ent)
        if not dup:  # bloom + last-key tracking want distinct user keys
            self._keys.append(key)
        self._count += 1
        if self._block_bytes >= self.block_size:
            self._flush_block(key)

    def _flush_block(self, last_key: bytes) -> None:
        if not self._block:
            return
        raw = b"".join(self._block)
        if self.format_version >= 2:
            raw += b"".join(_U32.pack(o) for o in self._restarts)
            raw += _U32.pack(len(self._restarts))
        if self.compression and _ZCTX is not None:
            comp = _ZCTX.compress(raw)
            blob = b"\x01" + comp if len(comp) < len(raw) else b"\x00" + raw
        else:
            blob = b"\x00" + raw
        self._f.write(blob)
        self._index.append((last_key, self._offset, len(blob), zlib.crc32(blob) & 0xFFFFFFFF))
        self._offset += len(blob)
        self._block = []
        self._block_bytes = 0
        self._restarts = []

    def finish(self, file_no: int, range_tombstones=()) -> FileMetadata:
        """``range_tombstones``: iterable of (seq, start, end) range deletes
        carried by this table (format v3+). The returned metadata's
        smallest/largest are EXTENDED by the tombstone bounds so version
        candidate selection routes covered point reads at this file (the
        exclusive end is used as an inclusive largest — a safe
        over-approximation)."""
        if range_tombstones and self.format_version < 3:
            raise ValueError("range tombstones need sstable format v3+")
        if self._block:
            self._flush_block(self._keys[-1])
        bloom = BloomFilter.build(self._keys).encode()
        filter_off = self._offset
        self._f.write(bloom)
        index = msgpack.packb([[k, o, ln, crc] for k, o, ln, crc in self._index])
        index_off = filter_off + len(bloom)
        self._f.write(index)
        range_off = index_off + len(index)
        range_blob = b""
        if self.format_version >= 3:
            range_blob = msgpack.packb(
                [[s, a, b] for s, a, b in sorted(range_tombstones)]
            )
            self._f.write(range_blob)
        if self.format_version >= 3:
            footer = _FOOTER_V3.pack(
                filter_off, len(bloom), index_off, len(index),
                range_off, len(range_blob), self.format_version, _MAGIC_V3,
            )
        elif self.format_version == 2:
            footer = _FOOTER_V2.pack(
                filter_off, len(bloom), index_off, len(index),
                self.format_version, _MAGIC_V2,
            )
        else:
            footer = _FOOTER_V1.pack(
                filter_off, len(bloom), index_off, len(index), _MAGIC_V1
            )
        self._f.write(footer)
        self._f.flush()
        self._env.fsync(self._f)
        self._f.close()
        size = range_off + len(range_blob) + len(footer)
        smallest, largest = self.smallest, self.largest
        for seq, start, end in range_tombstones:
            if smallest is None or start < smallest:
                smallest = start
            if largest is None or end > largest:
                largest = end
        return FileMetadata(file_no, size, smallest or b"", largest or b"", self._count)

    def abandon(self) -> None:
        self._f.close()
        self._env.unlink(self.path)


def _decompress(blob: bytes) -> bytes:
    if blob[0] == 1:
        if _DCTX is None:
            raise IOError("zstd-compressed block but the zstandard module is unavailable")
        return _DCTX.decompress(blob[1:])
    return blob[1:]


def _parse_entry(raw: bytes, pos: int) -> tuple[bytes, int, int, bytes, int]:
    """Decode one entry at ``pos``; returns (key, seq, type, value, next_pos)."""
    klen, pos = decode_varint(raw, pos)
    key = raw[pos : pos + klen]
    pos += klen
    seq, pos = decode_varint(raw, pos)
    type_ = raw[pos]
    pos += 1
    vlen, pos = decode_varint(raw, pos)
    value = raw[pos : pos + vlen]
    pos += vlen
    return key, seq, type_, value, pos


def _entry_key(raw: bytes, pos: int) -> bytes:
    """Decode only the user key of the entry at ``pos`` (restart probes)."""
    klen, pos = decode_varint(raw, pos)
    return raw[pos : pos + klen]


def _parse_entry_pfx(raw: bytes, pos: int, prev_key: bytes) -> tuple[bytes, int, int, bytes, int]:
    """Decode one prefix-compressed (v4) entry at ``pos``; the key is
    rebuilt from ``prev_key``'s shared prefix + the stored suffix."""
    shared, pos = decode_varint(raw, pos)
    non_shared, pos = decode_varint(raw, pos)
    suffix = raw[pos : pos + non_shared]
    key = prev_key[:shared] + suffix if shared else suffix
    pos += non_shared
    seq, pos = decode_varint(raw, pos)
    type_ = raw[pos]
    pos += 1
    vlen, pos = decode_varint(raw, pos)
    value = raw[pos : pos + vlen]
    pos += vlen
    return key, seq, type_, value, pos


def _restart_key_pfx(raw: bytes, pos: int) -> bytes:
    """Decode only the user key of the v4 entry at a RESTART offset
    (``shared`` is 0 there, so the stored suffix is the whole key)."""
    _shared, pos = decode_varint(raw, pos)
    klen, pos = decode_varint(raw, pos)
    return raw[pos : pos + klen]


class Block:
    """One decoded data block: entry bytes plus (v2) the restart array.

    Access-adaptive decoding: the first :meth:`get` stays lazy — restart
    binary search on v2, early-exit linear scan on v1 — so one-shot reads
    (cache disabled, compaction) never materialize anything. A second
    ``get`` on the same object means the block survived in the cache, so it
    pays one full parse and serves every later lookup from a key→entry dict
    and every iteration from the parsed list.
    """

    __slots__ = (
        "raw", "limit", "restarts", "prefixed", "_gets", "_entries", "_keys", "_kv",
        "_mat_extra", "_cache", "_cache_key",
    )

    def __init__(self, blob: bytes):
        if blob[0] > 1:  # reserved for future block encodings
            raise IOError(f"unknown block encoding {blob[0]}")
        raw = _decompress(blob)
        self.restarts: tuple[int, ...] | None = None
        self.prefixed = False  # v4 prefix-compressed entries
        self.limit = len(raw)
        self.raw = raw
        self._gets = 0
        self._entries: list[tuple[bytes, int, int, bytes]] | None = None
        self._keys: list[bytes] | None = None
        self._kv: dict | None = None
        self._mat_extra = 0  # extra bytes held by the materialized structures
        self._cache = None  # set by BlockCache.put; recharged on materialize
        self._cache_key: tuple[int, int] | None = None

    @classmethod
    def from_blob(cls, blob: bytes, version: int) -> "Block":
        blk = cls(blob)
        if version >= 2:
            raw = blk.raw
            (n_restarts,) = _U32.unpack_from(raw, len(raw) - 4)
            trailer = 4 + 4 * n_restarts
            blk.restarts = struct.unpack_from(f"<{n_restarts}I", raw, len(raw) - trailer)
            blk.limit = len(raw) - trailer
        blk.prefixed = version >= 4
        return blk

    @property
    def charge(self) -> int:
        """Cache accounting: decoded payload bytes + fixed object overhead,
        plus the parsed-structure estimate once the block materializes (the
        cache is re-charged at that point — see ``_materialize``)."""
        return len(self.raw) + 64 + self._mat_extra

    # -- point lookup ---------------------------------------------------
    def get(self, key: bytes):
        """Return (key, seq, type, value) or None."""
        if self._kv is None:
            self._gets += 1
            if self._gets < 2:
                return self._lazy_get(key)
            self._materialize()
        ent = self._kv.get(key)
        return None if ent is None else (key, *ent)

    def _lazy_get(self, key: bytes):
        raw, limit = self.raw, self.limit
        prefixed = self.prefixed
        pos = 0
        if self.restarts:
            # binary search the restart array: find the LAST restart whose
            # key is strictly BELOW the target; only one key is decoded per
            # probe. (``<`` not ``<=``: with multi-version duplicate-key
            # runs a restart can land mid-run, and starting there would
            # return an older version instead of the newest.) Restart
            # entries always store their full key, prefixed or not.
            restart_key = _restart_key_pfx if prefixed else _entry_key
            restarts = self.restarts
            lo, hi = 0, len(restarts) - 1
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if restart_key(raw, restarts[mid]) < key:
                    lo = mid
                else:
                    hi = mid - 1
            pos = restarts[lo]
        if prefixed:
            # in-place key reconstruction: one bytearray mutated per entry
            # (`del buf[shared:]` + append suffix) instead of slice+concat
            # allocations, and values of skipped entries are never sliced —
            # this walk is HOT (every cache-off get) and must not lose to
            # the uncompressed v2 walk it replaces
            buf = bytearray()
            while pos < limit:
                # varints inlined for the one-byte case (shared/non_shared
                # are bounded by the key length, vlen by the block size —
                # almost always < 128): the function-call overhead per
                # entry is what this loop's throughput lives and dies by
                shared = raw[pos]
                if shared < 0x80:
                    pos += 1
                else:
                    shared, pos = decode_varint(raw, pos)
                non_shared = raw[pos]
                if non_shared < 0x80:
                    pos += 1
                else:
                    non_shared, pos = decode_varint(raw, pos)
                del buf[shared:]
                buf += raw[pos : pos + non_shared]
                pos += non_shared
                seq, pos = decode_varint(raw, pos)
                type_ = raw[pos]
                pos += 1
                vlen = raw[pos]
                if vlen < 0x80:
                    pos += 1
                else:
                    vlen, pos = decode_varint(raw, pos)
                if buf == key:
                    return key, seq, type_, raw[pos : pos + vlen]
                if buf > key:
                    return None
                pos += vlen
            return None
        while pos < limit:
            k, seq, type_, value, pos = _parse_entry(raw, pos)
            if k == key:
                return k, seq, type_, value
            if k > key:
                return None
        return None

    def _materialize(self) -> None:
        entries = list(self._scan(0))
        # publication order matters: other threads gate on _kv (get) and
        # _entries (iteration), so every side structure must be complete
        # before EITHER gate field is assigned — _keys first, _kv next,
        # _entries last. Each assignment publishes a fully-built object, so
        # a concurrent reader sees either the lazy path or the fast path,
        # never a half-built one.
        self._keys = [e[0] for e in entries]
        # first occurrence wins: with multi-version runs the first entry for
        # a user key is its NEWEST version (a plain dict comprehension would
        # keep the last = oldest)
        kv: dict = {}
        for e in entries:
            kv.setdefault(e[0], (e[1], e[2], e[3]))
        self._kv = kv
        # parsed copies hold the key/value bytes again plus per-entry
        # object overhead (tuple + dict/list slots)
        self._mat_extra = sum(len(e[0]) * 2 + len(e[3]) for e in entries) + 120 * len(entries)
        self._entries = entries
        cache = self._cache
        if cache is not None:
            cache.recharge(self._cache_key, self)

    # -- iteration ------------------------------------------------------
    def _scan(self, pos: int):
        """Yield entries from ``pos`` to the block end. ``pos`` must be an
        entry boundary — and, for prefixed (v4) blocks, a RESTART boundary
        (mid-interval entries don't carry their full key)."""
        raw, limit = self.raw, self.limit
        if self.prefixed:
            prev = b""
            while pos < limit:
                k, seq, type_, value, pos = _parse_entry_pfx(raw, pos, prev)
                prev = k
                yield k, seq, type_, value
        else:
            while pos < limit:
                k, seq, type_, value, pos = _parse_entry(raw, pos)
                yield k, seq, type_, value

    def __iter__(self):
        if self._entries is not None:
            yield from self._entries
            return
        yield from self._scan(0)

    def iter_from(self, start: bytes):
        if self._entries is not None:
            yield from self._entries[bisect.bisect_left(self._keys, start):]
            return
        pos = 0
        if self.restarts:
            raw = self.raw
            restart_key = _restart_key_pfx if self.prefixed else _entry_key
            restarts = self.restarts
            lo, hi = 0, len(restarts) - 1
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if restart_key(raw, restarts[mid]) < start:
                    lo = mid
                else:
                    hi = mid - 1
            pos = restarts[lo]
        for ent in self._scan(pos):
            if ent[0] >= start:
                yield ent

    def largest_below(self, bound: bytes | None) -> bytes | None:
        """Largest user key strictly below ``bound`` in this block (reverse
        cursor step); ``None`` bound means unbounded (the block's last
        key). Linear within one block — blocks are ~4 KiB."""
        if self._keys is not None:
            if bound is None:
                return self._keys[-1] if self._keys else None
            i = bisect.bisect_left(self._keys, bound)
            return self._keys[i - 1] if i else None
        best = None
        for k, _seq, _type, _value in self:
            if bound is not None and k >= bound:
                break
            best = k
        return best


class SSTableReader:
    """Random + sequential access to one table.

    ``cache`` (a :class:`~repro_torch.core.blockcache.BlockCache`) is shared
    across every reader of a DB; blocks are keyed ``(file_no, block_idx)``.
    ``fill_cache=False`` on the iteration APIs reads through the cache but
    never populates it (compaction bypass — one-shot streams should not
    evict the foreground working set).
    """

    def __init__(self, path: str, file_no: int = 0, cache=None, env=None, paranoid=False):
        self.path = path
        self.file_no = file_no
        self.cache = cache
        self._env = env or DEFAULT_ENV
        self.paranoid = paranoid
        self._f = self._env.open(path, "rb")
        self._f.seek(0, os.SEEK_END)
        file_size = self._f.tell()
        tail = self._env.pread_f(self._f, min(file_size, _FOOTER_V3.size), max(0, file_size - _FOOTER_V3.size))
        (magic,) = struct.unpack_from("<Q", tail, len(tail) - 8)
        range_off = range_len = 0
        if magic == _MAGIC_V1:
            filter_off, filter_len, index_off, index_len, _ = _FOOTER_V1.unpack(
                tail[len(tail) - _FOOTER_V1.size:]
            )
            self.format_version = 1
        elif magic == _MAGIC_V2:
            filter_off, filter_len, index_off, index_len, version, _ = _FOOTER_V2.unpack(
                tail[len(tail) - _FOOTER_V2.size:]
            )
            if version > FORMAT_VERSION:
                raise IOError(
                    f"{path}: sstable format v{version} is newer than this build (v{FORMAT_VERSION})"
                )
            self.format_version = version
        elif magic == _MAGIC_V3:
            (filter_off, filter_len, index_off, index_len,
             range_off, range_len, version, _) = _FOOTER_V3.unpack(tail)
            if version > FORMAT_VERSION:
                raise IOError(
                    f"{path}: sstable format v{version} is newer than this build (v{FORMAT_VERSION})"
                )
            self.format_version = version
        else:
            raise IOError(f"bad SSTable magic in {path}")
        #: (seq, start, end-exclusive) range tombstones, sorted by seq —
        #: empty for v1/v2 tables
        self.range_tombstones: list[tuple[int, bytes, bytes]] = []
        if range_len:
            self.range_tombstones = [
                (e[0], bytes(e[1]), bytes(e[2]))
                for e in msgpack.unpackb(self._env.pread_f(self._f, range_len, range_off))
            ]
        self.bloom = BloomFilter.decode(self._env.pread_f(self._f, filter_len, filter_off))
        # index entries may be 3-wide (pre-CRC tables) or 4-wide (with a
        # per-block crc32). ``self.index`` stays 3-tuples — downstream code
        # (compaction bounds augmentation) unpacks ``k, off, len`` — and the
        # crcs live in a parallel list (None per block when absent).
        raw_index = msgpack.unpackb(self._env.pread_f(self._f, index_len, index_off))
        self.index = [(bytes(e[0]), e[1], e[2]) for e in raw_index]
        self.block_crcs = [e[3] if len(e) > 3 else None for e in raw_index]

    def _read_block(self, idx: int, fill_cache: bool = True, meter=None) -> Block:
        cache = self.cache
        if cache is not None:
            key = (self.file_no, idx)
            # bypass streams peek: no MRU promotion, no hit/miss accounting
            blk = cache.get(key) if fill_cache else cache.peek(key)
            if blk is not None:
                return blk
        _, off, length = self.index[idx]
        if meter is not None:
            # charge the I/O budget for the bytes about to leave the disk —
            # cache hits above never reach here, so only real preads pay
            meter(length)
        # positional read: one reader object is shared by foreground gets
        # and background flush/compaction iterators, and a seek+read pair
        # would interleave offsets between threads (silently decoding the
        # wrong block). pread has no cursor, so it is race-free.
        blob = self._env.pread_f(self._f, length, off)
        if self.paranoid:
            self._check_block(idx, blob, length)
        blk = Block.from_blob(blob, self.format_version)
        if cache is not None and fill_cache:
            cache.put(key, blk)
        return blk

    def _check_block(self, idx: int, blob: bytes, length: int) -> None:
        """CRC-verify one block's raw bytes. A short read is an OSError
        (truncation/unlink race — transient, retryable), never corruption:
        only a full-length blob whose checksum disagrees is corrupt."""
        if len(blob) != length:
            raise IOError(
                f"short SSTable block read in {self.path} "
                f"(block {idx}: got {len(blob)}, want {length})"
            )
        crc = self.block_crcs[idx]
        if crc is not None and (zlib.crc32(blob) & 0xFFFFFFFF) != crc:
            raise CorruptionError(
                f"SSTable block CRC mismatch in {self.path} (block {idx})",
                sst_file_no=self.file_no,
                path=self.path,
            )

    def verify_block(self, idx: int) -> None:
        """Scrub entry point: read block ``idx`` from disk (never the cache),
        CRC-verify it regardless of ``paranoid``, and fully parse it.
        Raises CorruptionError on bad bytes, OSError on short reads."""
        _, off, length = self.index[idx]
        blob = self._env.pread_f(self._f, length, off)
        self._check_block(idx, blob, length)
        try:
            for _ in Block.from_blob(blob, self.format_version):
                pass
        except CorruptionError:
            raise
        except Exception as exc:
            # undecodable despite a matching (or absent) CRC — pre-CRC
            # tables land here when their bytes are damaged
            raise CorruptionError(
                f"SSTable block {idx} in {self.path} failed to parse: {exc}",
                sst_file_no=self.file_no,
                path=self.path,
            ) from exc

    def _seek_block(self, key: bytes) -> int:
        """Index of the first block whose last_key >= key (or len(index))."""
        index = self.index
        lo, hi = 0, len(index) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if index[mid][0] < key:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def get(self, key: bytes):
        """Returns (found, seq, type, value) — the newest version of key."""
        if not self.bloom.may_contain(key):
            return False, 0, 0, b""
        lo = self._seek_block(key)
        if lo >= len(self.index) or self.index[lo][0] < key:
            return False, 0, 0, b""
        ent = self._read_block(lo).get(key)
        if ent is None:
            return False, 0, 0, b""
        return True, ent[1], ent[2], ent[3]

    def get_at(self, key: bytes, read_seq: int):
        """Snapshot point read: newest version of ``key`` with
        ``seq <= read_seq`` — walks the key's (possibly block-spanning)
        multi-version run. Returns (found, seq, type, value)."""
        if not self.bloom.may_contain(key):
            return False, 0, 0, b""
        return self._get_at_nobloom(key, read_seq)

    def _get_at_nobloom(self, key: bytes, read_seq: int):
        for k, seq, type_, value in self.iter_from(key):
            if k != key:
                break
            if seq <= read_seq:
                return True, seq, type_, value
        return False, 0, 0, b""

    def get_many(self, keys, read_seq: int | None = None) -> dict:
        """Batch point lookup: all ``keys`` against this table in one pass.

        Returns ``{key: (seq, type, value)}`` for the keys present (newest
        version, or newest with ``seq <= read_seq`` when given). The whole
        batch is bloom-probed in ONE vectorized call, survivors are grouped
        by data block, and each block is fetched/decoded once no matter how
        many keys land in it.
        """
        out: dict = {}
        index = self.index
        if not index or not keys:
            return out
        mask = self.bloom.may_contain_many(keys)
        n_blocks = len(index)
        by_block: dict[int, list[bytes]] = {}
        for key, maybe in zip(keys, mask):
            if not maybe:
                continue
            b = self._seek_block(key)
            if b >= n_blocks or index[b][0] < key:
                continue
            by_block.setdefault(b, []).append(key)
        if read_seq is None:
            for b, ks in by_block.items():
                blk = self._read_block(b)
                for key in ks:
                    ent = blk.get(key)
                    if ent is not None:
                        out[key] = (ent[1], ent[2], ent[3])
        else:
            # snapshot reads walk multi-version runs that may span blocks;
            # bloom negatives are already gone and block fetches still
            # coalesce through the cache
            for ks in by_block.values():
                for key in ks:
                    found, seq, type_, value = self._get_at_nobloom(key, read_seq)
                    if found:
                        out[key] = (seq, type_, value)
        return out

    def max_tombstone_seq(self, key: bytes, read_seq: int) -> int:
        """Max seq of a range tombstone in THIS table covering ``key`` and
        visible at ``read_seq`` (0 if none)."""
        best = 0
        for seq, start, end in self.range_tombstones:
            if seq <= read_seq and start <= key < end and seq > best:
                best = seq
        return best

    def largest_key_below(self, bound: bytes | None) -> bytes | None:
        """Largest user key strictly below ``bound`` (reverse cursor);
        ``None`` bound means unbounded (the table's last point key)."""
        if not self.index:
            return None
        if bound is None:
            idx = len(self.index) - 1
        else:
            idx = min(self._seek_block(bound), len(self.index) - 1)
        while idx >= 0:
            best = self._read_block(idx).largest_below(bound)
            if best is not None:
                return best
            idx -= 1  # at most one extra hop: block idx-1's last_key < bound
        return None

    def __iter__(self):
        yield from self.iter_all()

    def iter_all(self, fill_cache: bool = True, meter=None):
        for i in range(len(self.index)):
            yield from self._read_block(i, fill_cache, meter)

    def iter_from(self, start: bytes, fill_cache: bool = True, meter=None):
        lo = self._seek_block(start)
        if lo < len(self.index):
            yield from self._read_block(lo, fill_cache, meter).iter_from(start)
        for i in range(lo + 1, len(self.index)):
            yield from self._read_block(i, fill_cache, meter)

    def close(self) -> None:
        self._f.close()
