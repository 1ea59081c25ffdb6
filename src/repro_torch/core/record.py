"""Record encodings shared by the WAL, MemTable, SSTables and BValue files.

Layout decisions follow LevelDB/RocksDB conventions where that keeps the
engine honest as a baseline:

* varint32/64 length prefixes,
* internal keys = ``user_key . seq(7B big-endian) . type(1B)`` so that a
  plain bytewise sort orders by (user_key asc, seq desc),
* CRC-framed log records so torn tails are detected on replay.

Value kinds:

* ``kTypeValue``      — inline value (RocksDB baseline path, and small values)
* ``kTypeDeletion``   — tombstone
* ``kTypeValuePtr``   — BVLSM/BlobDB pointer: payload is an encoded
                        :class:`ValueOffset` instead of the value bytes.
* ``kTypeRangeDeletion`` — range tombstone: key is the *start* (inclusive)
                        and the value payload is the *end* (exclusive) user
                        key. Rides the existing WAL entry encoding unchanged;
                        SSTables store these in a dedicated side block.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

kTypeDeletion = 0x0
kTypeValue = 0x1
kTypeValuePtr = 0x2
kTypeRangeDeletion = 0x3

MAX_SEQ = (1 << 56) - 1


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

def encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


# ---------------------------------------------------------------------------
# internal keys
# ---------------------------------------------------------------------------

def pack_internal_key(user_key: bytes, seq: int, type_: int) -> bytes:
    # seq is stored inverted so that bytewise ascending order gives seq DESC
    # (newest first) within the same user key.
    inv = MAX_SEQ - seq
    return user_key + inv.to_bytes(7, "big") + bytes([type_])


def unpack_internal_key(ikey: bytes) -> tuple[bytes, int, int]:
    user_key = ikey[:-8]
    inv = int.from_bytes(ikey[-8:-1], "big")
    return user_key, MAX_SEQ - inv, ikey[-1]


# ---------------------------------------------------------------------------
# ValueOffset — the paper's Key-ValueOffset metadata
# ---------------------------------------------------------------------------

_VOFF = struct.Struct("<IQII")  # file_id, offset, size, crc32(value)


@dataclass(frozen=True, slots=True)
class ValueOffset:
    """Location of a separated big value inside a BValue file."""

    file_id: int
    offset: int
    size: int
    crc: int = 0

    def encode(self) -> bytes:
        return _VOFF.pack(self.file_id, self.offset, self.size, self.crc)

    @staticmethod
    def decode(buf: bytes) -> "ValueOffset":
        f, o, s, c = _VOFF.unpack(buf[: _VOFF.size])
        return ValueOffset(f, o, s, c)


VOFF_SIZE = _VOFF.size


# ---------------------------------------------------------------------------
# WAL record framing:  [crc32 u32][len u32][payload]
#   payload = seq(varint) count(varint) then per-entry:
#     type(1B) klen(varint) key vlen(varint) value_or_voff
# ---------------------------------------------------------------------------

_HDR = struct.Struct("<II")
WAL_HEADER_SIZE = _HDR.size


def frame_record(payload: bytes) -> bytes:
    return _HDR.pack(zlib.crc32(payload) & 0xFFFFFFFF, len(payload)) + payload


def frame_records(payloads) -> bytes:
    """Frame many payloads into one contiguous blob (group commit: the WAL
    writer issues a single write+fsync for the whole group, but each payload
    keeps its own CRC frame so replay-atomicity stays per-batch)."""
    return b"".join(frame_record(p) for p in payloads)


def encode_entries(seq: int, entries: list[tuple[int, bytes, bytes]]) -> bytes:
    """entries: list of (type, key, value_bytes_or_encoded_voff)."""
    parts = [encode_varint(seq), encode_varint(len(entries))]
    for type_, key, val in entries:
        parts.append(bytes([type_]))
        parts.append(encode_varint(len(key)))
        parts.append(key)
        parts.append(encode_varint(len(val)))
        parts.append(val)
    return b"".join(parts)


def decode_entries(payload: bytes) -> tuple[int, list[tuple[int, bytes, bytes]]]:
    seq, pos = decode_varint(payload, 0)
    count, pos = decode_varint(payload, pos)
    out = []
    for _ in range(count):
        type_ = payload[pos]
        pos += 1
        klen, pos = decode_varint(payload, pos)
        key = payload[pos : pos + klen]
        pos += klen
        vlen, pos = decode_varint(payload, pos)
        val = payload[pos : pos + vlen]
        pos += vlen
        out.append((type_, key, val))
    return seq, out


def iter_framed_records(buf: bytes):
    """Yield payloads from a CRC-framed log; stop at the first corrupt/torn
    record (standard WAL tail-truncation semantics)."""
    for payload, _end in iter_framed_records_ex(buf):
        yield payload


def iter_framed_records_ex(buf: bytes):
    """Like :func:`iter_framed_records` but yields ``(payload, end_offset)``
    where ``end_offset`` is the byte position just past the record's frame —
    recovery uses the last good offset to truncate a torn tail in place."""
    pos = 0
    n = len(buf)
    while pos + WAL_HEADER_SIZE <= n:
        crc, length = _HDR.unpack_from(buf, pos)
        body_start = pos + WAL_HEADER_SIZE
        if body_start + length > n:
            return  # torn tail
        payload = buf[body_start : body_start + length]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            return  # corrupt record — stop replay here
        pos = body_start + length
        yield payload, pos
