"""Bloom filter for SSTable key lookups (Kirsch–Mitzenmacher double hashing),
matching LevelDB's ~10 bits/key default. Serialized form:
``[k u8][nbits u32][bitmap bytes]``.

New filters round ``nbits`` up to a power of two so every probe reduces
with a bitmask instead of a ``%`` division (the probe loop is the hottest
pure-Python code on a bloom-negative get). The serialized form is
self-describing — ``nbits`` rides in the header — so filters encoded by
older builds (arbitrary ``nbits``) still decode; probes fall back to ``%``
only for those legacy non-power-of-two sizes.

Batched probes: :meth:`may_contain_many` answers N keys with ONE numpy
masked gather instead of N Python probe loops. The bitmap is lazily viewed
as a ``uint8`` ndarray (zero-copy over the same buffer scalar probes use),
the per-key (h1, h2) pairs expand into an (N, k) bit-index matrix, and a
single vectorized ``bits[idx >> 3] >> (idx & 7)`` gather reduces with
``.all(axis=1)``. This is the multi-get hot path: per level, every
still-unresolved key is probed against a candidate table in one call.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _hash2(key: bytes) -> tuple[int, int]:
    h1 = zlib.crc32(key) & 0xFFFFFFFF
    h2 = zlib.adler32(key) & 0xFFFFFFFF
    # adler32 is weak for short keys; mix.
    h2 = (h2 * 0x9E3779B1 + 0x7F4A7C15) & 0xFFFFFFFF
    return h1, h2 | 1


class BloomFilter:
    __slots__ = ("k", "nbits", "bits", "_mask", "_np_bits")

    def __init__(self, k: int, nbits: int, bits: bytearray):
        self.k = k
        self.nbits = nbits
        self.bits = bits
        # power-of-two sizes (every filter built by this code) probe with a
        # mask; legacy arbitrary sizes keep the modulo path
        self._mask = nbits - 1 if nbits & (nbits - 1) == 0 else None
        self._np_bits: np.ndarray | None = None  # lazy batch-probe view

    @classmethod
    def build(cls, keys: list[bytes], bits_per_key: int = 10) -> "BloomFilter":
        n = max(1, len(keys))
        nbits = 1 << (max(64, n * bits_per_key) - 1).bit_length()  # next pow2
        mask = nbits - 1
        k = max(1, min(30, int(bits_per_key * 0.69)))  # ln2 * bits/key
        bits = bytearray(nbits // 8)
        for key in keys:
            h1, h2 = _hash2(key)
            for i in range(k):
                b = (h1 + i * h2) & mask
                bits[b >> 3] |= 1 << (b & 7)
        return cls(k, nbits, bits)

    def may_contain(self, key: bytes) -> bool:
        h1, h2 = _hash2(key)
        bits = self.bits
        mask = self._mask
        if mask is not None:
            for i in range(self.k):
                b = (h1 + i * h2) & mask
                if not bits[b >> 3] & (1 << (b & 7)):
                    return False
            return True
        nbits = self.nbits
        for i in range(self.k):
            b = (h1 + i * h2) % nbits
            if not bits[b >> 3] & (1 << (b & 7)):
                return False
        return True

    def may_contain_many(self, keys) -> np.ndarray:
        """Vectorized probe: one masked numpy gather for the whole batch.

        Returns a ``bool`` ndarray aligned with ``keys`` where
        ``out[i] == self.may_contain(keys[i])`` exactly — including legacy
        non-power-of-two encodings, which vectorize the ``%`` reduction the
        scalar fallback uses. An empty batch returns an empty array.
        """
        n = len(keys)
        if n == 0:
            return np.zeros(0, dtype=bool)
        if n == 1:  # ndarray setup costs more than one scalar probe loop
            return np.array([self.may_contain(keys[0])], dtype=bool)
        bits = self._np_bits
        if bits is None:
            # zero-copy view when the backing store allows it (bytearray /
            # bytes); shares the buffer so there is no stale-copy hazard —
            # filters are immutable once built/decoded
            bits = np.frombuffer(memoryview(self.bits), dtype=np.uint8)
            self._np_bits = bits
        h = np.empty((2, n), dtype=np.uint64)
        crc32, adler32 = zlib.crc32, zlib.adler32  # per-key C calls
        for i, key in enumerate(keys):
            h[0, i] = crc32(key) & 0xFFFFFFFF
            h[1, i] = ((adler32(key) & 0xFFFFFFFF) * 0x9E3779B1 + 0x7F4A7C15) & 0xFFFFFFFF
        h1 = h[0][:, None]
        h2 = (h[1] | np.uint64(1))[:, None]
        probes = np.arange(self.k, dtype=np.uint64)[None, :]
        idx = h1 + probes * h2  # (n, k) — max ~2^32 * 30, fits uint64
        if self._mask is not None:
            idx &= np.uint64(self._mask)
        else:
            idx %= np.uint64(self.nbits)
        got = bits[(idx >> np.uint64(3)).astype(np.int64)]
        want = (np.uint8(1) << (idx & np.uint64(7)).astype(np.uint8)).astype(np.uint8)
        return ((got & want) == want).all(axis=1)

    def encode(self) -> bytes:
        return struct.pack("<BI", self.k, self.nbits) + bytes(self.bits)

    @staticmethod
    def decode(buf: bytes) -> "BloomFilter":
        k, nbits = struct.unpack_from("<BI", buf, 0)
        return BloomFilter(k, nbits, bytearray(buf[5:]))
