"""The subset of MessagePack that the storage engine (MANIFEST edits, SST
index and range-tombstone blocks) and checkpoint META records use: nil,
bool, int, float32/64, str, bin, array and map.

``packb`` writes what ``msgpack.packb(obj, use_bin_type=True)`` writes for
the same object (the smallest int encoding, Python floats as float64, str
and bytes as str/bin families), so either package reads the other's files;
``unpackb`` reads those bytes back as ``msgpack.unpackb(raw, raw=False)``
does (arrays as lists). Both take the keyword the engine passes to
``msgpack`` at its only setting. The port carries its own codec because the
machine it trains on need not have ``msgpack``.
"""
from __future__ import annotations

import struct


def packb(obj, use_bin_type: bool = True) -> bytes:
    if not use_bin_type:
        raise ValueError("only use_bin_type=True (str and bin kept apart) is supported")
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), out, fix=(0xA0, 31), codes=(0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), out, fix=None, codes=(0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, fix=(0x90, 15), codes=(None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, fix=(0x80, 15), codes=(None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to MessagePack")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                               (0xCF, ">Q", 1 << 64)):
            if n < top:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"{n} does not fit in 64 bits")
    else:
        for code, fmt, bottom in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)), (0xD2, ">i", -(1 << 31)),
                                  (0xD3, ">q", -(1 << 63))):
            if n >= bottom:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"{n} does not fit in 64 bits")


def _pack_len(n: int, out: bytearray, fix, codes) -> None:
    """A length header: the fix form (base, largest length) where the type
    has one, else the 8-, 16- or 32-bit form (a None code: no such form)."""
    if fix is not None and n <= fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit in 32 bits")


def unpackb(data: bytes, raw: bool = False):
    if raw:
        raise ValueError("only raw=False (str read as str) is supported")
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the MessagePack object")
    return obj


_FIXED = {  # code: (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTHS = {  # code: (kind, struct format of the length, its size)
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def _unpack(buf: memoryview, i: int):
    code = buf[i]
    i += 1
    if code < 0x80:
        return code, i
    if code >= 0xE0:
        return code - 0x100, i
    if 0x80 <= code <= 0x8F:
        return _container("map", code & 0x0F, buf, i)
    if 0x90 <= code <= 0x9F:
        return _container("array", code & 0x0F, buf, i)
    if 0xA0 <= code <= 0xBF:
        n = code & 0x1F
        return str(buf[i:i + n], "utf-8"), i + n
    if code == 0xC0:
        return None, i
    if code in (0xC2, 0xC3):
        return code == 0xC3, i
    if code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if code in _LENGTHS:
        kind, fmt, size = _LENGTHS[code]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += size
        if kind == "str":
            return str(buf[i:i + n], "utf-8"), i + n
        if kind == "bin":
            return bytes(buf[i:i + n]), i + n
        return _container(kind, n, buf, i)
    raise ValueError(f"MessagePack type 0x{code:02x} is not supported")


def _container(kind: str, n: int, buf: memoryview, i: int):
    if kind == "array":
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i
