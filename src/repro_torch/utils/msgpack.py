"""The msgpack subset of the reference's checkpoint files, with no package.

The reference writes ``msgpack.packb(payload, use_bin_type=True)`` of a map
from str to maps of str, bin data, arrays and non-negative ints
(``repro/training/checkpoint.py``).  ``packb`` here picks the same smallest
encoding for each value as that call, so the same tree gives the same bytes;
``unpackb`` reads these types back and raises on any other.
"""
from __future__ import annotations

import struct


def _head(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """The header of a length- or value-``n`` item: the fix form below
    ``fix_max`` (where there is one), else the first of ``codes`` ((code,
    struct format, limit)) whose limit holds ``n``."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, limit in codes:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {n} is too large")


_U8, _U16, _U32, _U64 = 1 << 8, 1 << 16, 1 << 32, 1 << 64


def _pack(obj, out: list) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"msgpack subset: cannot pack {obj!r}")
    if isinstance(obj, int):
        if obj < 0:
            raise TypeError(f"msgpack subset: negative int {obj}")
        out.append(_head(obj, 0x00, 0x80, ((0xCC, ">B", _U8), (0xCD, ">H", _U16),
                                           (0xCE, ">I", _U32), (0xCF, ">Q", _U64))))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_head(len(data), 0xA0, 32, ((0xD9, ">B", _U8), (0xDA, ">H", _U16),
                                               (0xDB, ">I", _U32))))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_head(len(data), None, 0, ((0xC4, ">B", _U8), (0xC5, ">H", _U16),
                                              (0xC6, ">I", _U32))))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 16, ((0xDC, ">H", _U16), (0xDD, ">I", _U32))))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 16, ((0xDE, ">H", _U16), (0xDF, ">I", _U32))))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack subset: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# type byte -> (kind, width of the big-endian length or value after it)
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xCC: ("int", 1), 0xCD: ("int", 2), 0xCE: ("int", 4), 0xCF: ("int", 8),
          0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4)}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.i = 0

    def take(self, n: int) -> memoryview:
        if self.i + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        v = self.data[self.i:self.i + n]
        self.i += n
        return v

    def read(self):
        code = self.take(1)[0]
        if code < 0x80:
            return code
        if 0x80 <= code <= 0x8F:
            kind, n = "map", code & 0x0F
        elif 0x90 <= code <= 0x9F:
            kind, n = "array", code & 0x0F
        elif 0xA0 <= code <= 0xBF:
            kind, n = "str", code & 0x1F
        elif code in _SIZED:
            kind, width = _SIZED[code]
            n = int.from_bytes(self.take(width), "big")
            if kind == "int":
                return n
        else:
            raise ValueError(f"msgpack subset: unsupported type byte 0x{code:02x}")
        if kind == "str":
            return bytes(self.take(n)).decode("utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "array":
            return [self.read() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes):
    r = _Reader(data)
    obj = r.read()
    if r.i != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.i} trailing bytes")
    return obj
