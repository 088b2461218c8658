"""A small pure-Python msgpack codec for Flax checkpoints.

:func:`unpackb` reads exactly what ``flax.serialization.msgpack_serialize``
writes: maps, arrays, str, bin, ints, floats, nil, bool, and Flax's
ndarray extension (type code 1: a msgpack-encoded ``(shape, dtype_name,
buffer)`` triple). :func:`packb` writes the same subset, numpy arrays as
that extension, so Flax's ``msgpack_restore`` reads what it wrote.
Neither ``msgpack`` nor ``flax`` is needed at run time.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["packb", "unpackb"]

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b >= 0xE0:
            return b - 0x100
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {
            0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
            0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
            0xDC: ">H", 0xDD: ">I",                  # array
            0xDE: ">H", 0xDF: ">I",                  # map
            0xC7: ">B", 0xC8: ">H", 0xC9: ">I",      # ext
        }
        if b in lengths:
            n = self.unpack(lengths[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xC9:
                return self._ext(n)
            if b <= 0xDB:
                return self._str(n)
            if b <= 0xDD:
                return self._array(n)
            return self._map(n)
        fixed = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in fixed:
            return self.unpack(fixed[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def _str(self, n):
        return str(self.take(n), "utf-8")

    def _array(self, n):
        return [self.obj() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def _ext(self, n):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype, buf = unpackb(payload)
        # A writable copy: torch.from_numpy warns on read-only buffers.
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpackb(data):
    """Decode one msgpack object from ``data`` (bytes)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes after the object")
    return out


def _head(out, n, fix, fix_max, codes):
    """Append a length header: ``fix | n`` when ``n <= fix_max``, else the
    smallest of the (code, struct format) pairs that holds ``n``."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(struct.pack(">B" + fmt[1:], code, n))
            return
    raise ValueError(f"msgpack: object too large ({n})")


def _pack_int(out, v):
    if 0 <= v <= 0x7F:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v > 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                          (0xCF, ">Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"msgpack: int too large ({v})")
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                          (0xD3, ">q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"msgpack: int too small ({v})")


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack(out, obj):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 31,
              ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(out, len(data), None, -1,
              ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        payload = packb([list(a.shape), a.dtype.name, a.tobytes()])
        n = len(payload)
        if n in _FIXEXT:
            out.append(bytes([_FIXEXT[n]]))
        else:
            _head(out, n, None, -1,
                  ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
        out.append(struct.pack(">b", _EXT_NDARRAY))
        out.append(payload)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj):
    """Encode ``obj`` (dicts, lists, tuples, str, bytes, int, float,
    bool, None, numpy arrays) to msgpack bytes."""
    out = []
    _pack(out, obj)
    return b"".join(out)
