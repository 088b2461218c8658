"""Read a Flax msgpack checkpoint (maps, arrays, str, bin, numbers and
Flax's ndarray extension, type 1: a packed ``(shape, dtype, buffer)``).
The reference's own reader: it shares no code with the program's codec."""

from __future__ import annotations

import json
import struct

import numpy as np

_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
        0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
        0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def unpack(data):
    buf = memoryview(data)
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(buf):
            raise ValueError("msgpack: truncated")
        out = buf[pos:pos + n]
        pos += n
        return out

    def num(fmt):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    def ext(n):
        code = num(">b")
        payload = bytes(take(n))
        if code != 1:
            raise ValueError(f"msgpack: ext type {code}")
        shape, dtype, raw = unpack(payload)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()

    def obj():
        b = num(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return {obj(): obj() for _ in range(b & 0x0F)}
        if 0x90 <= b <= 0x9F:
            return [obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(take(b & 0x1F), "utf-8")
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in _FIXED:
            return num(_FIXED[b])
        if b in _FIXEXT:
            return ext(_FIXEXT[b])
        if b in _LEN:
            n = num(_LEN[b])
            if b <= 0xC6:
                return bytes(take(n))
            if b <= 0xC9:
                return ext(n)
            if b <= 0xDB:
                return str(take(n), "utf-8")
            if b <= 0xDD:
                return [obj() for _ in range(n)]
            return {obj(): obj() for _ in range(n)}
        raise ValueError(f"msgpack: type byte 0x{b:02x}")

    out = obj()
    if pos != len(buf):
        raise ValueError("msgpack: trailing bytes")
    return out


def read_checkpoint(path):
    """``(params, meta)``: the Flax parameter tree (numpy leaves) and the
    checkpoint's metadata (model config, transform)."""
    with open(path, "rb") as f:
        payload = unpack(f.read())
    return payload["params"], json.loads(payload["meta"])
