"""Blosc codec bound to the system ``libblosc`` through ctypes.

Copy of the binding in ``exaspim_tpu/compression/blosc.py``: the same C
library and the same ``blosc_compress_ctx`` parameters, so chunked
compression ratios are byte-for-byte those of the reference. There is no
fallback codec: where ``libblosc`` is missing, :func:`blosc_available`
says so and the caller reports the ratio as unavailable.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

import numpy as np

__all__ = [
    "BloscCodec",
    "ZstdShuffleCodec",
    "best_codec",
    "blosc_available",
    "SHUFFLE",
]

SHUFFLE = 1  # blosc.h: byte shuffle

_MAX_OVERHEAD = 16  # BLOSC_MAX_OVERHEAD

_lib = None
_lib_lock = threading.Lock()


def _load_blosc():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        for name in ("libblosc.so.1", "libblosc.so", "libblosc.dylib",
                     ctypes.util.find_library("blosc")):
            if not name:
                continue
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            lib.blosc_compress_ctx.restype = ctypes.c_int
            lib.blosc_compress_ctx.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ]
            _lib = lib
            return _lib
        raise OSError("libblosc shared library not found")


def blosc_available():
    """True when the system blosc library can be loaded."""
    try:
        _load_blosc()
        return True
    except OSError:
        return False


class BloscCodec:
    """Blosc compressor with ``numcodecs.Blosc`` encode semantics
    (the reference's ``Blosc(cname="zstd", clevel=6, shuffle=SHUFFLE)``)."""

    def __init__(self, cname="zstd", clevel=6, shuffle=SHUFFLE, nthreads=1):
        self.cname = str(cname)
        self.clevel = int(clevel)
        self.shuffle = int(shuffle)
        self.nthreads = int(nthreads)
        self._lib = _load_blosc()

    def encode(self, buf):
        """Compress a numpy array; returns ``bytes``."""
        arr = np.ascontiguousarray(buf)
        raw = arr.tobytes()
        dest = ctypes.create_string_buffer(len(raw) + _MAX_OVERHEAD)
        n = self._lib.blosc_compress_ctx(
            self.clevel, self.shuffle, arr.dtype.itemsize, len(raw), raw,
            dest, len(raw) + _MAX_OVERHEAD, self.cname.encode(), 0,
            self.nthreads,
        )
        if n <= 0:
            raise RuntimeError(f"blosc compression failed (rc={n})")
        return dest.raw[:n]

    @property
    def config(self):
        """Serializable codec config (stamped into run records)."""
        return {
            "id": "blosc",
            "cname": self.cname,
            "clevel": self.clevel,
            "shuffle": self.shuffle,
        }


def byteshuffle(raw, typesize):
    """Blosc-style byte transposition: groups byte k of every element."""
    arr = np.frombuffer(raw, dtype=np.uint8)
    n = arr.size // typesize
    return arr[: n * typesize].reshape(n, typesize).T.copy().tobytes()


class ZstdShuffleCodec:
    """zstd + byte shuffle, the reference's codec where libblosc is
    missing: the same shuffle-then-entropy-code pipeline without blosc's
    block splitting, so ratios track blosc closely but not bit for bit."""

    def __init__(self, clevel=6, shuffle=SHUFFLE, typesize=2):
        import zstandard

        self.clevel = int(clevel)
        self.shuffle = int(shuffle)
        self.typesize = int(typesize)
        self._c = zstandard.ZstdCompressor(level=self.clevel)

    def encode(self, buf):
        if isinstance(buf, np.ndarray):
            arr = np.ascontiguousarray(buf)
            typesize = arr.dtype.itemsize
            raw = arr.tobytes()
        else:
            raw = bytes(buf)
            typesize = self.typesize
        if self.shuffle == SHUFFLE and typesize > 1:
            raw = byteshuffle(raw, typesize)
        # typesize + shuffle byte first, as the reference writes them
        return bytes([typesize, self.shuffle]) + self._c.compress(raw)

    @property
    def config(self):
        return {
            "id": "zstd-shuffle",
            "clevel": self.clevel,
            "shuffle": self.shuffle,
        }


def best_codec(cname="zstd", clevel=6, shuffle=SHUFFLE):
    """The blosc codec when libblosc loads, else :class:`ZstdShuffleCodec`.
    Raises ``RuntimeError`` when neither libblosc nor ``zstandard`` is
    installed: no other codec stands in for them."""
    if blosc_available():
        return BloscCodec(cname=cname, clevel=clevel, shuffle=shuffle)
    try:
        return ZstdShuffleCodec(clevel=clevel, shuffle=shuffle)
    except ImportError:
        raise RuntimeError(
            "no exact compression codec: neither libblosc nor the zstandard "
            "package is installed; measure no exact ratio "
            "(Trainer(exact_cratio_examples=0))"
        ) from None
