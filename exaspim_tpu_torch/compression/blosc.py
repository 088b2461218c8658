"""Blosc codec bound to the system ``libblosc`` through ctypes, and the
choice of the exact codec.

:class:`BloscCodec` is a copy of the binding in
``exaspim_tpu/compression/blosc.py``: the same C library and the same
``blosc_compress_ctx`` parameters, so chunked compression ratios are
byte-for-byte those of the reference, and streams decode with
``blosc_decompress_ctx``. It is the yardstick of the port's own blosc1
encoder (:mod:`~exaspim_tpu_torch.compression.blosc1`), which writes the
same zstd frames over libzstd alone: :func:`best_codec` returns that
encoder, so the port scores with the same code on every machine, with
or without libblosc. :class:`ZstdShuffleCodec` is the copy of the
reference's non-exact ``zstandard`` codec; nothing chooses it in place
of an exact one.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

import numpy as np

from exaspim_tpu_torch.compression import blosc1

__all__ = [
    "BloscCodec",
    "ZstdShuffleCodec",
    "best_codec",
    "blosc_available",
    "byteshuffle",
    "unbyteshuffle",
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
            lib.blosc_decompress_ctx.restype = ctypes.c_int
            lib.blosc_decompress_ctx.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_int,
            ]
            lib.blosc_cbuffer_sizes.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_size_t),
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
    """Blosc codec with ``numcodecs.Blosc`` encode/decode semantics
    (the reference's ``Blosc(cname="zstd", clevel=6, shuffle=SHUFFLE)``)."""

    def __init__(self, cname="zstd", clevel=6, shuffle=SHUFFLE, nthreads=1):
        self.cname = str(cname)
        self.clevel = int(clevel)
        self.shuffle = int(shuffle)
        self.nthreads = int(nthreads)
        self._lib = _load_blosc()

    def encode(self, buf):
        """Compress a numpy array (its item size is blosc's type size) or
        bytes (type size 1); returns ``bytes``."""
        raw, typesize = _raw_bytes(buf, 1)
        dest = ctypes.create_string_buffer(len(raw) + _MAX_OVERHEAD)
        n = self._lib.blosc_compress_ctx(
            self.clevel, self.shuffle, typesize, len(raw), raw,
            dest, len(raw) + _MAX_OVERHEAD, self.cname.encode(), 0,
            self.nthreads,
        )
        if n <= 0:
            raise RuntimeError(f"blosc compression failed (rc={n})")
        return dest.raw[:n]

    def decode(self, data):
        """Decompress a blosc stream; returns ``bytes``."""
        data = bytes(data)
        nbytes, cbytes, blocksize = (ctypes.c_size_t() for _ in range(3))
        self._lib.blosc_cbuffer_sizes(data, ctypes.byref(nbytes),
                                      ctypes.byref(cbytes),
                                      ctypes.byref(blocksize))
        out = ctypes.create_string_buffer(nbytes.value)
        m = self._lib.blosc_decompress_ctx(data, out, nbytes.value,
                                           self.nthreads)
        if m != nbytes.value:
            raise RuntimeError(f"blosc decompression failed (rc={m})")
        return out.raw

    @property
    def config(self):
        """Serializable codec config (stamped into run records)."""
        return {
            "id": "blosc",
            "cname": self.cname,
            "clevel": self.clevel,
            "shuffle": self.shuffle,
        }


def _raw_bytes(buf, typesize):
    """``(bytes, type size)`` of a numpy array (its item size) or of a
    bytes-like object (``typesize``)."""
    if isinstance(buf, np.ndarray):
        arr = np.ascontiguousarray(buf)
        return arr.tobytes(), arr.dtype.itemsize
    return bytes(buf), typesize


def byteshuffle(raw, typesize):
    """Blosc-style byte transposition: groups byte k of every element."""
    arr = np.frombuffer(raw, dtype=np.uint8)
    n = arr.size // typesize
    return arr[: n * typesize].reshape(n, typesize).T.copy().tobytes()


def unbyteshuffle(raw, typesize):
    """Inverse of :func:`byteshuffle`."""
    arr = np.frombuffer(raw, dtype=np.uint8)
    n = arr.size // typesize
    return arr.reshape(typesize, n).T.copy().tobytes()


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
        self._d = zstandard.ZstdDecompressor()

    def encode(self, buf):
        raw, typesize = _raw_bytes(buf, self.typesize)
        if self.shuffle == SHUFFLE and typesize > 1:
            raw = byteshuffle(raw, typesize)
        # typesize + shuffle byte first, so decode can invert
        return bytes([typesize, self.shuffle]) + self._c.compress(raw)

    def decode(self, data):
        data = bytes(data)
        typesize, shuffle = data[0], data[1]
        raw = self._d.decompress(data[2:])
        if shuffle == SHUFFLE and typesize > 1:
            raw = unbyteshuffle(raw, typesize)
        return raw

    @property
    def config(self):
        return {
            "id": "zstd-shuffle",
            "clevel": self.clevel,
            "shuffle": self.shuffle,
        }


def best_codec(cname="zstd", clevel=6, shuffle=SHUFFLE):
    """The exact blosc codec: the port's own blosc1 encoder
    (:class:`~exaspim_tpu_torch.compression.blosc1.Blosc1ZstdCodec`, over
    libzstd) for zstd with shuffle 0 or 1, whether or not libblosc is
    installed; :class:`BloscCodec` (libblosc) for another compressor.
    Raises ``RuntimeError`` with the reason where that codec cannot be
    had: no other codec stands in for it."""
    if cname == "zstd" and shuffle in (0, 1):
        if not blosc1.available():
            raise RuntimeError("no exact compression codec: "
                               f"{blosc1.unavailable_reason()}")
        return blosc1.Blosc1ZstdCodec(clevel=clevel, shuffle=shuffle)
    if not blosc_available():
        raise RuntimeError(f"no exact compression codec: blosc with "
                           f"{cname!r} (shuffle {shuffle}) needs libblosc, "
                           "which is not installed")
    return BloscCodec(cname=cname, clevel=clevel, shuffle=shuffle)
