"""Blosc1 zstd frames without libblosc: the port's own codec over libzstd.

The product metric is the chunked blosc-zstd ratio (level 6, byte
shuffle, 64³ chunks). libblosc is not on every machine the port runs on,
but libzstd is, and a blosc1 zstd frame is simple: a 16-byte header, one
4-byte start per block and per block a 4-byte length and the zstd frame
of the shuffled block (or the block raw where zstd does not shrink it).
``csrc/blosc1_zstd.cpp`` writes those frames as ``blosc_compress_ctx``
does (c-blosc 1.x: the same block sizes, ``2·clevel − 1`` as the zstd
level, the same raw-store and memcpy rules), so over the same libzstd
they are byte-equal to libblosc's, and reads zstd and memcpyed frames
back. Its chunk walk, :func:`chunked_cratio`, is the counterpart of
``native/chunked_cratio.cpp`` and gives the same unrounded ratio. The
ratio follows the machine's libzstd version (:func:`zstd_version`), as
libblosc's does.

The library is built at first use with ``g++`` into
``exaspim_tpu_torch/build/`` (gitignored), under the package's
cross-process build lock; its name carries a hash of the source and the
flags, and it links only ``libzstd.so.1``. Where ``g++``, the source or
libzstd is missing, :func:`available` is False and
:func:`unavailable_reason` says why. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading

import numpy as np

__all__ = [
    "Blosc1ZstdCodec",
    "available",
    "unavailable_reason",
    "encode",
    "decode",
    "frame_header",
    "chunked_cratio",
    "zstd_version",
    "SOURCE",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "blosc1_zstd.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall"]
LD_FLAGS = ["-shared", "-pthread", "-l:libzstd.so.1"]
MAX_OVERHEAD = 16  # BLOSC_MAX_OVERHEAD

# Compressor format codes of a blosc1 header (flags >> 5).
COMPRESSORS = {0: "blosclz", 1: "lz4/lz4hc", 2: "snappy", 3: "zlib",
               4: "zstd"}
_ERRORS = {-1: "bad arguments", -2: "out of memory",
           -3: "truncated or inconsistent frame",
           -5: "bitshuffled frame (only the byte shuffle decodes here)",
           -6: "zstd failed to decode a block"}

_state = None  # (library, None) or (None, reason), once resolved
_lock = threading.Lock()


def _library_path():
    from exaspim_tpu_torch.ops._build import BUILD_DIR

    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libblosc1_zstd-{h.hexdigest()[:16]}.so")


def _build():
    """Compile (once per source version) and load the library; returns
    ``(library, None)`` or ``(None, reason)``."""
    from exaspim_tpu_torch.ops._build import _build_lock

    try:
        ctypes.CDLL("libzstd.so.1")
    except OSError:
        return None, "libzstd.so.1 not found (the blosc1 codec links it)"
    if not os.path.exists(SOURCE):
        return None, f"{SOURCE} not found"
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        return None, "g++ not found: the blosc1 codec cannot be built"
    path = _library_path()
    with _build_lock():
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LD_FLAGS],
                capture_output=True, text=True)
            if proc.returncode != 0:
                return None, (f"g++ failed for {SOURCE} "
                              f"(rc={proc.returncode}): {proc.stderr}")
            os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    lib.exaspim_blosc1_encode.restype = i64
    lib.exaspim_blosc1_encode.argtypes = [
        vp, i64, i64, ctypes.c_int, ctypes.c_int, vp, i64]
    lib.exaspim_blosc1_decode.restype = i64
    lib.exaspim_blosc1_decode.argtypes = [vp, i64, vp, i64]
    lib.exaspim_blosc1_chunked_cratio.restype = ctypes.c_double
    lib.exaspim_blosc1_chunked_cratio.argtypes = [
        vp, i64, i64, i64, i64, i64, i64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.exaspim_blosc1_zstd_version.restype = ctypes.c_char_p
    lib.exaspim_blosc1_zstd_version.argtypes = []
    return lib, None


def _load():
    global _state
    with _lock:
        if _state is None:
            _state = _build()
        return _state


def _lib():
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"blosc1 zstd codec unavailable: {why}")
    return lib


def available():
    """True when the codec's library is built (building it on first call)
    and loads."""
    return _load()[0] is not None


def unavailable_reason():
    """Why :func:`available` is False (None when it is True)."""
    return _load()[1]


def zstd_version():
    """``ZSTD_versionString()`` of the libzstd the codec runs on."""
    return _lib().exaspim_blosc1_zstd_version().decode()


def _bytes_view(buf):
    """A flat uint8 view of a bytes-like object or a numpy array (copied
    only when the array is not C-contiguous)."""
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
    return np.frombuffer(buf, dtype=np.uint8)


def encode(buf, typesize, clevel=6, shuffle=1):
    """One blosc1 zstd frame of ``buf`` (bytes-like or a numpy array, read
    as bytes), byte-equal to ``blosc_compress_ctx(clevel, shuffle,
    typesize, n, buf, dest, n + 16, "zstd", 0, 1)``."""
    src = _bytes_view(buf)
    n = src.size
    dest = ctypes.create_string_buffer(n + MAX_OVERHEAD)
    got = _lib().exaspim_blosc1_encode(
        src.ctypes.data, n, int(typesize), int(clevel), int(shuffle), dest,
        n + MAX_OVERHEAD)
    if got <= 0:
        raise RuntimeError(
            f"blosc1 encode failed: {_ERRORS.get(got, f'code {got}')}")
    return dest.raw[:got]


def frame_header(frame):
    """The 16-byte header of a blosc1 frame as a dict: ``version``,
    ``versionlz``, ``flags``, ``typesize``, ``nbytes``, ``blocksize``,
    ``cbytes``, and from the flags ``shuffle``, ``memcpyed``,
    ``dont_split`` and ``compressor``."""
    if len(frame) < MAX_OVERHEAD:
        raise ValueError(f"a blosc1 frame has a 16-byte header; got "
                         f"{len(frame)} bytes")
    version, versionlz, flags, typesize, nbytes, blocksize, cbytes = (
        struct.unpack("<BBBBiii", bytes(frame[:MAX_OVERHEAD])))
    return {
        "version": version, "versionlz": versionlz, "flags": flags,
        "typesize": typesize, "nbytes": nbytes, "blocksize": blocksize,
        "cbytes": cbytes,
        "shuffle": 2 if flags & 0x4 else flags & 0x1,
        "memcpyed": bool(flags & 0x2),
        "dont_split": bool(flags & 0x10),
        "compressor": COMPRESSORS.get(flags >> 5, f"code {flags >> 5}"),
    }


def decode(frame):
    """The bytes of a blosc1 frame: zstd frames (shuffled or not, any
    number of blocks) and memcpyed frames. A frame of another compressor
    raises ``ValueError`` naming it."""
    head = frame_header(frame)
    if not head["memcpyed"] and head["compressor"] != "zstd":
        raise ValueError(f"blosc1 frame of the {head['compressor']} "
                         "compressor: only zstd frames decode here")
    src = _bytes_view(frame)
    out = ctypes.create_string_buffer(max(head["nbytes"], 1))
    got = _lib().exaspim_blosc1_decode(src.ctypes.data, src.size, out,
                                      head["nbytes"])
    if got != head["nbytes"]:
        raise RuntimeError(
            f"blosc1 decode failed: {_ERRORS.get(got, f'code {got}')}")
    return out.raw[:got]


def chunked_cratio(img, chunk_shape=(64, 64, 64), clevel=6, shuffle=1,
                   n_threads=0):
    """Chunked blosc-zstd ratio of a 3-D uint16 volume, unrounded: every
    chunk of the grid (edge chunks ragged) framed on its own, total bytes
    over total framed bytes (``n_threads=0``: one thread per core)."""
    img = np.ascontiguousarray(img, dtype=np.uint16)
    if img.ndim != 3:
        raise ValueError(f"expected 3D volume, got shape {img.shape}")
    ratio = _lib().exaspim_blosc1_chunked_cratio(
        img.ctypes.data_as(ctypes.c_void_p),
        *[int(s) for s in img.shape], *[int(c) for c in chunk_shape],
        int(clevel), int(shuffle), int(n_threads))
    if ratio <= 0:
        code = int(ratio)
        raise RuntimeError(f"blosc1 chunked_cratio failed: "
                           f"{_ERRORS.get(code, f'code {code}')}")
    return float(ratio)


class Blosc1ZstdCodec:
    """``BloscCodec(cname="zstd")`` without libblosc: the same
    ``encode``/``decode``/``config`` and the same bytes, written by this
    module's library over libzstd."""

    cname = "zstd"

    def __init__(self, clevel=6, shuffle=1):
        if shuffle not in (0, 1):
            raise ValueError(f"shuffle must be 0 or 1, got {shuffle!r}")
        self.clevel = int(clevel)
        self.shuffle = int(shuffle)
        _lib()

    def encode(self, buf):
        """Compress a numpy array (its item size is the type size) or
        bytes (type size 1); returns ``bytes``."""
        typesize = buf.dtype.itemsize if isinstance(buf, np.ndarray) else 1
        return encode(buf, typesize, self.clevel, self.shuffle)

    def decode(self, data):
        """Decompress a blosc1 frame; returns ``bytes``."""
        return decode(data)

    @property
    def config(self):
        """Serializable codec config, :class:`BloscCodec`'s: the frames
        are the same."""
        return {
            "id": "blosc",
            "cname": self.cname,
            "clevel": self.clevel,
            "shuffle": self.shuffle,
        }
