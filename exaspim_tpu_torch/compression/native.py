"""Native chunk walk of the compression-ratio metric.

Counterpart of ``exaspim_tpu/compression/native.py``: a ctypes binding of
``exaspim_chunked_cratio`` in ``native/chunked_cratio.cpp``, which walks
the 64³ chunk grid and calls ``blosc_compress_ctx`` over a thread pool,
so the ratio needs no per-chunk Python loop. The ratio is the Python
walk's (:func:`~exaspim_tpu_torch.compression.cratio.compute_cratio`):
the same library, the same chunks, the same parameters. It is the
yardstick of the port's own walk
(:func:`~exaspim_tpu_torch.compression.blosc1.chunked_cratio`, libzstd
only), which ``compute_cratio`` takes; this walk runs only when
:func:`chunked_cratio` is called.

The library is built on first use with ``g++`` and the flags of
``native/Makefile`` into ``exaspim_tpu_torch/build/`` (gitignored), under
the package's cross-process build lock; its name carries a hash of the
source and the flags. Where ``libblosc.so.1`` (it links against it),
``g++`` or the source is missing, :func:`available` is False and
:func:`unavailable_reason` says why. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

__all__ = ["available", "unavailable_reason", "chunked_cratio", "SOURCE"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "chunked_cratio.cpp")
# native/Makefile's CXXFLAGS and LDFLAGS.
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
LD_FLAGS = ["-shared", "-pthread", "-l:libblosc.so.1"]
_SHUFFLE_IDS = {0: 0, 1: 1, 2: 2, "noshuffle": 0, "shuffle": 1,
                "bitshuffle": 2}

_state = None  # (library, None) or (None, reason), once resolved
_lock = threading.Lock()


def _library_path():
    from exaspim_tpu_torch.ops._build import BUILD_DIR

    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libexaspim_native-{h.hexdigest()[:16]}.so")


def _build():
    """Compile (once per source version) and load the library; returns
    ``(library, None)`` or ``(None, reason)``."""
    from exaspim_tpu_torch.ops._build import _build_lock

    try:
        ctypes.CDLL("libblosc.so.1")
    except OSError:
        return None, "libblosc.so.1 not found (the native walk links it)"
    if not os.path.exists(SOURCE):
        return None, f"{SOURCE} not found"
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        return None, "g++ not found: the native walk cannot be built"
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
    lib.exaspim_chunked_cratio.restype = ctypes.c_double
    lib.exaspim_chunked_cratio.argtypes = [
        ctypes.c_void_p,                                 # uint16 volume
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # shape
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # chunk
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,     # cname/clevel/shuffle
        ctypes.c_int,                                    # n_threads
    ]
    return lib, None


def _load():
    global _state
    with _lock:
        if _state is None:
            _state = _build()
        return _state


def available():
    """True when the native library is built (building it on first call)
    and loads."""
    return _load()[0] is not None


def unavailable_reason():
    """Why :func:`available` is False (None when it is True)."""
    return _load()[1]


def chunked_cratio(img, chunk_shape, cname="zstd", clevel=6, shuffle=1,
                   n_threads=0):
    """Chunked blosc compression ratio of a 3-D uint16 volume, unrounded
    (``n_threads=0``: one thread per core)."""
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"native chunk walk unavailable: {why}")
    img = np.ascontiguousarray(img, dtype=np.uint16)
    if img.ndim != 3:
        raise ValueError(f"expected 3D volume, got shape {img.shape}")
    ratio = lib.exaspim_chunked_cratio(
        img.ctypes.data_as(ctypes.c_void_p),
        *[ctypes.c_int64(int(s)) for s in img.shape],
        *[ctypes.c_int64(int(c)) for c in chunk_shape],
        str(cname).encode(), int(clevel),
        int(_SHUFFLE_IDS.get(shuffle, shuffle)), int(n_threads),
    )
    if ratio <= 0:
        raise RuntimeError(f"native chunked_cratio failed (code {ratio})")
    return float(ratio)
