"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on first use into its own shared
library with a plain C interface, for Hopper (``sm_90a``), into
``exaspim_tpu_torch/build/`` (listed in ``.gitignore``). The library name
carries a hash of the source, of the local headers it includes and of the
flags, so an edited kernel is rebuilt and a stale one is never loaded.
Builds are serialised across threads and across processes (an exclusive
``flock`` on the build directory around compile-and-rename), so loader
workers or two runs of one checkout never race nvcc over a library.
Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["load_library", "build_all", "build_log", "KERNELS", "BUILD_DIR",
           "CSRC_DIR"]

# Every kernel source of the package (``csrc/<name>.cu``).
KERNELS = ("nb_conv3d", "nb_conv3d_dw", "byte_histogram", "bm4d_match",
           "bm4d_select", "asinh_transform", "blocked_conv3d")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}
_lock = threading.Lock()


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path, seen=None):
    """``path`` and every header it includes with ``#include "..."``
    (resolved beside the including file, recursively), in include order."""
    seen = [] if seen is None else seen
    if path in seen:
        return seen
    seen.append(path)
    with open(path, "rb") as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        _sources(os.path.join(os.path.dirname(path), inc.decode()), seen)
    return seen


def _paths(name):
    """The source of ``name`` and its library path, whose name carries a
    hash of the source, of every local header it includes and of the nvcc
    flags."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(src):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _build_lock():
    """Hold ``_lock`` and an exclusive ``flock`` on ``BUILD_DIR``: one
    build at a time, within this process and across processes."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock:
        fd = os.open(BUILD_DIR, os.O_RDONLY)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # releases the flock


def build_all(names=KERNELS):
    """Compile every ``csrc/<name>.cu`` of ``names`` (default: all seven)
    not built yet, one nvcc process per source, all started together; then
    load them. Returns the seconds each build took (0.0 for a library
    already built)."""
    with _build_lock():
        jobs = {}
        for name in names:
            src, lib = _paths(name)
            if name in _libs or os.path.exists(lib):
                continue
            tmp = f"{lib}.{os.getpid()}.tmp"
            jobs[name] = (src, lib, tmp, time.time(), subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        seconds = dict.fromkeys(names, 0.0)
        failed = []
        for name, (src, lib, tmp, t0, proc) in jobs.items():
            log, _ = proc.communicate()
            seconds[name] = time.time() - t0
            _logs[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {src} (rc={proc.returncode}):"
                              f"\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(_paths(name)[1])
                _logs.setdefault(name, "(cached)")
        return seconds


def load_library(name):
    """Compile (once per source version) and load ``csrc/<name>.cu``."""
    if name not in _libs:
        build_all([name])
    return _libs[name]


def build_log(name):
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    from the build of ``csrc/<name>.cu`` in this process."""
    return _logs.get(name, "")
