"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on first use into its own shared
library with a plain C interface, for Hopper (``sm_90a``), into
``exaspim_tpu_torch/build/`` (listed in ``.gitignore``). The library name
carries a hash of the source, so an edited kernel is rebuilt and a stale
one is never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["load_library", "build_all", "build_log", "BUILD_DIR", "CSRC_DIR"]

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


def _paths(name):
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names):
    """Compile every ``csrc/<name>.cu`` not built yet, one nvcc process per
    source, all started together; then load them. Returns the seconds
    each build took (0.0 for a library already built)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock:
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
