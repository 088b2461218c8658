"""Precomputed patch cache: the on-disk training-data contract.

Copy of ``exaspim_tpu/data/cache.py``, so the port reads (and writes) the
caches of ``scripts/precompute.py``. A cache directory holds

* ``raw.npy``      — (N, *patch) uint16 noisy counts (memory-mapped),
* ``teacher.npy``  — (N, *patch) uint16 BM4D teacher counts,
* ``fg.npy``       — (N, *patch) bool foreground masks,
* ``transform.json`` — the frozen intensity-transform cfg the cache was
  built for (training must construct the identical mapping),
* ``config.json``  — every generation knob (provenance).

Multiple cache dirs concatenate; all must share one transform cfg.
Patches are served in **count space** — transform application happens at
batch-build time so the same cache serves any compatible transform-domain
consumer. Channels-last (…, 1) layout is appended by the loader, not
stored.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = [
    "CACHE_FILES",
    "load_cache_transform",
    "CachedPatchDataset",
    "CachedValidateDataset",
    "write_cache",
    "allocate_cache",
]

CACHE_FILES = ("raw.npy", "teacher.npy", "fg.npy", "transform.json")


def _normalize_cache_dirs(cache_dirs):
    """Accept a single path or an iterable of paths; validate each."""
    if isinstance(cache_dirs, (str, os.PathLike)):
        cache_dirs = [cache_dirs]
    dirs = [os.fspath(d) for d in cache_dirs]
    if not dirs:
        raise ValueError("at least one cache directory is required")
    for d in dirs:
        missing = [
            f for f in CACHE_FILES if not os.path.exists(os.path.join(d, f))
        ]
        if missing:
            raise FileNotFoundError(
                f"cache dir {d!r} is missing required files: {missing}"
            )
    return dirs


def load_cache_transform(cache_dirs):
    """Load the shared transform cfg; all caches must agree exactly.

    (Reference train_bm4dnet.py:42-79 contract.)
    """
    dirs = _normalize_cache_dirs(cache_dirs)
    cfgs = []
    for d in dirs:
        with open(os.path.join(d, "transform.json")) as f:
            cfgs.append(json.load(f))
    first = cfgs[0]
    for d, cfg in zip(dirs[1:], cfgs[1:]):
        if cfg != first:
            raise ValueError(
                f"cache dirs disagree on transform cfg: {dirs[0]} has "
                f"{first}, {d} has {cfg}"
            )
    return first


class CachedPatchDataset:
    """Memory-mapped (raw, teacher, fg) patch cache spanning ≥1 dirs.

    ``__getitem__`` addresses a global index across all cache dirs via
    cumulative lengths (reference data_handling.py:1015-1190), returning
    count-space numpy views ``(raw_u16, teacher_u16, fg_bool)``.
    """

    fields = ("raw", "teacher", "fg")

    def __init__(self, cache_dirs):
        self.cache_dirs = _normalize_cache_dirs(cache_dirs)
        self.transform_cfg = load_cache_transform(self.cache_dirs)
        self._raw, self._teacher, self._fg = [], [], []
        lengths = []
        for d in self.cache_dirs:
            raw = np.load(os.path.join(d, "raw.npy"), mmap_mode="r")
            teacher = np.load(os.path.join(d, "teacher.npy"), mmap_mode="r")
            fg = np.load(os.path.join(d, "fg.npy"), mmap_mode="r")
            self._validate_cache(d, raw, teacher, fg)
            self._raw.append(raw)
            self._teacher.append(teacher)
            self._fg.append(fg)
            lengths.append(len(raw))
        self._cumlen = np.cumsum(lengths)
        self.patch_shape = tuple(self._raw[0].shape[1:])

    @staticmethod
    def _validate_cache(d, raw, teacher, fg):
        if not (len(raw) == len(teacher) == len(fg)):
            raise ValueError(
                f"cache dir {d!r}: length mismatch raw={len(raw)} "
                f"teacher={len(teacher)} fg={len(fg)}"
            )
        if not (raw.shape == teacher.shape == fg.shape):
            raise ValueError(
                f"cache dir {d!r}: shape mismatch raw={raw.shape} "
                f"teacher={teacher.shape} fg={fg.shape}"
            )
        if raw.ndim != 4:
            raise ValueError(
                f"cache dir {d!r}: expected (N, z, y, x), got {raw.shape}"
            )

    def __len__(self):
        return int(self._cumlen[-1])

    def _locate(self, index):
        if index < 0:
            index += len(self)
        if not 0 <= index < len(self):
            raise IndexError(index)
        shard = int(np.searchsorted(self._cumlen, index, side="right"))
        offset = index - (self._cumlen[shard - 1] if shard else 0)
        return shard, int(offset)

    def __getitem__(self, index):
        shard, i = self._locate(index)
        return (
            np.asarray(self._raw[shard][i]),
            np.asarray(self._teacher[shard][i]),
            np.asarray(self._fg[shard][i]),
        )


class CachedValidateDataset(CachedPatchDataset):
    """Validation cache: same layout, items carry raw counts twice.

    Mirrors the reference's 4-tuple validation item
    ``(noise, target, raw, fg)`` (reference data_handling.py:1193-1233) in
    count space: ``(raw, teacher, raw, fg)`` — the loader transforms the
    first two into the network domain and keeps raw counts for
    count-space metrics.
    """

    fields = ("raw", "teacher", "raw_counts", "fg")

    def __getitem__(self, index):
        raw, teacher, fg = super().__getitem__(index)
        return raw, teacher, raw, fg


def write_cache(cache_dir, raw, teacher, fg, transform_cfg, config=None):
    """Write a complete cache directory fulfilling the contract."""
    os.makedirs(cache_dir, exist_ok=True)
    raw = np.ascontiguousarray(raw, dtype=np.uint16)
    teacher = np.ascontiguousarray(teacher, dtype=np.uint16)
    fg = np.ascontiguousarray(fg, dtype=bool)
    np.save(os.path.join(cache_dir, "raw.npy"), raw)
    np.save(os.path.join(cache_dir, "teacher.npy"), teacher)
    np.save(os.path.join(cache_dir, "fg.npy"), fg)
    with open(os.path.join(cache_dir, "transform.json"), "w") as f:
        json.dump(transform_cfg, f, indent=2, sort_keys=True)
    if config is not None:
        with open(os.path.join(cache_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2, sort_keys=True, default=str)


def allocate_cache(cache_dir, n, patch_shape, transform_cfg, config=None):
    """Preallocate writable memmaps for a cache being built incrementally.

    Returns ``(raw, teacher, fg)`` open ``numpy.lib.format`` memmaps
    (reference scripts/precompute.py:204-213 pattern); ``transform.json``
    and ``config.json`` are written up front so a crashed build is
    diagnosable.
    """
    from numpy.lib.format import open_memmap

    os.makedirs(cache_dir, exist_ok=True)
    with open(os.path.join(cache_dir, "transform.json"), "w") as f:
        json.dump(transform_cfg, f, indent=2, sort_keys=True)
    if config is not None:
        with open(os.path.join(cache_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2, sort_keys=True, default=str)
    shape = (n, *patch_shape)
    raw = open_memmap(
        os.path.join(cache_dir, "raw.npy"), mode="w+", dtype=np.uint16,
        shape=shape,
    )
    teacher = open_memmap(
        os.path.join(cache_dir, "teacher.npy"), mode="w+", dtype=np.uint16,
        shape=shape,
    )
    fg = open_memmap(
        os.path.join(cache_dir, "fg.npy"), mode="w+", dtype=bool,
        shape=shape,
    )
    return raw, teacher, fg
