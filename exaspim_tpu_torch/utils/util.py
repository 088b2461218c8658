"""Filesystem / JSON / cloud-path bookkeeping utilities.

Copy of ``exaspim_tpu/utils/util.py``: directory management, txt/json IO,
cloud path parsing and GCS/S3 object listing. The cloud backends bind
through ``fsspec``, imported inside :func:`cloud_filesystem`, so importing
this module needs nothing beyond the standard library.
"""

from __future__ import annotations

import json
import os
import shutil

__all__ = [
    "mkdir",
    "rmdir",
    "list_dir",
    "list_paths",
    "read_txt",
    "write_txt",
    "read_json",
    "write_json",
    "parse_cloud_path",
    "is_cloud_path",
    "list_cloud_paths",
    "cloud_filesystem",
    "sample_once",
    "time_writer",
]


def mkdir(path, delete=False):
    """Create a directory; optionally clear an existing one."""
    if delete:
        rmdir(path)
    os.makedirs(path, exist_ok=True)
    return path


def rmdir(path):
    """Remove a directory tree if it exists."""
    if os.path.isdir(path):
        shutil.rmtree(path)


def list_dir(path, extension=None):
    """Filenames in ``path``, optionally filtered by extension."""
    names = sorted(os.listdir(path))
    if extension:
        names = [n for n in names if n.endswith(extension)]
    return names


def list_paths(path, extension=None):
    """Full paths in ``path``, optionally filtered by extension."""
    return [os.path.join(path, n) for n in list_dir(path, extension)]


def read_txt(path):
    """Lines of a text file, stripped, blanks removed."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def write_txt(path, lines):
    """Write an iterable of lines to a text file."""
    with open(path, "w") as f:
        f.write("\n".join(str(ln) for ln in lines) + "\n")


def read_json(path):
    """Load a JSON file."""
    with open(path) as f:
        return json.load(f)


def write_json(path, obj, **kwargs):
    """Write ``obj`` as pretty sorted JSON (default=str for paths)."""
    kwargs.setdefault("indent", 2)
    kwargs.setdefault("sort_keys", True)
    with open(path, "w") as f:
        json.dump(obj, f, default=str, **kwargs)


def is_cloud_path(path):
    """True for ``gs://`` / ``s3://`` URLs."""
    return str(path).startswith(("gs://", "s3://"))


def parse_cloud_path(path):
    """``gs://bucket/pre/fix`` → ``(scheme, bucket, prefix)``."""
    path = str(path)
    for scheme in ("gs", "s3"):
        token = scheme + "://"
        if path.startswith(token):
            rest = path[len(token):]
            bucket, _, prefix = rest.partition("/")
            return scheme, bucket, prefix
    raise ValueError(f"not a cloud path: {path!r}")


def cloud_filesystem(path):
    """fsspec filesystem for a gs:// or s3:// path (anonymous fallback)."""
    import fsspec

    scheme, _, _ = parse_cloud_path(path)
    if scheme == "gs":
        return fsspec.filesystem("gcs", token="anon")
    try:
        return fsspec.filesystem("s3", anon=True)
    except Exception as exc:  # s3fs not installed in every image
        raise RuntimeError(
            "s3 filesystem backend unavailable (s3fs not installed)"
        ) from exc


def list_cloud_paths(path, extension=None):
    """List objects under a cloud prefix."""
    fs = cloud_filesystem(path)
    scheme, bucket, prefix = parse_cloud_path(path)
    out = []
    for p in fs.ls(f"{bucket}/{prefix}"):
        if extension and not p.endswith(extension):
            continue
        out.append(f"{scheme}://{p}")
    return out


def sample_once(container):
    """One uniformly drawn element."""
    import random

    seq = list(container)
    return seq[random.randint(0, len(seq) - 1)]


def time_writer(t, unit="seconds"):
    """Humanize a duration: returns (value, unit), promoting units."""
    assert unit in ("seconds", "minutes", "hours")
    up = {"seconds": "minutes", "minutes": "hours", "hours": "days"}
    if t < 60 or unit == "hours":
        return t, unit
    return time_writer(t / 60, unit=up[unit])
