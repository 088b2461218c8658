"""Cloud-bucket bookkeeping: copy / upload / discover over any fsspec URL.

Copy of ``exaspim_tpu/utils/cloud.py``: one code path serves ``gs://``,
``s3://``, plain local paths and ``memory://`` through fsspec (imported
inside the functions), so the production code runs on local directories
in the tests. ``list_block_paths`` discovers a brain's image blocks under
``<root>/<...brain_id...>/blocks/<block>/<...input...>``.
"""

from __future__ import annotations

import os
import posixpath

__all__ = [
    "copy_file",
    "copy_tree",
    "upload_tree",
    "download_tree",
    "exists",
    "is_file_in_prefix",
    "list_files",
    "list_subprefixes",
    "find_subprefix_with_keyword",
    "directory_size_gb",
    "list_block_paths",
]


def _fs(url):
    """(filesystem, path-within-fs, protocol-prefix) for any URL."""
    import fsspec

    fs, path = fsspec.core.url_to_fs(str(url))
    proto = fs.protocol if isinstance(fs.protocol, str) else fs.protocol[0]
    prefix = "" if proto in ("file", "local") else f"{proto}://"
    return fs, path, prefix


def _join(prefix, path):
    return f"{prefix}{path}"


def copy_file(src, dst):
    """Copy one object; within one store this is a server-side copy."""
    sfs, spath, _ = _fs(src)
    dfs, dpath, _ = _fs(dst)
    parent = posixpath.dirname(dpath)
    if parent:
        dfs.makedirs(parent, exist_ok=True)  # no-op on object stores
    if type(sfs) is type(dfs):
        sfs.copy(spath, dpath)
    else:
        with sfs.open(spath, "rb") as fin, dfs.open(dpath, "wb") as fout:
            while chunk := fin.read(1 << 22):
                fout.write(chunk)


def copy_tree(src_prefix, dst_prefix):
    """Copy every object under ``src_prefix`` to ``dst_prefix``,
    preserving relative names."""
    sfs, spath, _ = _fs(src_prefix)
    for f in sfs.find(spath):
        rel = posixpath.relpath(f, spath)
        copy_file(
            _rebuild(src_prefix, sfs, f),
            posixpath.join(str(dst_prefix).rstrip("/"), rel),
        )


def _rebuild(url_example, fs, path):
    proto = fs.protocol if isinstance(fs.protocol, str) else fs.protocol[0]
    if proto in ("file", "local"):
        return path
    return f"{proto}://{path}"


def upload_tree(local_dir, dest_prefix):
    """Upload a local directory tree, preserving structure."""
    dfs, dpath, _ = _fs(dest_prefix)
    for root, _, files in os.walk(local_dir):
        for name in files:
            local = os.path.join(root, name)
            rel = os.path.relpath(local, start=local_dir).replace(
                os.sep, "/"
            )
            target = posixpath.join(dpath, rel)
            parent = posixpath.dirname(target)
            if parent:
                dfs.makedirs(parent, exist_ok=True)
            dfs.put_file(local, target)


def download_tree(src_prefix, local_dir):
    """Mirror every object under a prefix into a local directory."""
    sfs, spath, _ = _fs(src_prefix)
    for f in sfs.find(spath):
        rel = posixpath.relpath(f, spath)
        target = os.path.join(local_dir, *rel.split("/"))
        os.makedirs(os.path.dirname(target), exist_ok=True)
        sfs.get_file(f, target)


def exists(url):
    """True when the object or prefix exists."""
    fs, path, _ = _fs(url)
    return fs.exists(path)


def list_files(prefix, extension=None):
    """Recursive file listing under a prefix, optionally filtered."""
    fs, path, proto = _fs(prefix)
    out = [f for f in fs.find(path) if not extension or extension in f]
    return [_join(proto, f) for f in sorted(out)]


def is_file_in_prefix(prefix, name):
    """True when ``name`` appears in any object name under the prefix."""
    fs, path, _ = _fs(prefix)
    return any(name in f for f in fs.find(path))


def list_subprefixes(prefix):
    """Direct sub-directories of a prefix, as full URLs, sorted."""
    fs, path, proto = _fs(prefix)
    subs = [
        p["name"] if isinstance(p, dict) else p
        for p in fs.ls(path, detail=True)
        if (p["type"] if isinstance(p, dict) else None) == "directory"
    ]
    return [_join(proto, s.rstrip("/")) + "/" for s in sorted(subs)]


def find_subprefix_with_keyword(prefix, keyword):
    """First direct subprefix whose name contains ``keyword``."""
    for sub in list_subprefixes(prefix):
        if keyword in posixpath.basename(sub.rstrip("/")):
            return sub
    raise FileNotFoundError(
        f"no subprefix containing {keyword!r} under {prefix}"
    )


def directory_size_gb(prefix):
    """Total object size under a prefix in GiB."""
    fs, path, _ = _fs(prefix)
    info = fs.find(path, detail=True)
    return sum(v.get("size") or 0 for v in info.values()) / (1 << 30)


def list_block_paths(brain_id, root="gs://allen-nd-goog/from_aind/",
                     block_dir="blocks", keyword="input"):
    """URLs of the image blocks for a brain id.

    Layout: ``<root>/<...brain_id...>/blocks/<block>/<...input...>``.
    ``root`` is any fsspec URL, so the same discovery walks a local
    mirror of the bucket in tests.
    """
    brain_prefix = find_subprefix_with_keyword(root, str(brain_id))
    blocks_prefix = posixpath.join(brain_prefix, block_dir)
    return [
        find_subprefix_with_keyword(block, keyword)
        for block in list_subprefixes(blocks_prefix)
    ]
