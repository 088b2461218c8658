"""Image IO: Zarr / N5 / neuroglancer precomputed / TIFF readers, Zarr v3
and OME-Zarr writers, coordinate transforms, patch access.

Counterpart of ``exaspim_tpu/utils/img_io.py``, on **tensorstore** as there:
reads are lazy TensorStore views (slice, then ``.read().result()``), writes
produce Zarr v3 arrays with blosc-zstd codecs and OME-NGFF multiscale
metadata, so a store written by one package is read by the other.
``tensorstore``, ``fsspec`` and PIL are imported inside the functions that
need them.

Paths are local or cloud URLs (``gs://`` and ``s3://`` open as
tensorstore's gcs and anonymous s3 kvstores). A neuroglancer
``precomputed://`` volume, or any store with an ``info`` file and no Zarr
metadata (probed with one ``<prefix>/info`` lookup through fsspec for a
URL), opens as a lazy (z, y, x) view. A Zarr v2 store coded with
``imagecodecs_jpegxl`` (tensorstore has no JPEG-XL codec) opens as a
:class:`JxlZarrArray`, which decodes its chunks through the package's
libjxl binding (:mod:`exaspim_tpu_torch.compression.jxl`).

The patch bounds check uses ``all``: every axis must be in range.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = [
    "JxlZarrArray",
    "read",
    "as_5d",
    "get_patch",
    "get_slices",
    "get_start_end",
    "get_ome_zarr_level_transform",
    "ome_zarr_coordinate_to_voxel",
    "write_zarr",
    "write_ome_zarr",
    "downsample_windowed_mean",
    "to_physical",
    "to_voxels",
    "local_to_physical",
]

_SHUFFLE_NAMES = {0: "noshuffle", 1: "shuffle", 2: "bitshuffle"}


def _kvstore(path):
    """tensorstore kvstore spec from a local path or cloud URL."""
    path = str(path)
    if path.startswith("gs://"):
        bucket, _, prefix = path[5:].partition("/")
        return {"driver": "gcs", "bucket": bucket, "path": prefix}
    if path.startswith("s3://"):
        bucket, _, prefix = path[5:].partition("/")
        return {
            "driver": "s3", "bucket": bucket, "path": prefix,
            "aws_credentials": {"anonymous": True},
        }
    return {"driver": "file", "path": os.path.abspath(path)}


def _open_ts(spec):
    import tensorstore as ts

    return ts.open(spec).result()


def read(path, dataset=None):
    """Open a volume lazily; dispatch on the format.

    Returns a lazy TensorStore for chunked formats (slice to fetch) or a
    numpy array for TIFF. ``dataset`` selects a subgroup / level (e.g. "0"
    for the full-resolution OME-Zarr level).
    """
    p = str(path).rstrip("/")
    if dataset is not None:
        p = f"{p}/{dataset}"
    lower = p.lower()
    if lower.endswith((".tif", ".tiff")):
        return _read_tiff(p)
    if lower.endswith(".n5") or ".n5/" in lower:
        return _open_ts({"driver": "n5", "kvstore": _kvstore(p)})
    if "precomputed://" in p or _is_neuroglancer_precomputed(p):
        vol = _open_ts({
            "driver": "neuroglancer_precomputed",
            "kvstore": _kvstore(p.replace("precomputed://", "")),
        })
        # Neuroglancer stores (x, y, z, channel): the package's lazy view
        # is (z, y, x).
        return vol[..., 0].T
    # zarr: try v3 then v2.
    try:
        return _open_ts({"driver": "zarr3", "kvstore": _kvstore(p)})
    except Exception:
        try:
            return _open_ts({"driver": "zarr", "kvstore": _kvstore(p)})
        except Exception:
            arr = _maybe_jxl_zarr(p)
            if arr is None:
                raise
            return arr


def _is_neuroglancer_precomputed(path):
    """A store is neuroglancer precomputed iff it has an ``info`` file and
    no Zarr metadata. A URL (any fsspec scheme) is probed the same way
    through :mod:`exaspim_tpu_torch.utils.cloud`; an unreachable or
    unknown one reads as not precomputed."""
    if "://" in path:
        from exaspim_tpu_torch.utils import cloud

        try:
            return cloud.exists(f"{path}/info") and not (
                cloud.exists(f"{path}/zarr.json")
                or cloud.exists(f"{path}/.zarray"))
        except Exception:
            return False
    return os.path.exists(os.path.join(path, "info")) and not (
        os.path.exists(os.path.join(path, "zarr.json"))
        or os.path.exists(os.path.join(path, ".zarray")))


def _store_bytes(path):
    """Raw bytes at ``path`` (local or any fsspec URL); None if absent."""
    if "://" in path:
        from exaspim_tpu_torch.utils.cloud import _fs

        fs, p, _ = _fs(path)
        if not fs.exists(p):
            return None
        with fs.open(p, "rb") as f:
            return f.read()
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def _maybe_jxl_zarr(path):
    """A lazy :class:`JxlZarrArray` when ``path`` is a Zarr v2 array
    compressed with the ``imagecodecs_jpegxl`` codec, else None (the
    reference registers imagecodecs' codec with zarr, reference
    img_util.py:170)."""
    raw = _store_bytes(f"{path}/.zarray")
    if raw is None:
        return None
    meta = json.loads(raw)
    if (meta.get("compressor") or {}).get("id") != "imagecodecs_jpegxl":
        return None
    return JxlZarrArray(path, meta)


class JxlZarrArray:
    """Lazy Zarr v2 reader for ``imagecodecs_jpegxl``-coded stores
    (grayscale uint8/uint16 chunks, C order, no filters).

    Each chunk decodes through
    :func:`~exaspim_tpu_torch.compression.jxl.jxl_decode` (one frame per
    leading slice, as ``imagecodecs.jpegxl_encode`` writes an N-D chunk).
    ``shape``, ``dtype``, ``ndim``, ``len`` and basic slicing (integers and
    unit-step slices, one ``...``) return numpy arrays; a missing chunk
    reads as ``fill_value``.
    """

    def __init__(self, path, meta=None):
        self.path = str(path).rstrip("/")
        if meta is None:
            raw = _store_bytes(f"{self.path}/.zarray")
            if raw is None:
                raise FileNotFoundError(f"no .zarray under {path}")
            meta = json.loads(raw)
        if meta.get("zarr_format") != 2:
            raise ValueError("JxlZarrArray reads zarr v2 arrays only")
        if meta.get("filters"):
            raise ValueError("filters are not supported for jxl zarrs")
        if meta.get("order", "C") != "C":
            raise ValueError("only C-order jxl zarrs are supported")
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value") or 0
        self._sep = meta.get("dimension_separator", ".")

    def __len__(self):
        return self.shape[0]

    @property
    def ndim(self):
        return len(self.shape)

    def _chunk(self, idx):
        """Chunk ``idx`` (grid coordinates), full chunk shape."""
        from exaspim_tpu_torch.compression.jxl import jxl_decode

        raw = _store_bytes(
            f"{self.path}/{self._sep.join(str(i) for i in idx)}")
        if raw is None:
            return np.full(self.chunks, self.fill_value, self.dtype)
        return np.ascontiguousarray(
            jxl_decode(raw, dtype=self.dtype)).reshape(self.chunks)

    def _bounds(self, key):
        """Per axis ``(lo, hi)`` of a basic index, and the integer axes."""
        if not isinstance(key, tuple):
            key = (key,)
        if any(k is Ellipsis for k in key):
            i = key.index(Ellipsis)
            key = (key[:i] + (slice(None),) * (self.ndim - len(key) + 1)
                   + key[i + 1:])
        key = key + (slice(None),) * (self.ndim - len(key))
        squeeze, bounds = [], []
        for ax, k in enumerate(key):
            if isinstance(k, (int, np.integer)):
                k = int(k) + (self.shape[ax] if k < 0 else 0)
                if not 0 <= k < self.shape[ax]:
                    raise IndexError(f"index {k} out of range on axis {ax}")
                squeeze.append(ax)
                bounds.append((k, k + 1))
            elif isinstance(k, slice):
                lo, hi, step = k.indices(self.shape[ax])
                if step != 1:
                    raise IndexError("strided reads are not supported")
                bounds.append((lo, max(lo, hi)))
            else:
                raise IndexError(f"unsupported index {k!r}")
        return bounds, squeeze

    def __getitem__(self, key):
        import itertools

        bounds, squeeze = self._bounds(key)
        out = np.full(tuple(hi - lo for lo, hi in bounds), self.fill_value,
                      self.dtype)
        grids = [range(lo // c, max(lo // c + 1, -(-hi // c)))
                 for (lo, hi), c in zip(bounds, self.chunks)]
        for idx in itertools.product(*grids):
            src, dst = [], []
            for g, c, (lo, hi) in zip(idx, self.chunks, bounds):
                c0 = g * c
                s_lo, s_hi = max(lo, c0), min(hi, c0 + c)
                if s_lo >= s_hi:
                    break
                src.append(slice(s_lo - c0, s_hi - c0))
                dst.append(slice(s_lo - lo, s_hi - lo))
            else:
                out[tuple(dst)] = self._chunk(idx)[tuple(src)]
        return out.reshape(tuple(
            s for ax, s in enumerate(out.shape) if ax not in squeeze))


def _read_tiff(path):
    from PIL import Image

    img = Image.open(path)
    frames = []
    try:
        i = 0
        while True:
            img.seek(i)
            frames.append(np.asarray(img))
            i += 1
    except EOFError:
        pass
    arr = np.stack(frames) if len(frames) > 1 else frames[0]
    return arr


def as_5d(img):
    """Promote an array/TensorStore read to (t, c, z, y, x)."""
    arr = np.asarray(img)
    while arr.ndim < 5:
        arr = arr[np.newaxis]
    return arr


def get_start_end(voxel, shape, from_center=True):
    """Patch bounds around/from a voxel."""
    if from_center:
        start = [v - s // 2 for v, s in zip(voxel, shape)]
    else:
        start = list(voxel)
    end = [s + d for s, d in zip(start, shape)]
    return start, end


def get_slices(voxel, shape, from_center=True):
    """Slice tuple for the patch around/from ``voxel``."""
    start, end = get_start_end(voxel, shape, from_center=from_center)
    return tuple(slice(s, e) for s, e in zip(start, end))


def get_patch(img, voxel, shape, from_center=True):
    """Read a 3D patch from a (lazy) 5D or 3D volume.

    Bounds are validated with ``all`` — every axis must be in range
    (a request partly out of bounds is refused).
    """
    start, end = get_start_end(voxel, shape, from_center=from_center)
    dims = img.shape[-3:]
    valid = all(
        s >= 0 and e <= d for s, e, d in zip(start, end, dims)
    )
    if not valid:
        raise ValueError(
            f"patch [{start}, {end}) out of bounds for volume {dims}"
        )
    sl = get_slices(voxel, shape, from_center=from_center)
    if len(img.shape) == 5:
        out = img[(0, 0) + sl]
    else:
        out = img[sl]
    return np.asarray(
        out.read().result() if hasattr(out, "read") else out
    )


# ------------------------------------------------------------ OME metadata

def _read_group_attrs(group_path):
    """OME attributes of a zarr group (v3 zarr.json or v2 .zattrs)."""
    if group_path.startswith(("gs://", "s3://")):
        from exaspim_tpu_torch.utils.util import (
            cloud_filesystem,
            parse_cloud_path,
        )

        fs = cloud_filesystem(group_path)
        _, bucket, prefix = parse_cloud_path(group_path)
        for name in ("zarr.json", ".zattrs"):
            key = f"{bucket}/{prefix}/{name}"
            if fs.exists(key):
                with fs.open(key) as f:
                    doc = json.load(f)
                return doc.get("attributes", doc)
        raise FileNotFoundError(f"no zarr metadata under {group_path}")
    for name in ("zarr.json", ".zattrs"):
        p = os.path.join(group_path, name)
        if os.path.exists(p):
            with open(p) as f:
                doc = json.load(f)
            return doc.get("attributes", doc)
    raise FileNotFoundError(f"no zarr metadata under {group_path}")


def get_ome_zarr_level_transform(img_path):
    """Scale/translation/unit for an OME-Zarr level array path.

    ``img_path`` points at a level array (e.g. ``…/image.ome.zarr/0``).
    """
    level_path = str(img_path).rstrip("/")
    if "/" not in level_path:
        raise ValueError(f"expected a Zarr level path, got {img_path!r}")
    group_path, dataset_path = level_path.rsplit("/", 1)
    attrs = _read_group_attrs(group_path)
    ome = attrs.get("ome", {})
    multiscales = attrs.get("multiscales") or ome.get("multiscales")
    if not multiscales:
        raise ValueError(f"no OME multiscales metadata at {group_path}")

    for ms in multiscales:
        dataset = next(
            (d for d in ms.get("datasets", [])
             if d.get("path") == dataset_path),
            None,
        )
        if dataset is None:
            continue
        axes = ms.get("axes", [])
        if [a.get("name") for a in axes] != ["t", "c", "z", "y", "x"]:
            raise ValueError(
                "expected OME-Zarr axes in (t, c, z, y, x) order"
            )
        units = {
            a.get("unit") for a in axes if a.get("type") == "space"
        }
        if len(units) != 1 or None in units:
            raise ValueError("expected one common spatial unit")
        scale = np.ones(5)
        translation = np.zeros(5)
        for tr in dataset.get("coordinateTransformations", []):
            if tr.get("type") == "scale":
                scale *= np.asarray(tr["scale"], float)
            elif tr.get("type") == "translation":
                translation += np.asarray(tr["translation"], float)
        return {
            "scale": tuple(scale.tolist()),
            "translation": tuple(translation.tolist()),
            "spatial_unit": units.pop(),
        }
    raise ValueError(
        f"dataset {dataset_path!r} not in OME metadata at {group_path}"
    )


def ome_zarr_coordinate_to_voxel(xyz, level_transform):
    """Neuroglancer (x, y, z) display coords → nearest (z, y, x) voxel."""
    xyz = np.asarray(xyz, float)
    scale = np.asarray(level_transform["scale"], float)
    translation = np.asarray(level_transform["translation"], float)
    if xyz.shape != (3,):
        raise ValueError("xyz must contain exactly three coordinates")
    if scale.shape != (5,) or translation.shape != (5,):
        raise ValueError("scale/translation must each have five values")
    if np.any(scale[2:] == 0):
        raise ValueError("spatial scale values must be nonzero")
    zyx = xyz[::-1] - translation[2:] / scale[2:]
    return tuple(np.rint(zyx).astype(int).tolist())


# ---------------------------------------------------------------- writers

def downsample_windowed_mean(img, factors):
    """Non-overlapping windowed-mean downsample (trailing remainder
    trimmed)."""
    img = np.asarray(img)
    sl = tuple(
        slice(0, (s // f) * f) for s, f in zip(img.shape, factors)
    )
    img = img[sl]
    for ax, f in enumerate(factors):
        if f == 1:
            continue
        shape = img.shape
        new = shape[:ax] + (shape[ax] // f, f) + shape[ax + 1:]
        img = img.reshape(new).mean(axis=ax + 1)
    return img


def _zarr3_codecs(cname, clevel, shuffle, typesize):
    shuffle = _SHUFFLE_NAMES.get(shuffle, shuffle)
    return [
        {"name": "bytes", "configuration": {"endian": "little"}},
        {"name": "blosc", "configuration": {
            "cname": cname, "clevel": int(clevel), "shuffle": shuffle,
            "typesize": typesize,
        }},
    ]


def write_zarr(img, output_path, chunks=(1, 1, 64, 64, 64), cname="zstd",
               clevel=5, shuffle="shuffle"):
    """Write a 5D-promoted volume as one Zarr v3 array."""
    img = as_5d(img)
    chunks = tuple(
        min(c, s) for c, s in zip(chunks, img.shape)
    )
    spec = {
        "driver": "zarr3",
        "kvstore": _kvstore(output_path),
        "metadata": {
            "shape": list(img.shape),
            "chunk_grid": {
                "name": "regular",
                "configuration": {"chunk_shape": list(chunks)},
            },
            "data_type": img.dtype.name,
            "codecs": _zarr3_codecs(
                cname, clevel, shuffle, img.dtype.itemsize
            ),
        },
        "create": True,
        "delete_existing": True,
    }
    arr = _open_ts(spec)
    arr[...] = img
    return output_path


def write_ome_zarr(img, output_path, chunks=(1, 1, 64, 128, 128),
                   n_levels=1, scale_factors=(1, 1, 2, 2, 2),
                   voxel_size=(748, 748, 1000), scale=None,
                   translation=None, spatial_unit="nanometer",
                   cname="zstd", clevel=5, shuffle="shuffle"):
    """Write an OME-NGFF multiscale Zarr v3 group.

    ``voxel_size`` is (x, y, z); an explicit ``scale``/``translation``
    uses stored (t, c, z, y, x) order. Each coarser level's translation
    shifts by half the increase in voxel size (voxel-center convention).
    """
    img = as_5d(img)
    base_scale = np.asarray(
        scale if scale is not None else [1, 1, *reversed(voxel_size)],
        float,
    )
    base_translation = np.asarray(
        translation if translation is not None else np.zeros(5), float
    )
    factors = np.asarray(scale_factors, float)
    for name, v in [("scale", base_scale),
                    ("translation", base_translation),
                    ("scale_factors", factors)]:
        if v.shape != (5,):
            raise ValueError(f"{name} must have five values (t,c,z,y,x)")

    pyramid = [img]
    for _ in range(1, n_levels):
        pyramid.append(
            downsample_windowed_mean(
                pyramid[-1], [int(f) for f in scale_factors]
            ).astype(img.dtype)
        )

    datasets = []
    for i, level in enumerate(pyramid):
        level_scale = base_scale * factors**i
        level_translation = base_translation + (level_scale - base_scale) / 2
        datasets.append({
            "path": str(i),
            "coordinateTransformations": [
                {"type": "scale", "scale": level_scale.tolist()},
                {"type": "translation",
                 "translation": level_translation.tolist()},
            ],
        })
        write_zarr(
            level, f"{str(output_path).rstrip('/')}/{i}", chunks=chunks,
            cname=cname, clevel=clevel, shuffle=shuffle,
        )

    attrs = {
        "ome": {
            "version": "0.5",
            "multiscales": [{
                "axes": [
                    {"name": "t", "type": "time", "unit": "millisecond"},
                    {"name": "c", "type": "channel"},
                    {"name": "z", "type": "space", "unit": spatial_unit},
                    {"name": "y", "type": "space", "unit": spatial_unit},
                    {"name": "x", "type": "space", "unit": spatial_unit},
                ],
                "datasets": datasets,
            }],
        }
    }
    _write_group_meta(output_path, attrs)
    return output_path


def _write_group_meta(path, attributes):
    doc = json.dumps({
        "zarr_format": 3, "node_type": "group",
        "attributes": attributes,
    }, indent=2)
    if str(path).startswith(("gs://", "s3://")):
        from exaspim_tpu_torch.utils.util import (
            cloud_filesystem,
            parse_cloud_path,
        )

        fs = cloud_filesystem(path)
        _, bucket, prefix = parse_cloud_path(str(path))
        with fs.open(f"{bucket}/{prefix}/zarr.json", "w") as f:
            f.write(doc)
    else:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "zarr.json"), "w") as f:
            f.write(doc)


# ------------------------------------------------------- coordinate utils

def to_physical(voxel, anisotropy):
    """(z, y, x) voxel → physical (x, y, z) coordinate."""
    voxel = list(voxel)[::-1]
    return tuple(voxel[i] * anisotropy[i] for i in range(3))


def to_voxels(xyz, anisotropy):
    """Physical (x, y, z) → nearest (z, y, x) voxel."""
    voxel = np.asarray(xyz, float) / np.asarray(anisotropy, float)
    return np.round(voxel).astype(int)[::-1]


def local_to_physical(local_voxel, offset, anisotropy):
    """Patch-local voxel + patch offset → physical coordinate."""
    global_voxel = np.asarray(
        [v + o for v, o in zip(local_voxel, offset)]
    )
    return to_physical(global_voxel, anisotropy)
