"""Chunked compression ratios: the product metric and the slice codecs'.

Counterpart of ``exaspim_tpu/compression/cratio.py``.
:func:`compute_cratio` is the reference's Zarr-style chunked ratio
(reference img_util.py:401-441): each 64³ chunk of a uint16 volume is
encoded on its own and the ratio is total uncompressed bytes over total
compressed bytes, rounded to 2 decimals. For a blosc-zstd codec it
walks the chunks in C++ with the port's own blosc1 encoder
(:mod:`~exaspim_tpu_torch.compression.blosc1`), else in Python; both
give the same ratio.

:func:`compute_cratio_2d` and :func:`compress_and_decompress_2d` run any
2-D slice codec (``encode``/``decode``) over the chunks' last-axis slices
(reference img_util.py:444-513); :func:`compute_cratio_jpegxl` is the
JPEG-XL case.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from itertools import product

import numpy as np

__all__ = [
    "compute_cratio",
    "compute_cratio_2d",
    "compress_and_decompress_2d",
    "compute_cratio_jpegxl",
]


def _chunk_starts(shape, chunk_shape):
    return product(*[range(0, s, c) for s, c in zip(shape, chunk_shape)])


def compute_cratio(img, codec, patch_shape=(64, 64, 64), use_native=True):
    """Zarr-style chunked compression ratio of a uint16 volume.

    With ``use_native`` and a blosc-zstd codec (``codec.config``: id
    ``"blosc"``, cname ``"zstd"``, shuffle 0 or 1, as ``BloscCodec`` and
    ``Blosc1ZstdCodec`` alike write it) the chunks are walked in C++ by the
    port's blosc1 encoder
    (:func:`~exaspim_tpu_torch.compression.blosc1.chunked_cratio`, libzstd
    only) where it builds; otherwise by the Python loop over
    ``codec.encode``. Both give the same ratio. The libblosc walk of
    ``native/chunked_cratio.cpp`` is never chosen here: call
    :func:`~exaspim_tpu_torch.compression.native.chunked_cratio` to
    compare with it."""
    img = np.asarray(img)
    if img.ndim == 5:
        img = img[0, 0]
    img = np.ascontiguousarray(img, dtype=np.uint16)
    cfg = getattr(codec, "config", None) or {}
    if (use_native and cfg.get("id") == "blosc"
            and cfg.get("cname") == "zstd" and cfg.get("shuffle") in (0, 1)):
        from exaspim_tpu_torch.compression import blosc1

        if blosc1.available():
            return round(blosc1.chunked_cratio(
                img, patch_shape, clevel=cfg["clevel"],
                shuffle=cfg["shuffle"]), 2)
    total_c = 0
    total_u = 0
    for start in _chunk_starts(img.shape, patch_shape):
        sl = tuple(slice(s, s + c) for s, c in zip(start, patch_shape))
        chunk = np.ascontiguousarray(img[sl])
        total_c += len(codec.encode(chunk))
        total_u += chunk.nbytes
    return round(total_u / total_c, 2)


def _chunk(img, start, patch_shape):
    sl = tuple(slice(i, min(i + c, s))
               for i, c, s in zip(start, patch_shape, img.shape))
    return sl, img[sl]


def compute_cratio_2d(img, codec, patch_shape=(128, 128, 64), max_workers=8):
    """Chunked ratio under a 2-D slice codec: every chunk's last-axis
    slices are encoded one by one (``max_workers`` chunks at a time)."""
    img = np.ascontiguousarray(img)

    def one(start):
        _, patch = _chunk(img, start, patch_shape)
        compressed = sum(
            len(codec.encode(np.ascontiguousarray(patch[..., k])))
            for k in range(patch.shape[-1]))
        return patch.nbytes, compressed

    total_u = total_c = 0
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        for u, c in pool.map(one, _chunk_starts(img.shape, patch_shape)):
            total_u += u
            total_c += c
    return round(total_u / total_c, 2)


def compress_and_decompress_2d(img, codec, patch_shape=(32, 256, 256),
                               max_workers=8):
    """Round-trip a volume through a 2-D slice codec; returns
    ``(decoded volume, ratio)`` (what a lossy codec does to the data,
    reference img_util.py:474-513)."""
    img = np.ascontiguousarray(img)

    def one(start):
        sl, patch = _chunk(img, start, patch_shape)
        compressed = 0
        slices = []
        for k in range(patch.shape[-1]):
            enc = codec.encode(np.ascontiguousarray(patch[..., k]))
            compressed += len(enc)
            slices.append(codec.decode(enc))
        return sl, patch.nbytes, compressed, np.stack(slices, axis=-1)

    out = np.empty_like(img)
    total_u = total_c = 0
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        for sl, u, c, patch in pool.map(
                one, _chunk_starts(img.shape, patch_shape)):
            out[sl] = patch
            total_u += u
            total_c += c
    return out, round(total_u / total_c, 2)


def compute_cratio_jpegxl(img, patch_shape=(128, 128, 64), distance=1.0,
                          effort=3, lossless=False, max_workers=8):
    """Chunked JPEG-XL ratio over 2-D slices (reference
    img_util.py:444-472); needs libjxl (``jxl.available()``)."""
    from exaspim_tpu_torch.compression.jxl import JxlSliceCodec

    codec = JxlSliceCodec(distance=distance, effort=effort,
                          lossless=lossless)
    return compute_cratio_2d(img, codec, patch_shape=patch_shape,
                             max_workers=max_workers)
