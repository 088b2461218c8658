"""Chunked compression ratio, the product metric.

Copy of ``exaspim_tpu/compression/cratio.py:compute_cratio`` (the Python
chunk walk): each 64³ chunk of a uint16 volume is encoded on its own and
the ratio is total uncompressed bytes over total compressed bytes,
rounded to 2 decimals.
"""

from __future__ import annotations

from itertools import product

import numpy as np

__all__ = ["compute_cratio"]


def compute_cratio(img, codec, patch_shape=(64, 64, 64)):
    """Zarr-style chunked compression ratio of a uint16 volume."""
    img = np.asarray(img)
    if img.ndim == 5:
        img = img[0, 0]
    img = np.ascontiguousarray(img, dtype=np.uint16)
    total_c = 0
    total_u = 0
    for start in product(*[range(0, s, c)
                           for s, c in zip(img.shape, patch_shape)]):
        sl = tuple(slice(s, s + c) for s, c in zip(start, patch_shape))
        chunk = np.ascontiguousarray(img[sl])
        total_c += len(codec.encode(chunk))
        total_u += chunk.nbytes
    return round(total_u / total_c, 2)
