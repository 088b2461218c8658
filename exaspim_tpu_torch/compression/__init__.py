"""Blosc-zstd chunked compression ratio (the product metric) and its
device-side proxy."""

from exaspim_tpu_torch.compression.blosc import (
    BloscCodec,
    ZstdShuffleCodec,
    best_codec,
    blosc_available,
)
from exaspim_tpu_torch.compression.cratio import compute_cratio

__all__ = [
    "BloscCodec",
    "ZstdShuffleCodec",
    "best_codec",
    "blosc_available",
    "compute_cratio",
]
