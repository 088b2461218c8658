"""Blosc-zstd chunked compression ratio (the product metric) and its
device-side proxy."""

from exaspim_tpu_torch.compression.blosc import (
    BloscCodec,
    ZstdShuffleCodec,
    best_codec,
    blosc_available,
)
from exaspim_tpu_torch.compression.cratio import compute_cratio
from exaspim_tpu_torch.compression.proxy import cratio_proxy

__all__ = [
    "BloscCodec",
    "ZstdShuffleCodec",
    "best_codec",
    "blosc_available",
    "compute_cratio",
    "cratio_proxy",
]
