"""Blosc-zstd chunked compression ratio (the product metric)."""

from exaspim_tpu_torch.compression.blosc import BloscCodec, blosc_available
from exaspim_tpu_torch.compression.cratio import compute_cratio

__all__ = ["BloscCodec", "blosc_available", "compute_cratio"]
