"""Chunked codecs, the blosc-zstd compression ratio (the product metric),
the slice codecs' ratios and the device-side proxy."""

from exaspim_tpu_torch.compression.blosc1 import Blosc1ZstdCodec
from exaspim_tpu_torch.compression.blosc import (
    BloscCodec,
    ZstdShuffleCodec,
    best_codec,
    blosc_available,
)
from exaspim_tpu_torch.compression.cratio import (
    compress_and_decompress_2d,
    compute_cratio,
    compute_cratio_2d,
    compute_cratio_jpegxl,
)
from exaspim_tpu_torch.compression.jpeg import (
    Jpeg2000SliceCodec,
    JpegSliceCodec,
    PngSliceCodec,
)
from exaspim_tpu_torch.compression.jxl import JxlSliceCodec
from exaspim_tpu_torch.compression.jxl import available as jxl_available
from exaspim_tpu_torch.compression.proxy import cratio_proxy

__all__ = [
    "Blosc1ZstdCodec",
    "BloscCodec",
    "Jpeg2000SliceCodec",
    "JpegSliceCodec",
    "JxlSliceCodec",
    "PngSliceCodec",
    "jxl_available",
    "ZstdShuffleCodec",
    "best_codec",
    "blosc_available",
    "compute_cratio",
    "compute_cratio_2d",
    "compute_cratio_jpegxl",
    "compress_and_decompress_2d",
    "cratio_proxy",
]
