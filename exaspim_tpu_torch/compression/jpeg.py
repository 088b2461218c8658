"""PIL-backed 2-D slice codecs for lossy-compression experiments.

Counterpart of ``exaspim_tpu/compression/jpeg.py`` (the reference's
JPEG-family slice experiments, reference img_util.py:444-513). Each codec
encodes one 2-D slice and decodes it back; the payload starts with a
one-byte dtype tag, so ``decode`` needs no encoder state and one instance
is safe to share across the thread pools of
:func:`~exaspim_tpu_torch.compression.cratio.compute_cratio_2d`:

* :class:`Jpeg2000SliceCodec`: uint16-faithful, lossy or lossless
  (OpenJPEG);
* :class:`PngSliceCodec`: lossless, uint16-faithful;
* :class:`JpegSliceCodec`: 8-bit JPEG; uint16 is reduced to its high
  byte, so its ratios are not comparable with the 16-bit codecs'.

PIL is imported inside the methods.
"""

from __future__ import annotations

import io

import numpy as np

__all__ = ["JpegSliceCodec", "PngSliceCodec", "Jpeg2000SliceCodec"]

_TAG_UINT8 = 1
_TAG_UINT16 = 2


def _dtype_tag(dtype):
    if dtype == np.uint8:
        return _TAG_UINT8
    if dtype == np.uint16:
        return _TAG_UINT16
    raise ValueError(f"slice codecs support uint8/uint16, got {dtype}")


def _save(sl, fmt, **kwargs):
    """The PIL-encoded bytes of one slice."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(sl).save(buf, format=fmt, **kwargs)
    return buf.getvalue()


def _load(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data[1:])))


class JpegSliceCodec:
    """Lossy 8-bit JPEG over 2-D slices; uint16 is reduced to its high
    byte (``// 256``) and decodes as ``byte · 256``."""

    def __init__(self, quality=85):
        self.quality = int(quality)
        self.config = {"id": "jpeg", "quality": self.quality}

    def encode(self, sl):
        sl = np.asarray(sl)
        tag = _dtype_tag(sl.dtype)
        sl8 = (sl // 256).astype(np.uint8) if tag == _TAG_UINT16 else sl
        return bytes([tag]) + _save(sl8, "JPEG", quality=self.quality)

    def decode(self, data):
        arr = _load(data).astype(np.uint8)
        if data[0] == _TAG_UINT16:
            return arr.astype(np.uint16) * 256
        return arr


class PngSliceCodec:
    """Lossless PNG over 2-D slices; uint16-faithful (PIL ``I;16``)."""

    def __init__(self):
        self.config = {"id": "png"}

    def encode(self, sl):
        sl = np.asarray(sl)
        return bytes([_dtype_tag(sl.dtype)]) + _save(sl, "PNG")

    def decode(self, data):
        return _load(data).astype(
            np.uint16 if data[0] == _TAG_UINT16 else np.uint8)


class Jpeg2000SliceCodec:
    """JPEG 2000 over 2-D slices, uint16-faithful.

    ``quality`` is OpenJPEG's quality-layer ratio (higher compresses
    more); ``quality=None`` codes reversibly (lossless).
    """

    def __init__(self, quality=40):
        self.quality = None if quality is None else float(quality)
        self.config = {"id": "jpeg2000", "quality": self.quality}

    def encode(self, sl):
        sl = np.asarray(sl)
        tag = _dtype_tag(sl.dtype)
        kwargs = ({"irreversible": False} if self.quality is None else
                  {"irreversible": True, "quality_layers": [self.quality]})
        return bytes([tag]) + _save(sl, "JPEG2000", **kwargs)

    def decode(self, data):
        dtype = np.uint16 if data[0] == _TAG_UINT16 else np.uint8
        info = np.iinfo(dtype)
        return np.clip(_load(data), info.min, info.max).astype(dtype)
