"""The port's codecs and ratios against exaspim_tpu.compression, on the CPU.

Both packages bind the same system libraries (libblosc, libzstd through
``zstandard``, libjxl 0.7, PIL's JPEG / PNG / OpenJPEG), so everything is
held exactly: encoded bytes equal, decoded arrays equal (each package
decodes the other's streams too), ratios equal. ``compute_cratio`` is
held with the native chunk walk and with the Python walk (the same
ratio, the JAX package's own semantics); a JPEG-XL-coded Zarr v2 store
written through the JAX package's encoder reads through the port's
``JxlZarrArray`` into JAX's array. The missing-library paths say why.
"""

import ctypes
import json

import numpy as np
import pytest

from exaspim_tpu import compression as jc
from exaspim_tpu.compression import blosc as jblosc
from exaspim_tpu.compression import jxl as jjxl
from exaspim_tpu.utils import img_io as jio
from exaspim_tpu_torch import compression as tc
from exaspim_tpu_torch.compression import blosc as tblosc
from exaspim_tpu_torch.compression import jxl as tjxl
from exaspim_tpu_torch.compression import native
from exaspim_tpu_torch.utils import img_io as tio

pytestmark = pytest.mark.skipif(
    not (tblosc.blosc_available() and tjxl.available()),
    reason="needs libblosc and libjxl (the CPU test machine has both)")


@pytest.fixture(scope="module")
def vol():
    """A noisy uint16 volume with structure, no multiple of the chunks."""
    rng = np.random.default_rng(0)
    z, y, x = np.meshgrid(*[np.arange(n) for n in (70, 66, 65)],
                          indexing="ij")
    clean = 300 + 2000 * np.exp(-((y - 33) ** 2 + (x - 30) ** 2) / 60.0)
    return rng.poisson(clean + 0 * z).astype(np.uint16)


def test_blosc_bytes_and_decodes_match(vol):
    jcod, tcod = jblosc.BloscCodec(), tblosc.BloscCodec()
    for buf in (vol[:10], vol[:3].astype(np.uint8), vol[:4].tobytes()):
        enc = tcod.encode(buf)
        assert enc == jcod.encode(buf)
        raw = buf.tobytes() if isinstance(buf, np.ndarray) else buf
        assert tcod.decode(enc) == jcod.decode(enc) == raw
    assert tcod.config == jcod.config


def test_zstd_shuffle_bytes_and_decodes_match(vol):
    jcod, tcod = jblosc.ZstdShuffleCodec(), tblosc.ZstdShuffleCodec()
    for buf in (vol[:5], vol[:2].tobytes()):
        enc = tcod.encode(buf)
        assert enc == jcod.encode(buf)
        raw = buf.tobytes() if isinstance(buf, np.ndarray) else buf
        assert tcod.decode(enc) == jcod.decode(enc) == raw
    raw = vol[:2].tobytes()
    assert tblosc.unbyteshuffle(tblosc.byteshuffle(raw, 2), 2) == raw
    assert tblosc.unbyteshuffle(raw, 2) == jblosc.unbyteshuffle(raw, 2)


@pytest.mark.parametrize("name,kw", [
    ("PngSliceCodec", {}),
    ("JpegSliceCodec", {"quality": 85}),
    ("Jpeg2000SliceCodec", {"quality": 40}),
    ("Jpeg2000SliceCodec", {"quality": None}),
])
def test_pil_slice_codecs_match(vol, name, kw):
    jcod, tcod = getattr(jc, name)(**kw), getattr(tc, name)(**kw)
    assert tcod.config == jcod.config
    for sl in (vol[5], (vol[6] // 16).astype(np.uint8)):
        enc = tcod.encode(sl)
        assert enc == jcod.encode(sl)
        got = tcod.decode(enc)
        assert got.dtype == sl.dtype
        np.testing.assert_array_equal(got, jcod.decode(enc))
        if name == "PngSliceCodec" or kw.get("quality", 0) is None:
            np.testing.assert_array_equal(got, sl)  # lossless


def test_jxl_streams_match(vol):
    assert tc.jxl_available() and tjxl.unavailable_reason() is None
    for arr, kw in ((vol[3], {}), (vol[3], {"lossless": True}),
                    (vol[:4, :16, :16], {"lossless": True}),
                    ((vol[2] // 16).astype(np.uint8), {"distance": 2.0})):
        enc = tjxl.jxl_encode(arr, **kw)
        assert enc == jjxl.jxl_encode(arr, **kw)
        got = tjxl.jxl_decode(enc, dtype=arr.dtype)
        np.testing.assert_array_equal(got,
                                      jjxl.jxl_decode(enc, dtype=arr.dtype))
        if kw.get("lossless"):
            np.testing.assert_array_equal(got, arr)
    jcod, tcod = jc.JxlSliceCodec(effort=2), tc.JxlSliceCodec(effort=2)
    enc = tcod.encode(vol[9])
    assert enc == jcod.encode(vol[9]) and tcod.config == jcod.config
    np.testing.assert_array_equal(tcod.decode(enc), jcod.decode(enc))


def test_ratios_match(vol):
    codec = tc.BloscCodec()
    want = jc.compute_cratio(vol, jc.BloscCodec(), use_native=False)
    assert native.available() and native.unavailable_reason() is None
    assert tc.compute_cratio(vol, codec) == want
    assert tc.compute_cratio(vol, codec, use_native=False) == want
    assert tc.compute_cratio(vol[None, None], codec) == want
    zc = tc.ZstdShuffleCodec()
    assert tc.compute_cratio(vol, zc) == jc.compute_cratio(
        vol, jc.ZstdShuffleCodec())
    for name, kw in (("PngSliceCodec", {}),
                     ("Jpeg2000SliceCodec", {"quality": 40})):
        assert tc.compute_cratio_2d(vol, getattr(tc, name)(**kw)) == \
            jc.compute_cratio_2d(vol, getattr(jc, name)(**kw))
    assert tc.compute_cratio_jpegxl(vol, effort=2) == \
        jc.compute_cratio_jpegxl(vol, effort=2)
    for name in ("JpegSliceCodec", "Jpeg2000SliceCodec"):
        got, r = tc.compress_and_decompress_2d(vol, getattr(tc, name)())
        want, w = jc.compress_and_decompress_2d(vol, getattr(jc, name)())
        assert r == w and got.dtype == vol.dtype
        np.testing.assert_array_equal(got, want)


def test_native_library_is_built_from_the_checkout():
    path = native._library_path()
    assert path.startswith(native.__file__.rsplit("compression", 1)[0])
    assert native.SOURCE.endswith("native/chunked_cratio.cpp")
    img = np.random.default_rng(1).integers(0, 4000, (64, 64, 70)).astype(
        np.uint16)
    got = native.chunked_cratio(img, (64, 64, 64))
    total_u = total_c = 0
    codec = tblosc.BloscCodec()
    for x0 in (0, 64):
        c = np.ascontiguousarray(img[:, :, x0:x0 + 64])
        total_u += c.nbytes
        total_c += len(codec.encode(c))
    assert got == total_u / total_c


def test_missing_libraries_say_why(monkeypatch):
    real = ctypes.CDLL

    def no_lib(name, *a, **k):
        if "blosc" in str(name) or "jxl" in str(name):
            raise OSError(f"{name}: cannot open shared object file")
        return real(name, *a, **k)

    monkeypatch.setattr(ctypes, "CDLL", no_lib)
    monkeypatch.setattr(native, "_state", None)
    assert not native.available()
    assert "libblosc.so.1 not found" in native.unavailable_reason()
    with pytest.raises(RuntimeError, match="libblosc"):
        native.chunked_cratio(np.zeros((4, 4, 4), np.uint16), (4, 4, 4))
    tjxl._load.cache_clear()
    try:
        assert not tjxl.available()
        assert "libjxl.so.0.7 not found" in tjxl.unavailable_reason()
        with pytest.raises(RuntimeError, match="libjxl.so.0.7 not found"):
            tjxl.jxl_encode(np.zeros((4, 4), np.uint16))
    finally:
        monkeypatch.undo()
        tjxl._load.cache_clear()
        native._state = None
    assert tjxl.available() and native.available()


def test_jxl_zarr_reads_as_jax_reads(tmp_path, vol):
    """A Zarr v2 store of JPEG-XL chunks (``imagecodecs_jpegxl``), written
    through the JAX package's encoder, one chunk missing."""
    data = vol[:9, :20, :28]
    chunks = (4, 16, 16)
    store = tmp_path / "vol.zarr"
    store.mkdir()
    (store / ".zarray").write_text(json.dumps({
        "zarr_format": 2, "shape": list(data.shape), "chunks": list(chunks),
        "dtype": "<u2", "order": "C", "fill_value": 0, "filters": None,
        "compressor": {"id": "imagecodecs_jpegxl"},
    }))
    grid = [-(-s // c) for s, c in zip(data.shape, chunks)]
    for idx in np.ndindex(*grid):
        if idx == (2, 1, 1):
            continue  # a missing chunk reads as fill_value
        buf = np.zeros(chunks, data.dtype)
        sl = tuple(slice(g * c, min((g + 1) * c, s))
                   for g, c, s in zip(idx, chunks, data.shape))
        part = data[sl]
        buf[tuple(slice(0, p) for p in part.shape)] = part
        (store / ".".join(map(str, idx))).write_bytes(
            jjxl.jxl_encode(buf, lossless=True))
    got, want = tio.read(str(store)), jio.read(str(store))
    assert isinstance(got, tio.JxlZarrArray)
    assert (got.shape, got.dtype, got.ndim, len(got)) == (
        want.shape, want.dtype, want.ndim, len(want))
    for key in (np.s_[:], np.s_[2:7, 10:20, 5:25], 3, np.s_[..., 4],
                np.s_[-1], np.s_[8, 17:, 17:], np.s_[1:3, ..., -2]):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got[:8], data[:8])
    with pytest.raises(IndexError):
        got[::2]
