"""JPEG-XL slice codec bound to ``libjxl`` (0.7) through ctypes.

Counterpart of ``exaspim_tpu/compression/jxl.py``: the reference runs
JPEG-XL over 2-D uint16 slices through ``imagecodecs`` (reference
img_util.py:444-513, ``jpegxl_encode(..., effort, distance)``); this
module declares the part of libjxl's encoder and decoder C API it needs
and round-trips uint8 / uint16 grayscale slices, faithful to the 16-bit
range. A 3-D array codes as a multi-frame stream, one frame per leading
slice, as ``imagecodecs.jpegxl_encode`` writes N-D Zarr chunks.

The structure layouts are libjxl 0.7's. :func:`available` gates every
caller; :func:`unavailable_reason` says why it is False (the library is
not installed, as on a machine without libjxl, or lacks an entry point).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

__all__ = ["available", "unavailable_reason", "jxl_encode", "jxl_decode",
           "JxlSliceCodec"]

# ---------------------------------------------------------------- ABI (0.7)

_JXL_TYPE_UINT8 = 2
_JXL_TYPE_UINT16 = 3

_ENC_SUCCESS = 0
_ENC_NEED_MORE_OUTPUT = 2

_DEC_SUCCESS = 0
_DEC_ERROR = 1
_DEC_NEED_IMAGE_OUT_BUFFER = 5
_DEC_BASIC_INFO = 0x40
_DEC_FULL_IMAGE = 0x1000

_FRAME_SETTING_EFFORT = 0  # JXL_ENC_FRAME_SETTING_EFFORT

_NAMES = ("libjxl.so.0.7", "libjxl.so", "libjxl.so.0")


class _JxlPixelFormat(ctypes.Structure):
    _fields_ = [
        ("num_channels", ctypes.c_uint32),
        ("data_type", ctypes.c_int),
        ("endianness", ctypes.c_int),
        ("align", ctypes.c_size_t),
    ]


class _JxlBlendInfo(ctypes.Structure):
    _fields_ = [
        ("blendmode", ctypes.c_int),
        ("source", ctypes.c_uint32),
        ("alpha", ctypes.c_uint32),
        ("clamp", ctypes.c_int),
    ]


class _JxlLayerInfo(ctypes.Structure):
    _fields_ = [
        ("have_crop", ctypes.c_int),
        ("crop_x0", ctypes.c_int32),
        ("crop_y0", ctypes.c_int32),
        ("xsize", ctypes.c_uint32),
        ("ysize", ctypes.c_uint32),
        ("blend_info", _JxlBlendInfo),
        ("save_as_reference", ctypes.c_uint32),
    ]


class _JxlFrameHeader(ctypes.Structure):
    # libjxl 0.7 encode.h layout.
    _fields_ = [
        ("duration", ctypes.c_uint32),
        ("timecode", ctypes.c_uint32),
        ("name_length", ctypes.c_uint32),
        ("is_last", ctypes.c_int),
        ("layer_info", _JxlLayerInfo),
    ]


class _JxlBasicInfo(ctypes.Structure):
    # libjxl 0.7 codestream_header.h layout (all 4-byte fields).
    _fields_ = [
        ("have_container", ctypes.c_int),
        ("xsize", ctypes.c_uint32),
        ("ysize", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("exponent_bits_per_sample", ctypes.c_uint32),
        ("intensity_target", ctypes.c_float),
        ("min_nits", ctypes.c_float),
        ("relative_to_max_display", ctypes.c_int),
        ("linear_below", ctypes.c_float),
        ("uses_original_profile", ctypes.c_int),
        ("have_preview", ctypes.c_int),
        ("have_animation", ctypes.c_int),
        ("orientation", ctypes.c_int),
        ("num_color_channels", ctypes.c_uint32),
        ("num_extra_channels", ctypes.c_uint32),
        ("alpha_bits", ctypes.c_uint32),
        ("alpha_exponent_bits", ctypes.c_uint32),
        ("alpha_premultiplied", ctypes.c_int),
        ("preview_xsize", ctypes.c_uint32),
        ("preview_ysize", ctypes.c_uint32),
        ("anim_tps_numerator", ctypes.c_uint32),
        ("anim_tps_denominator", ctypes.c_uint32),
        ("anim_num_loops", ctypes.c_uint32),
        ("anim_have_timecodes", ctypes.c_int),
        ("intrinsic_xsize", ctypes.c_uint32),
        ("intrinsic_ysize", ctypes.c_uint32),
        ("padding", ctypes.c_uint8 * 100),
    ]


@functools.cache
def _load():
    """``(library, None)``, or ``(None, reason)`` where it does not load."""
    for name in _NAMES:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        return None, f"{_NAMES[0]} not found (tried {', '.join(_NAMES)})"
    try:
        lib.JxlEncoderCreate.restype = ctypes.c_void_p
        lib.JxlEncoderCreate.argtypes = [ctypes.c_void_p]
        lib.JxlEncoderDestroy.argtypes = [ctypes.c_void_p]
        lib.JxlEncoderInitBasicInfo.argtypes = [ctypes.c_void_p]
        lib.JxlEncoderSetBasicInfo.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p
        ]
        lib.JxlColorEncodingSetToSRGB.argtypes = [
            ctypes.c_void_p, ctypes.c_int
        ]
        lib.JxlEncoderSetColorEncoding.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p
        ]
        lib.JxlEncoderFrameSettingsCreate.restype = ctypes.c_void_p
        lib.JxlEncoderFrameSettingsCreate.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p
        ]
        lib.JxlEncoderFrameSettingsSetOption.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        ]
        lib.JxlEncoderSetFrameDistance.argtypes = [
            ctypes.c_void_p, ctypes.c_float
        ]
        lib.JxlEncoderSetFrameLossless.argtypes = [
            ctypes.c_void_p, ctypes.c_int
        ]
        lib.JxlEncoderInitFrameHeader.argtypes = [ctypes.c_void_p]
        lib.JxlEncoderSetFrameHeader.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p
        ]
        lib.JxlEncoderAddImageFrame.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.JxlEncoderCloseInput.argtypes = [ctypes.c_void_p]
        lib.JxlEncoderProcessOutput.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.JxlDecoderCreate.restype = ctypes.c_void_p
        lib.JxlDecoderCreate.argtypes = [ctypes.c_void_p]
        lib.JxlDecoderDestroy.argtypes = [ctypes.c_void_p]
        lib.JxlDecoderSubscribeEvents.argtypes = [
            ctypes.c_void_p, ctypes.c_int
        ]
        lib.JxlDecoderSetInput.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t
        ]
        lib.JxlDecoderCloseInput.argtypes = [ctypes.c_void_p]
        lib.JxlDecoderProcessInput.argtypes = [ctypes.c_void_p]
        lib.JxlDecoderGetBasicInfo.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p
        ]
        lib.JxlDecoderSetImageOutBuffer.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_size_t,
        ]
    except AttributeError as exc:
        return None, f"{name} lacks an entry point of the 0.7 API: {exc}"
    return lib, None


def _lib():
    return _load()[0]


def available():
    """True when libjxl with the expected 0.7 entry points is loadable."""
    return _lib() is not None


def unavailable_reason():
    """Why :func:`available` is False (None when it is True)."""
    return _load()[1]


def _pixel_format(dtype):
    if dtype == np.uint16:
        return _JxlPixelFormat(1, _JXL_TYPE_UINT16, 0, 0)
    if dtype == np.uint8:
        return _JxlPixelFormat(1, _JXL_TYPE_UINT8, 0, 0)
    raise ValueError(f"JPEG-XL slice codec supports uint8/uint16, got {dtype}")


def jxl_encode(img, distance=1.0, effort=3, lossless=False):
    """Encode a grayscale uint8/uint16 array to a JPEG-XL codestream.

    2D arrays encode as a single frame; 3D arrays encode each leading-
    axis slice as one frame of a multiframe (animation) codestream —
    the layout ``imagecodecs.jpegxl_encode`` produces for the 3D zarr
    chunks the reference reads (reference img_util.py:170, 444-513).

    ``distance`` is the Butteraugli distance (0 = mathematically lossless,
    1.0 ≈ visually lossless); ``effort`` 1-9 trades speed for density —
    the same knobs the reference passes to ``imagecodecs.jpegxl_encode``
    (reference img_util.py:444-513).
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"libjxl is not available: {unavailable_reason()}")
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        frames = img[None]
    elif img.ndim == 3:
        frames = img
    else:
        raise ValueError(f"expected a 2D slice or 3D stack, got {img.shape}")
    fmt = _pixel_format(img.dtype)

    enc = lib.JxlEncoderCreate(None)
    try:
        info = _JxlBasicInfo()
        lib.JxlEncoderInitBasicInfo(ctypes.byref(info))
        info.xsize = frames.shape[2]
        info.ysize = frames.shape[1]
        info.bits_per_sample = 16 if img.dtype == np.uint16 else 8
        info.exponent_bits_per_sample = 0
        info.num_color_channels = 1
        info.uses_original_profile = 1 if (lossless or distance == 0) else 0
        if frames.shape[0] > 1:
            # Multiframe streams need the animation header (frame
            # timing is meaningless for volumetric chunks; 1 tick/s).
            info.have_animation = 1
            info.anim_tps_numerator = 1
            info.anim_tps_denominator = 1
            info.anim_num_loops = 0
            info.anim_have_timecodes = 0
        if lib.JxlEncoderSetBasicInfo(enc, ctypes.byref(info)) != _ENC_SUCCESS:
            raise RuntimeError("JxlEncoderSetBasicInfo failed")

        color = (ctypes.c_uint8 * 160)()
        lib.JxlColorEncodingSetToSRGB(ctypes.byref(color), 1)  # grayscale
        if lib.JxlEncoderSetColorEncoding(
            enc, ctypes.byref(color)
        ) != _ENC_SUCCESS:
            raise RuntimeError("JxlEncoderSetColorEncoding failed")

        opts = lib.JxlEncoderFrameSettingsCreate(enc, None)
        lib.JxlEncoderFrameSettingsSetOption(
            opts, _FRAME_SETTING_EFFORT, int(effort)
        )
        if lossless or distance == 0:
            lib.JxlEncoderSetFrameLossless(opts, 1)
            lib.JxlEncoderSetFrameDistance(opts, 0.0)
        else:
            lib.JxlEncoderSetFrameDistance(opts, float(distance))

        for frame in frames:
            frame = np.ascontiguousarray(frame)
            if frames.shape[0] > 1:
                # Frames default to duration 0, which marks them as
                # composited layers of ONE displayed frame — the
                # decoder would coalesce the stack. duration=1 makes
                # each slice its own keyframe.
                hdr = _JxlFrameHeader()
                lib.JxlEncoderInitFrameHeader(ctypes.byref(hdr))
                hdr.duration = 1
                if lib.JxlEncoderSetFrameHeader(
                    opts, ctypes.byref(hdr)
                ) != _ENC_SUCCESS:
                    raise RuntimeError("JxlEncoderSetFrameHeader failed")
            if lib.JxlEncoderAddImageFrame(
                opts, ctypes.byref(fmt),
                frame.ctypes.data_as(ctypes.c_void_p), frame.nbytes,
            ) != _ENC_SUCCESS:
                raise RuntimeError("JxlEncoderAddImageFrame failed")
        lib.JxlEncoderCloseInput(enc)

        chunks = []
        buf = (ctypes.c_uint8 * (1 << 20))()
        while True:
            next_out = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
            avail = ctypes.c_size_t(len(buf))
            status = lib.JxlEncoderProcessOutput(
                enc, ctypes.byref(next_out), ctypes.byref(avail)
            )
            produced = len(buf) - avail.value
            chunks.append(bytes(bytearray(buf)[:produced]))
            if status == _ENC_SUCCESS:
                break
            if status != _ENC_NEED_MORE_OUTPUT:
                raise RuntimeError(f"JxlEncoderProcessOutput status {status}")
        return b"".join(chunks)
    finally:
        lib.JxlEncoderDestroy(enc)


def jxl_decode(data, dtype=np.uint16):
    """Decode a JPEG-XL codestream to a grayscale array of ``dtype``.

    Single-frame streams return 2D (y, x); multiframe (animation)
    streams — e.g. 3D zarr chunks encoded frame-per-slice — return the
    stacked 3D (frames, y, x) array."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"libjxl is not available: {unavailable_reason()}")
    fmt = _pixel_format(np.dtype(dtype))

    dec = lib.JxlDecoderCreate(None)
    try:
        if lib.JxlDecoderSubscribeEvents(
            dec, _DEC_BASIC_INFO | _DEC_FULL_IMAGE
        ) != _DEC_SUCCESS:
            raise RuntimeError("JxlDecoderSubscribeEvents failed")
        raw = ctypes.create_string_buffer(data, len(data))
        lib.JxlDecoderSetInput(dec, raw, len(data))
        lib.JxlDecoderCloseInput(dec)

        outs = []
        shape = None
        while True:
            status = lib.JxlDecoderProcessInput(dec)
            if status == _DEC_BASIC_INFO:
                info = _JxlBasicInfo()
                if lib.JxlDecoderGetBasicInfo(
                    dec, ctypes.byref(info)
                ) != _DEC_SUCCESS:
                    raise RuntimeError("JxlDecoderGetBasicInfo failed")
                shape = (info.ysize, info.xsize)
            elif status == _DEC_NEED_IMAGE_OUT_BUFFER:
                outs.append(np.empty(shape, dtype))
                if lib.JxlDecoderSetImageOutBuffer(
                    dec, ctypes.byref(fmt),
                    outs[-1].ctypes.data_as(ctypes.c_void_p),
                    outs[-1].nbytes,
                ) != _DEC_SUCCESS:
                    raise RuntimeError("JxlDecoderSetImageOutBuffer failed")
            elif status == _DEC_FULL_IMAGE:
                continue
            elif status == _DEC_SUCCESS:
                if not outs:
                    raise RuntimeError("decode finished without image data")
                return outs[0] if len(outs) == 1 else np.stack(outs)
            else:
                raise RuntimeError(f"JxlDecoderProcessInput status {status}")
    finally:
        lib.JxlDecoderDestroy(dec)


class JxlSliceCodec:
    """uint16-faithful JPEG-XL codec over 2D slices (stateless).

    The payload embeds a 1-byte dtype tag so ``decode`` is independent of
    encoder state — safe under the thread pools in
    :func:`~exaspim_tpu_torch.compression.cratio.compute_cratio_2d`.
    """

    _TAGS = {np.dtype(np.uint8): b"\x01", np.dtype(np.uint16): b"\x02"}
    _DTYPES = {1: np.uint8, 2: np.uint16}

    def __init__(self, distance=1.0, effort=3, lossless=False):
        self.distance = float(distance)
        self.effort = int(effort)
        self.lossless = bool(lossless)
        self.config = {
            "id": "jpegxl",
            "distance": self.distance,
            "effort": self.effort,
            "lossless": self.lossless,
        }

    def encode(self, sl):
        sl = np.asarray(sl)
        return self._TAGS[sl.dtype] + jxl_encode(
            sl, distance=self.distance, effort=self.effort,
            lossless=self.lossless,
        )

    def decode(self, data):
        return jxl_decode(data[1:], dtype=self._DTYPES[data[0]])
