"""Device-side compressibility proxy for in-loop cratio estimates.

Counterpart of ``exaspim_tpu/compression/proxy.py``: the estimated
compressed size of a uint16 chunk is the order-0 entropy of its two byte
planes after a z-axis delta (blosc's shuffle + zstd's decorrelation),
``Σ_planes H₀(plane) · n``, and the ratio is raw bits over the summed
estimates of a volume's chunks.

Counts live in int32 tensors holding values 0..65535 (torch has no uint16
arithmetic); the wrap-around z-delta is taken in int32 and masked with
``0xFFFF``, which keeps the same bytes as the reference's uint16 cast.

The 256-bin byte histogram is the kernel: on a CUDA tensor
:func:`byte_histogram` launches ``csrc/byte_histogram.cu`` (one launch for
all rows) or raises; on a CPU tensor it runs :func:`byte_histogram_plain`.
:func:`cratio_proxy_batch` histograms every chunk and plane of a batch of
volumes in one launch.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "cratio_proxy",
    "cratio_proxy_batch",
    "chunk_entropy_bits",
    "byte_histogram",
    "byte_histogram_plain",
]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_MAX_ROWS = 65535


def _byte_planes(chunks):
    """int32 counts ``(..., Z, Y, X)`` → (lo, hi) uint8 planes after the
    delta along Z (the first value kept as is)."""
    d = torch.cat([chunks[..., :1, :, :], torch.diff(chunks, dim=-3)], dim=-3)
    d = d & 0xFFFF  # two's-complement wrap, as the reference's uint16 cast
    return (d & 0xFF).to(torch.uint8), (d >> 8).to(torch.uint8)


def byte_histogram_plain(rows_u8):
    """Plain PyTorch version: ``(n, L)`` uint8 → f32 ``(n, 256)`` counts,
    one ``torch.bincount`` per row."""
    return torch.stack([
        torch.bincount(r.to(torch.int64), minlength=256) for r in rows_u8
    ]).to(torch.float32)


def _launch(rows_u8):
    from exaspim_tpu_torch.ops._build import load_library

    n, length = rows_u8.shape
    if n > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows per launch, got {n}")
    if rows_u8.data_ptr() % 16:
        rows_u8 = rows_u8.clone()  # a fresh allocation is 16-byte aligned
    counts = torch.empty((n, 256), dtype=torch.int32, device=rows_u8.device)
    out = torch.empty((n, 256), dtype=torch.float32, device=rows_u8.device)
    fn = load_library("byte_histogram").byte_histogram_u8
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(rows_u8.device):
        stream = torch.cuda.current_stream(rows_u8.device).cuda_stream
        rc = fn(rows_u8.data_ptr(), n, length, counts.data_ptr(),
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"byte_histogram kernel launch failed: cudaError {rc}")
    byte_histogram.launches += 1
    return out


def byte_histogram(rows_u8):
    """256-bin histograms of the rows of a ``(n, L)`` uint8 tensor → f32
    ``(n, 256)``. CUDA tensors go through ``csrc/byte_histogram.cu`` and
    count one launch in ``byte_histogram.launches``; CPU tensors go
    through :func:`byte_histogram_plain`."""
    if rows_u8.dtype != torch.uint8 or rows_u8.dim() != 2:
        raise ValueError(f"expected (n, L) uint8, got {rows_u8.dtype} "
                         f"{tuple(rows_u8.shape)}")
    rows_u8 = rows_u8.contiguous()
    if rows_u8.device.type == "cpu":
        return byte_histogram_plain(rows_u8)
    if rows_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {rows_u8.device}")
    return _launch(rows_u8)


byte_histogram.launches = 0


def _entropy_bits(counts):
    """Σ over bins of −p·log₂p, times n, per row of f32 counts."""
    n = counts.sum(dim=-1, keepdim=True)
    p = counts / torch.clamp(n, min=1.0)
    h = -torch.where(p > 0, p * torch.log2(p), torch.zeros_like(p)).sum(-1)
    return h * n[..., 0]


def chunk_entropy_bits(chunk):
    """Estimated compressed size (bits) of one ``(Z, Y, X)`` int32 chunk."""
    lo, hi = _byte_planes(chunk)
    counts = byte_histogram(torch.stack([lo.reshape(-1), hi.reshape(-1)]))
    return _entropy_bits(counts).sum()


def _chunks(vols, chunk):
    """``(B, Z, Y, X)`` → ``(B, n_chunks, c, c, c)``, the reference's
    chunk walk (trailing partial chunks dropped, chunk shrunk to fit)."""
    b, z, y, x = vols.shape
    chunk = min(chunk, z, y, x)
    nz, ny, nx = (max(s // chunk, 1) for s in (z, y, x))
    v = vols[:, :nz * chunk, :ny * chunk, :nx * chunk]
    return (v.reshape(b, nz, chunk, ny, chunk, nx, chunk)
            .permute(0, 1, 3, 5, 2, 4, 6)
            .reshape(b, nz * ny * nx, chunk, chunk, chunk))


def cratio_proxy_batch(vols, chunk=64):
    """Proxy ratio of each volume of a ``(B, Z, Y, X)`` batch of counts
    (any integer dtype holding 0..65535) → f32 ``(B,)``. One histogram
    launch covers every chunk and byte plane of the batch."""
    vols = vols.to(torch.int32)
    ch = _chunks(vols, chunk)
    b, nc = ch.shape[:2]
    lo, hi = _byte_planes(ch)
    rows = torch.stack([lo, hi], dim=2).reshape(b * nc * 2, -1)
    bits = _entropy_bits(byte_histogram(rows)).reshape(b, nc * 2)
    raw_bits = float(ch[0].numel() * 16)
    return raw_bits / torch.clamp(bits.sum(dim=1), min=1.0)


def cratio_proxy(img, chunk=64):
    """Proxy ratio of one ``(Z, Y, X)`` volume of counts (0-dim f32)."""
    return cratio_proxy_batch(img[None], chunk)[0]
