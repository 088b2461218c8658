"""Device-side compressibility proxy for in-loop cratio estimates.

Counterpart of ``exaspim_tpu/compression/proxy.py``: the estimated
compressed size of a uint16 chunk is the order-0 entropy of its two byte
planes after a z-axis delta (blosc's shuffle + zstd's decorrelation),
``Σ_planes H₀(plane) · n``, and the ratio is raw bits over the summed
estimates of a volume's chunks.

Counts live in int32 tensors holding values 0..65535 (torch has no uint16
arithmetic); the wrap-around z-delta is taken in int32 and masked with
``0xFFFF``, which keeps the same bytes as the reference's uint16 cast.

The 256-bin byte histogram is the kernel (``csrc/byte_histogram.cu``), in
two entries: :func:`byte_histogram` counts the rows of a uint8 tensor, and
:func:`chunk_byte_histograms` takes the lo and hi byte planes of every
chunk's z-delta from a batch of count volumes itself, so no plane is built
in memory. On a CUDA tensor each launches its kernel once (or raises); on
a CPU tensor each runs its plain version. :func:`cratio_proxy_batch` makes
one launch for every chunk and plane of a batch.
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
    "chunk_byte_histograms",
    "chunk_byte_histograms_plain",
]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "byte_histogram_rows": [_P, _LL, _LL, _P, _P],
    "byte_histogram_chunks": [_P, _LL, _I, _I, _I, _I, _P, _P],
}
_bound = {}


def _entry(name):
    """The C entry ``name`` of the kernel's library, bound once."""
    fn = _bound.get(name)
    if fn is None:
        from exaspim_tpu_torch.ops._build import load_library

        fn = getattr(load_library("byte_histogram"), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


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


def _stream(t):
    # The raw handle, as Triton's launcher takes it: a fraction of the host
    # time of building a torch.cuda.Stream object on every call.
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _check_rc(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _launch_rows(rows_u8):
    n, length = rows_u8.shape
    out = torch.empty((n, 256), dtype=torch.float32, device=rows_u8.device)
    if n == 0:
        return out
    with torch.cuda.device(rows_u8.device):
        rc = _entry("byte_histogram_rows")(
            rows_u8.data_ptr(), n, length, out.data_ptr(), _stream(rows_u8))
    _check_rc(rc, "byte_histogram")
    byte_histogram.launches += 1
    return out


def byte_histogram(rows_u8):
    """256-bin histograms of the rows of a ``(n, L)`` uint8 tensor → f32
    ``(n, 256)``. CUDA tensors go through ``csrc/byte_histogram.cu`` (one
    launch, any n, any L, any base address) and count it in
    ``byte_histogram.launches``; CPU tensors go through
    :func:`byte_histogram_plain`."""
    if rows_u8.dtype != torch.uint8 or rows_u8.dim() != 2:
        raise ValueError(f"expected (n, L) uint8, got {rows_u8.dtype} "
                         f"{tuple(rows_u8.shape)}")
    rows_u8 = rows_u8.contiguous()
    if rows_u8.device.type == "cpu":
        return byte_histogram_plain(rows_u8)
    if rows_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {rows_u8.device}")
    return _launch_rows(rows_u8)


byte_histogram.launches = 0


def _chunk_grid(shape, chunk):
    """The reference's chunk walk over ``(Z, Y, X)``: the chunk shrunk to
    fit the smallest extent, and the number of whole chunks along each
    axis (trailing partial chunks dropped)."""
    chunk = min(chunk, *shape)
    return chunk, tuple(s // chunk for s in shape)


def _chunks(vols, chunk):
    """``(B, Z, Y, X)`` → ``(B, n_chunks, c, c, c)``, the reference's
    chunk walk (trailing partial chunks dropped, chunk shrunk to fit)."""
    b = vols.shape[0]
    chunk, (nz, ny, nx) = _chunk_grid(vols.shape[1:], chunk)
    v = vols[:, :nz * chunk, :ny * chunk, :nx * chunk]
    return (v.reshape(b, nz, chunk, ny, chunk, nx, chunk)
            .permute(0, 1, 3, 5, 2, 4, 6)
            .reshape(b, nz * ny * nx, chunk, chunk, chunk))


def chunk_byte_histograms_plain(vols, chunk=64):
    """Plain version of :func:`chunk_byte_histograms`: the chunks copied
    out, their byte planes built, one ``torch.bincount`` per plane."""
    ch = _chunks(vols, chunk)
    b, nc = ch.shape[:2]
    lo, hi = _byte_planes(ch)
    rows = torch.stack([lo, hi], dim=2).reshape(b * nc * 2, -1)
    return byte_histogram_plain(rows).reshape(b, nc, 2, 256)


def _launch_chunks(vols, chunk):
    b, z, y, x = vols.shape
    chunk, grid = _chunk_grid((z, y, x), chunk)
    nc = grid[0] * grid[1] * grid[2]
    out = torch.empty((b, nc, 2, 256), dtype=torch.float32,
                      device=vols.device)
    if b == 0:
        return out
    with torch.cuda.device(vols.device):
        rc = _entry("byte_histogram_chunks")(
            vols.data_ptr(), b, z, y, x, chunk, out.data_ptr(), _stream(vols))
    _check_rc(rc, "chunk_byte_histograms")
    chunk_byte_histograms.launches += 1
    return out


def chunk_byte_histograms(vols, chunk=64):
    """Lo and hi byte histograms of the z-delta (uint16 wrap, each chunk's
    first plane kept as is) of every chunk of a ``(B, Z, Y, X)`` int32
    batch of counts → f32 ``(B, n_chunks, 2, 256)``, chunks in (z, y, x)
    order as :func:`_chunks` walks them. CUDA tensors go through
    ``csrc/byte_histogram.cu`` (one launch, read from the volumes
    themselves) and count it in ``chunk_byte_histograms.launches``; CPU
    tensors go through :func:`chunk_byte_histograms_plain`."""
    if vols.dtype != torch.int32 or vols.dim() != 4:
        raise ValueError(f"expected (B, Z, Y, X) int32, got {vols.dtype} "
                         f"{tuple(vols.shape)}")
    if min(vols.shape[1:]) < 1 or chunk < 1:
        raise ValueError(f"no chunk of {chunk} in {tuple(vols.shape)}")
    vols = vols.contiguous()
    if vols.device.type == "cpu":
        return chunk_byte_histograms_plain(vols, chunk)
    if vols.device.type != "cuda":
        raise ValueError(f"unsupported device {vols.device}")
    return _launch_chunks(vols, chunk)


chunk_byte_histograms.launches = 0


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


def cratio_proxy_batch(vols, chunk=64):
    """Proxy ratio of each volume of a ``(B, Z, Y, X)`` batch of counts
    (any integer dtype holding 0..65535) → f32 ``(B,)``. One histogram
    launch covers every chunk and byte plane of the batch."""
    vols = vols.to(torch.int32)
    counts = chunk_byte_histograms(vols, chunk)
    bits = _entropy_bits(counts).reshape(counts.shape[0], -1)
    c, (nz, ny, nx) = _chunk_grid(vols.shape[1:], chunk)
    raw_bits = float(nz * ny * nx * c ** 3 * 16)
    return raw_bits / torch.clamp(bits.sum(dim=1), min=1.0)


def cratio_proxy(img, chunk=64):
    """Proxy ratio of one ``(Z, Y, X)`` volume of counts (0-dim f32)."""
    return cratio_proxy_batch(img[None], chunk)[0]
