"""exaspim_tpu_torch: the PyTorch / CUDA (Hopper) port of exaspim_tpu.

BM4D teacher generation, BM4DNet training (against BM4D teachers, or
self-supervised with Noise2Void), tiled denoising of uint16 light-sheet
volumes, scored by their blosc-zstd compression ratio, and the import of
the upstream reference's torch checkpoints. Entry
points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on the card the 3³ convs, the BM4D block matching and
the byte histogram run the hand-written kernels in ``csrc/``. The whole
system, end to end: ``python -m exaspim_tpu_torch.demo_end_to_end``.

Layers, as in the JAX package: ``transforms``, ``ops``, ``models``,
``losses``, ``compression``, ``inference``, ``pipeline``, ``data``,
``train``, ``utils``. The top-level names below are imported on first
use, so ``import exaspim_tpu_torch`` stays light: it builds nothing and
touches no device.
"""

__version__ = "0.1.0"

_LAZY = {
    "predict": "exaspim_tpu_torch.inference",
    "predict_patch": "exaspim_tpu_torch.inference",
    "denoise_volume": "exaspim_tpu_torch.pipeline",
    "Trainer": "exaspim_tpu_torch.train.trainer",
    "build_transform": "exaspim_tpu_torch.transforms",
    "bm4d": "exaspim_tpu_torch.ops.bm4d",
    "UNet": "exaspim_tpu_torch.models",
    "N2V2UNet": "exaspim_tpu_torch.models",
    "compute_cratio": "exaspim_tpu_torch.compression",
    "ssim3d": "exaspim_tpu_torch.ops.ssim",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    """Lazy top-level API: ``exaspim_tpu_torch.predict``, ``.Trainer``, …"""
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'exaspim_tpu_torch' has no attribute {name!r}")
