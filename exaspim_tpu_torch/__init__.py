"""exaspim_tpu_torch: the PyTorch / CUDA (Hopper) port of exaspim_tpu.

BM4D teacher generation, BM4DNet training and tiled denoising of uint16
light-sheet volumes. Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``; on the card the 3³ convs, the
BM4D block matching and the byte histogram run the hand-written kernels in
``csrc/``. Importing the package builds nothing and touches no device.
"""

__all__ = ["bm4d"]


def __getattr__(name):
    """Lazy top-level export, so ``import exaspim_tpu_torch`` stays light."""
    if name == "bm4d":
        from exaspim_tpu_torch.ops.bm4d import bm4d

        return bm4d
    raise AttributeError(
        f"module 'exaspim_tpu_torch' has no attribute {name!r}")
