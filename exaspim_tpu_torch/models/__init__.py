"""Residual 3D U-Net denoisers (BM4DNet) in PyTorch."""

from exaspim_tpu_torch.models.unet3d import MODEL_REGISTRY, UNet, build_model

__all__ = ["UNet", "build_model", "MODEL_REGISTRY"]
