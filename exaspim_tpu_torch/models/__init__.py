"""3D U-Net denoisers (BM4DNet, Noise2Void2) in PyTorch."""

from exaspim_tpu_torch.models.unet3d import (
    MODEL_REGISTRY,
    N2V2UNet,
    UNet,
    build_model,
)

__all__ = ["UNet", "N2V2UNet", "build_model", "MODEL_REGISTRY"]
