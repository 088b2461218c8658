"""3D denoisers in PyTorch: the U-Nets (BM4DNet, Noise2Void2) and
3D-RCAN."""

from exaspim_tpu_torch.models.rcan3d import RCAN3D
from exaspim_tpu_torch.models.unet3d import (
    MODEL_REGISTRY,
    N2V2UNet,
    UNet,
    build_model,
)

__all__ = ["UNet", "N2V2UNet", "RCAN3D", "build_model", "MODEL_REGISTRY"]

# The registry and ``build_model`` stay in ``unet3d``, where the JAX
# package has them; 3D-RCAN, built on unet3d's ``Conv3``, joins them here.
MODEL_REGISTRY["RCAN3D"] = RCAN3D
