"""Device-side compute of the port: filters, SSIM, metrics, BM4D, and the
hand-written kernels' wrappers (``nb_conv``, ``bm4d_match``,
``elementwise``, ``blocked_conv``). Importing builds no kernel."""

from exaspim_tpu_torch.ops.bm4d import bm4d, bm4d_stage
from exaspim_tpu_torch.ops.filters import (
    binary_dilation,
    gaussian_filter,
    separable_filter,
    uniform_filter,
)
from exaspim_tpu_torch.ops.metrics import (
    DEFAULT_CHECKPOINT_WEIGHTS,
    checkpoint_score,
    evaluate_example,
    false_bright_rate,
    foreground_background_mae,
    highfreq_energy_fraction,
    local_autocorr,
    make_foreground_mask,
    make_segmentation_mask,
    make_skeleton_mask,
    mip_max_error,
    patch_has_incoherent_segment,
)
from exaspim_tpu_torch.ops.ssim import compute_lmax, compute_mae, psnr, ssim3d

__all__ = [
    "DEFAULT_CHECKPOINT_WEIGHTS",
    "binary_dilation",
    "bm4d",
    "bm4d_stage",
    "checkpoint_score",
    "compute_lmax",
    "compute_mae",
    "evaluate_example",
    "false_bright_rate",
    "foreground_background_mae",
    "gaussian_filter",
    "highfreq_energy_fraction",
    "local_autocorr",
    "make_foreground_mask",
    "make_segmentation_mask",
    "make_skeleton_mask",
    "mip_max_error",
    "patch_has_incoherent_segment",
    "psnr",
    "separable_filter",
    "ssim3d",
    "uniform_filter",
]
