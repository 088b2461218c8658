"""The 3³ convs of ``N2V2UNet``: the U-Net's, but its last ``Up`` has no
top skip (see ``UNet.py``)."""

from __future__ import annotations

from benchmark.counts.UNet import BASE, unet_conv_shapes


def conv_shapes(n, model_config):
    return unet_conv_shapes(
        n, float(model_config.get("width_multiplier", 1.0)),
        tuple(model_config.get("base_channels", BASE)), top_skip=False)
