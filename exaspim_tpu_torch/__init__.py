"""exaspim_tpu_torch: the PyTorch / CUDA (Hopper) port of exaspim_tpu.

Tiled BM4DNet denoising of uint16 light-sheet volumes with the shipped
checkpoint. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; on the card every 3³ conv runs the
hand-written kernel in ``csrc/nb_conv3d.cu``. Importing the package builds
nothing and touches no device.
"""
