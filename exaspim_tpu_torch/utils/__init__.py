"""Host utilities: image IO for local stores (Zarr / N5 / TIFF readers,
Zarr v3 and OME-Zarr writers), plots and step timing."""

from exaspim_tpu_torch.utils.img_io import (
    as_5d,
    downsample_windowed_mean,
    get_ome_zarr_level_transform,
    get_patch,
    get_slices,
    get_start_end,
    ome_zarr_coordinate_to_voxel,
    read,
    write_ome_zarr,
    write_zarr,
)

__all__ = [
    "as_5d",
    "downsample_windowed_mean",
    "get_ome_zarr_level_transform",
    "get_patch",
    "get_slices",
    "get_start_end",
    "ome_zarr_coordinate_to_voxel",
    "read",
    "write_ome_zarr",
    "write_zarr",
]
