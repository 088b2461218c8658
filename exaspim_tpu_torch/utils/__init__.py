"""Host utilities: image IO (Zarr / N5 / neuroglancer precomputed / TIFF
readers on local paths and cloud URLs, Zarr v3 and OME-Zarr writers), SWC
parsing, filesystem and cloud bookkeeping, plots, step timing and
profiling."""

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
from exaspim_tpu_torch.utils import cloud
from exaspim_tpu_torch.utils.swc import ANISOTROPY, Reader, to_voxels
from exaspim_tpu_torch.utils.util import (
    is_cloud_path,
    list_cloud_paths,
    list_dir,
    list_paths,
    mkdir,
    parse_cloud_path,
    read_json,
    read_txt,
    rmdir,
    write_json,
    write_txt,
)

__all__ = [
    "ANISOTROPY",
    "Reader",
    "as_5d",
    "cloud",
    "downsample_windowed_mean",
    "get_ome_zarr_level_transform",
    "get_patch",
    "get_slices",
    "get_start_end",
    "is_cloud_path",
    "list_cloud_paths",
    "list_dir",
    "list_paths",
    "mkdir",
    "ome_zarr_coordinate_to_voxel",
    "parse_cloud_path",
    "read",
    "read_json",
    "read_txt",
    "rmdir",
    "to_voxels",
    "write_json",
    "write_ome_zarr",
    "write_txt",
    "write_zarr",
]
