"""Data layer: the patch-cache contract (raw/teacher/fg ``.npy`` +
``transform.json``, the JAX package's files), the data loader and the
synthetic phantoms. Live sampling over whole-brain volumes lives in
:mod:`exaspim_tpu_torch.data.live`."""

from exaspim_tpu_torch.data.cache import (
    CACHE_FILES,
    CachedPatchDataset,
    CachedValidateDataset,
    allocate_cache,
    load_cache_transform,
    write_cache,
)
from exaspim_tpu_torch.data.loader import (
    DataLoader,
    make_count_train_collate,
    make_count_val_collate,
    make_train_collate,
    make_val_collate,
    prefetch_to_device,
)
from exaspim_tpu_torch.data.synthetic import (
    SyntheticPatchDataset,
    make_synthetic_cache,
    neurite_phantom,
    noisy_observation,
)

__all__ = [
    "CACHE_FILES",
    "CachedPatchDataset",
    "CachedValidateDataset",
    "DataLoader",
    "SyntheticPatchDataset",
    "allocate_cache",
    "load_cache_transform",
    "make_synthetic_cache",
    "make_count_train_collate",
    "make_count_val_collate",
    "make_train_collate",
    "make_val_collate",
    "neurite_phantom",
    "noisy_observation",
    "prefetch_to_device",
    "write_cache",
]
