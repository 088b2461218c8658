"""Multi-GPU over ``torch.distributed``: meshes, data-parallel training,
z-sharded inference and BM4D with halo exchange (one process per
device; NCCL on the card, gloo on the CPU)."""

from exaspim_tpu_torch.parallel.bm4d_sharded import bm4d_halo, bm4d_sharded
from exaspim_tpu_torch.parallel.data_parallel import (
    make_dp_train_step,
    shard_batch,
)
from exaspim_tpu_torch.parallel.mesh import (
    make_mesh,
    replicated,
    sharded_along,
)
from exaspim_tpu_torch.parallel.multihost import (
    initialize_multihost,
    is_primary,
)
from exaspim_tpu_torch.parallel.spatial import plan_shards, predict_sharded

__all__ = [
    "bm4d_halo",
    "bm4d_sharded",
    "initialize_multihost",
    "is_primary",
    "make_dp_train_step",
    "make_mesh",
    "plan_shards",
    "predict_sharded",
    "replicated",
    "shard_batch",
    "sharded_along",
]
