"""Parallelism of the port: the process group, the step's collectives,
the 1-D data axis and the 2-D data x model mesh (counterpart of
ucd_tpu/parallel)."""

from .collectives import (
    all_reduce_max_,
    all_reduce_mean_,
    all_reduce_sum_,
    barrier,
    broadcast_,
    copy_to_model,
    gather_from_model,
    gather_rows,
    is_distributed,
    rank,
    reduce_metrics,
    scatter_to_model,
    tally,
    world_size,
)
from .distributed import (
    init_group,
    local_batch_size,
    maybe_initialize,
    process_device,
    shutdown,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    DataMesh,
    Mesh2D,
    channel_sharding,
    make_mesh_2d,
    make_mesh_2d_hybrid,
    make_mesh_multiprocess,
    shard_batch,
)

__all__ = ["DATA_AXIS", "DataMesh", "MODEL_AXIS", "Mesh2D",
           "all_reduce_max_", "all_reduce_mean_", "all_reduce_sum_",
           "barrier", "broadcast_",
           "channel_sharding", "copy_to_model", "gather_from_model",
           "gather_rows", "init_group", "is_distributed", "local_batch_size",
           "make_mesh_2d", "make_mesh_2d_hybrid", "make_mesh_multiprocess",
           "maybe_initialize", "process_device", "rank", "reduce_metrics",
           "scatter_to_model", "shard_batch", "shutdown", "tally",
           "world_size"]
