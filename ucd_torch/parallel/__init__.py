"""Data parallelism of the port: the process group, the step's collectives
and the 1-D data axis (counterpart of ucd_tpu/parallel, its data axis)."""

from .collectives import (
    all_reduce_mean_,
    all_reduce_sum_,
    barrier,
    broadcast_,
    gather_rows,
    is_distributed,
    rank,
    reduce_metrics,
    world_size,
)
from .distributed import (
    init_group,
    local_batch_size,
    maybe_initialize,
    process_device,
    shutdown,
)
from .mesh import DATA_AXIS, DataMesh, make_mesh_multiprocess, shard_batch

__all__ = ["DATA_AXIS", "DataMesh", "all_reduce_mean_", "all_reduce_sum_",
           "barrier", "broadcast_", "gather_rows", "init_group",
           "is_distributed", "local_batch_size", "make_mesh_multiprocess",
           "maybe_initialize", "process_device", "rank", "reduce_metrics",
           "shard_batch", "shutdown", "world_size"]
