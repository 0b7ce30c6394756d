"""The 1-D data axis.

Counterpart of the data-parallel part of ucd_tpu/parallel/mesh.py. The
JAX package lays a mesh over devices and shards the batch's leading axis
over its `data` axis; the port runs one process a device, so the data
axis is the process group and a process's shard of the batch is its
contiguous slice, in rank order (what `jax.make_array_from_process_local_data`
assembles from each process's rows). The 2-D data x model mesh
(`make_mesh_2d`, `make_mesh_2d_hybrid`, `channel_sharding`) is not ported
yet (ROADMAP A6b): it means something only across several cards. The
config's `data_axis` is accepted and ignored, as in the JAX package.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

from . import collectives as C
from .distributed import local_batch_size

DATA_AXIS = "data"


class DataMesh(NamedTuple):
    """The data axis: `size` processes, this one at `rank`."""
    size: int
    rank: int
    axis_name: str = DATA_AXIS


def make_mesh_multiprocess(global_batch: int) -> DataMesh:
    """The data axis over every process of the group (one process without
    one). A process holds one device, so the JAX function's trimming of
    local devices leaves one a process and its divisibility rule becomes
    `global_batch % size == 0`: an indivisible batch raises here, before
    the first step."""
    size = C.world_size()
    local_batch_size(global_batch, size)
    return DataMesh(size, C.rank())


def shard_batch(batch: Mapping, rank: Optional[int] = None,
                size: Optional[int] = None) -> dict:
    """Process `rank`'s contiguous slice of a global batch (each array's
    leading axis split into `size` equal parts; this process's place in
    the group by default)."""
    rank = C.rank() if rank is None else rank
    size = C.world_size() if size is None else size
    out = {}
    for k, v in batch.items():
        n = local_batch_size(v.shape[0], size)
        out[k] = v[rank * n:(rank + 1) * n]
    return out
