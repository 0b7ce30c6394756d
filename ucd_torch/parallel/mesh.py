"""The 1-D data axis and the 2-D data x model mesh.

Counterpart of ucd_tpu/parallel/mesh.py. The JAX package lays a mesh over
devices; the port runs one process a device, so a mesh of devices is a
mesh of ranks.

The data axis: the batch's leading axis is sharded over it, and a
process's shard of the batch is its contiguous slice, in rank order (what
`jax.make_array_from_process_local_data` assembles from each process's
rows). Without a 2-D mesh the data axis is the whole process group.

The 2-D mesh (`make_mesh_2d`, `make_mesh_2d_hybrid`): `n_data x n_model`
ranks laid out row-major, as `np.array(devices).reshape(n_data, n_model)`
lays out the JAX mesh. Each row is a model group of `n_model` consecutive
ranks (in the mesh's order), each column a data group. The batch is
sharded over the data groups; `channel_sharding` picks the wide tensors
whose output channels are sharded over the model group (the JAX rule, on
the port's OIHW / per-channel layouts), and the model's forward carries
the model axis itself (models/resnet.py, models/deeplab.py): the JAX
package runs its unchanged step under GSPMD, which inserts those
collectives. The CLI and `Experiment` build no 2-D mesh, as in the JAX
package, and the config's `data_axis` is accepted and ignored there too.
"""

from __future__ import annotations

import os
import socket
import types
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence

import numpy as np

from . import collectives as C
from .distributed import local_batch_size

DATA_AXIS = "data"
MODEL_AXIS = "model"


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


class Mesh2D(NamedTuple):
    """This rank's place on the 2-D (data x model) mesh: its row
    (`data_index`, the data shard it takes) and column (`model_index`, the
    channel shard it holds), the process groups of its column
    (`data_group`: the ranks that hold the same shards) and its row
    (`model_group`: the ranks that share one data shard), and the world
    ranks in mesh order (`order`, row-major)."""
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any
    order: tuple


def _mesh_from_order(order: Sequence[int], n_model: int) -> Mesh2D:
    """The mesh whose rows are consecutive `n_model` runs of `order`. Every
    rank creates every subgroup, in the same order (torch.distributed's
    rule for `new_group`)."""
    import torch.distributed as dist

    order = tuple(int(r) for r in order)
    grid = np.array(order).reshape(-1, n_model)
    me = C.rank()
    data_group = model_group = None
    for row in grid:
        g = dist.new_group([int(r) for r in row])
        if me in row:
            model_group = g
    for col in grid.T:
        g = dist.new_group([int(r) for r in col])
        if me in col:
            data_group = g
    C.name_group(data_group, DATA_AXIS)
    C.name_group(model_group, MODEL_AXIS)
    (i,), (j,) = np.nonzero(grid == me)
    return Mesh2D(grid.shape[0], n_model, int(i), int(j), data_group,
                  model_group, order)


def make_mesh_2d(n_data: int, n_model: int) -> Mesh2D:
    """2-D (data x model) mesh over the `n_data * n_model` ranks of the
    process group: rank r sits at (r // n_model, r % n_model). A world of
    another size raises (the JAX function asserts that it has the
    devices)."""
    world = C.world_size()
    if not C.is_distributed() or world != n_data * n_model:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks, the process group has "
                         f"{world if C.is_distributed() else 0}")
    return _mesh_from_order(range(world), n_model)


def _domain_key(record, all_tpu: bool):
    """The interconnect domain a rank (or device) record belongs to: its
    `slice_index` where it has one; one domain for a TPU pod without it
    (its ICI spans the hosts); else its node (`node`, or `process_index`
    on a device record of the JAX package)."""
    s = getattr(record, "slice_index", None)
    if s is not None:
        return s
    if all_tpu:
        return 0
    node = getattr(record, "node", None)
    return getattr(record, "process_index", 0) if node is None else node


def _hybrid_device_order(records, n_model: int) -> list:
    """The JAX package's ordering rule: `records` (one a rank, with `id`
    and `node`, or `slice_index`) grouped by interconnect domain, the
    domains in sorted order, so that each consecutive `n_model`-sized
    model group lives in ONE domain: the model axis's per-layer
    collectives ride NVLink, and only the data axis's once-a-step gradient
    all-reduce crosses nodes. A domain whose size `n_model` does not
    divide raises: a model group would straddle two nodes.

    The GPU node takes the place of the TPU's ICI domain. The JAX
    package's `_ici_order` walks the TPU torus within a domain; GPUs of a
    node are all-to-all over NVLink, so the ranks keep their order within
    it."""
    all_tpu = bool(records) and all(
        getattr(d, "platform", "") == "tpu" for d in records)
    groups: dict = {}
    for d in records:
        groups.setdefault(_domain_key(d, all_tpu), []).append(d)
    for k, g in groups.items():
        if len(g) % n_model != 0:
            raise ValueError(
                f"hybrid mesh: node/slice {k} has {len(g)} ranks, not a "
                f"multiple of n_model={n_model}; the model axis cannot stay "
                f"within one NVLink domain")
    return [d for k in sorted(groups) for d in groups[k]]


def _rank_records() -> list:
    """One record a rank of the process group, in rank order: `id` (the
    rank) and `node` (torchrun's GROUP_RANK where set, else the host
    name), gathered once."""
    import torch.distributed as dist

    node = os.environ.get("GROUP_RANK") or socket.gethostname()
    nodes = [None] * C.world_size()
    dist.all_gather_object(nodes, node)
    return [types.SimpleNamespace(id=r, node=n) for r, n in enumerate(nodes)]


def make_mesh_2d_hybrid(n_model: int, ranks=None) -> Mesh2D:
    """2-D (data x model) mesh for several nodes: the ranks ordered by
    `_hybrid_device_order`, so that each model group stays within one
    node while the data axis spans nodes. `ranks` are the records to
    order (default: each rank's, `_rank_records`); a count that `n_model`
    does not divide raises. On one node this is `make_mesh_2d(n //
    n_model, n_model)`."""
    n = C.world_size() if ranks is None else len(ranks)
    if n_model < 1 or n % n_model != 0:
        raise ValueError(
            f"n_model={n_model} must divide the rank count {n}")
    records = _rank_records() if ranks is None else list(ranks)
    order = [d.id for d in _hybrid_device_order(records, n_model)]
    return _mesh_from_order(order, n_model)


def channel_sharding(n_model: int, named_tensors: Mapping[str, Any],
                     min_size: int = 256) -> Dict[str, Optional[int]]:
    """name -> the dim sharded over the model axis (0), or None where the
    tensor stays replicated: the JAX package's rule, a tensor's
    output-channel dim is sharded where it is >= `min_size` and divisible
    by `n_model`. That dim is OIHW's leading one for a conv and the only
    one of a per-channel tensor (BatchNorm's weight, bias and running
    statistics); JAX's is HWIO's trailing one. It decides for parameters,
    momentum and the donor's variables alike (any name -> tensor or
    shape mapping)."""
    out = {}
    for name, t in named_tensors.items():
        shape = tuple(getattr(t, "shape", t))
        out[name] = 0 if (n_model > 1 and len(shape) >= 1
                          and shape[0] >= min_size
                          and shape[0] % n_model == 0) else None
    return out
