"""The collectives of the data-parallel step, over torch.distributed (NCCL
on the card, gloo on the CPU).

The JAX package's step is one SPMD program over the global batch; XLA
inserts its collectives. The port's step runs a process a device and
calls these explicitly, each where the global-batch math needs it:

  * `gather_rows`: the contrastive term's inputs of every process,
    concatenated in rank order (ops/contrastive.py); differentiable;
  * `all_gather_rows`: its forward, used also by the train-mode
    BatchNorm's statistics (models/layers.py);
  * `all_reduce_mean_`: the trainable gradients, one coalesced all-reduce
    a dtype (engine/train.py);
  * `reduce_metrics`: the step's loss metrics (engine/train.py,
    engine/experiment.py);
  * `all_reduce_sum_`: the confusion matrix (engine/metrics.py) and
    BatchNorm's backward sums;
  * `all_reduce_max_`: on the 2-D mesh, `nan_guard`'s finite test
    (engine/train.py) over a model group.

Each takes a `group` (a subgroup of torch.distributed); the default is
the world. On the 2-D data x model mesh (parallel/mesh.py) the data
axis's collectives run over the rank's data group and three more carry
the model axis, the tensor-parallel pair of the wide convs and its
inverse (models/resnet.py, models/deeplab.py):

  * `gather_from_model`: every model rank's channel shard, concatenated
    along dim 1; its backward keeps this rank's slice of the gradient;
  * `copy_to_model`: the identity; its backward sums the gradient over
    the model group. It goes in front of a channel-sharded conv, whose
    ranks each hold a partial gradient of their common input;
  * `scatter_to_model`: this rank's channel slice of a whole tensor; its
    backward gathers the gradient.

The three keep only the group and shapes in their autograd context, so
a rematerialized block (models/layers.py `remat_contexts`) re-runs them
in its recompute as in its first run: every rank recomputes the same
blocks in the same order, and so issues the same collectives.

`tally()` counts the collectives issued while it is open, by group, op
and result shape.

Every function is the identity, and calls nothing, when no process group
is initialized; with a group of one process the collectives run (and carry
identity values). Nothing here synchronizes with the host, so the
collectives may sit inside a captured CUDA graph.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# the names `tally` files each subgroup under (parallel/mesh.py names its
# data and model groups); the world is "world"
_GROUP_NAMES: List[tuple] = []
_tally: Optional[collections.Counter] = None


def name_group(group, name: str) -> None:
    """File `group`'s collectives under `name` in `tally`."""
    _GROUP_NAMES.append((group, name))


def _group_name(group) -> str:
    for g, name in _GROUP_NAMES:
        if g is group:
            return name
    return "world" if group is None else "other"


def _count(op: str, group, shape) -> None:
    if _tally is not None:
        _tally[(_group_name(group), op, tuple(shape))] += 1


@contextlib.contextmanager
def tally():
    """Count every collective issued inside the block (forward and
    backward): yields a Counter of (group name, op, result shape) ->
    calls."""
    global _tally
    saved, _tally = _tally, collections.Counter()
    try:
        yield _tally
    finally:
        _tally = saved


def is_distributed() -> bool:
    """True inside a process group (of any size, one included)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def barrier() -> None:
    """Wait for every process of the group; a no-op without one."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(size * n, ...) = every `group` process's (n, ...) `x` in rank
    order. Not differentiable (see `gather_rows`)."""
    x = x.contiguous()
    size = dist.get_world_size(group)
    _count("all_gather", group, (size * x.shape[0],) + tuple(x.shape[1:]))
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 whose backward gives this process its own
    slice of the gradient, times the group's size.

    Every process computes the same function of the gathered tensor, so
    the gradient each holds for the gathered tensor is the same; the
    adjoint of the gather (a reduce-scatter of the sum) is then size x
    this process's slice, computed here without a collective (gloo has no
    reduce-scatter, and NCCL's would only add the same slice size
    times). The gradient all-reduce divides by the group's size after the
    backward, so the contrastive term's gradient counts once."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = x.shape[0]
        ctx.rank = dist.get_rank(group)
        ctx.size = dist.get_world_size(group)
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        mine = grad.narrow(0, ctx.rank * ctx.n, ctx.n)
        return mine * ctx.size, None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every `group` process's `x` concatenated along dim 0 in rank order,
    with `_GatherRows`'s gradient; `x` itself without a process group."""
    if not is_distributed():
        return x
    if x.requires_grad:
        return _GatherRows.apply(x, group)
    return all_gather_rows(x, group)


def _dense_copy(x: torch.Tensor) -> torch.Tensor:
    """A dense copy of `x`, channels_last where it is 4-D (the model's
    layout)."""
    return x.clone(memory_format=torch.channels_last if x.dim() == 4
                   else torch.contiguous_format)


def all_gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    """(B, size * c, ...) = every `group` process's (B, c, ...) `x`
    concatenated along dim 1 in rank order. The gather runs on the
    channels-last view (a channels_last NCHW tensor is one block of
    (B, H, W, c)), so the result is channels_last too."""
    size = dist.get_world_size(group)
    xp = x.movedim(1, -1).contiguous()
    c = xp.shape[-1]
    _count("all_gather", group, (x.shape[0], size * c) + tuple(x.shape[2:]))
    if dist.get_backend(group) == "nccl":
        out = xp.new_empty((size,) + tuple(xp.shape))
        dist.all_gather_into_tensor(out, xp, group=group)
    else:
        parts = [torch.empty_like(xp) for _ in range(size)]
        dist.all_gather(parts, xp, group=group)
        out = torch.stack(parts)
    # (size, B, ..., c) -> (B, ..., size, c) -> (B, ..., size * c)
    out = out.movedim(0, -2).reshape(tuple(xp.shape[:-1]) + (size * c,))
    return out.movedim(-1, 1)


def all_reduce_sum_(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `x` over the `group` processes, in place; returns `x`."""
    if is_distributed():
        _count("all_reduce", group, x.shape)
        dist.all_reduce(x, group=group)
    return x


def all_reduce_max_(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of `x` over the `group` processes, in place;
    returns `x`."""
    if is_distributed():
        _count("all_reduce_max", group, x.shape)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


class _GatherFromModel(torch.autograd.Function):
    """`all_gather_channels`, whose backward keeps this rank's channel
    slice of the gradient: every model rank computes the same function of
    the gathered tensor (a replicated conv, the classifiers, the losses),
    so each holds the whole gradient already."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.c = x.shape[1]
        ctx.rank = dist.get_rank(group)
        return all_gather_channels(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.rank * ctx.c, ctx.c), None


class _CopyToModel(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the model group:
    the ranks consume the tensor through different weight shards, and each
    holds a partial gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # a copy: the incoming gradient may be another node's too
        return all_reduce_sum_(_dense_copy(grad), ctx.group), None


class _ScatterToModel(torch.autograd.Function):
    """This rank's channel slice of a tensor every model rank holds whole;
    the backward gathers the gradient's slices."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        c = x.shape[1] // size
        return _dense_copy(x.narrow(1, rank * c, c))

    @staticmethod
    def backward(ctx, grad):
        return all_gather_channels(grad, ctx.group), None


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The whole tensor of `x`'s channel shards over the model `group`."""
    return _GatherFromModel.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, with its gradient summed over the model `group`."""
    return _CopyToModel.apply(x, group)


def scatter_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's channel shard of the whole tensor `x`."""
    return _ScatterToModel.apply(x, group)


def _by_dtype(tensors) -> List[List[torch.Tensor]]:
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return list(by_dtype.values())


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average `tensors` over the `group` processes, in place: one
    all-reduce of a flat buffer for each dtype, then a division by the
    group's size."""
    if not is_distributed() or not tensors:
        return
    size = dist.get_world_size(group)
    for same in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in same])
        all_reduce_sum_(flat, group)
        flat.div_(size)
        torch._foreach_copy_(same, [v.view(t.shape) for v, t in zip(
            flat.split([t.numel() for t in same]), same)])


def reduce_metrics(metrics: Dict[str, torch.Tensor], keys: Sequence[str],
                   group=None) -> Dict[str, torch.Tensor]:
    """`metrics` with the 0-d tensors named in `keys` replaced by their
    mean over the `group` processes (one all-reduce); the global value of
    a mean over every pixel, since each process holds as many pixels."""
    if not is_distributed() or not keys:
        return metrics
    vals = all_reduce_sum_(torch.stack([metrics[k] for k in keys]), group)
    vals = vals / dist.get_world_size(group)
    return {**metrics, **dict(zip(keys, vals.unbind()))}


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Copy process `src`'s `tensors` into every process's, in place: one
    broadcast of a flat buffer for each dtype."""
    if not is_distributed() or not tensors:
        return
    for same in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src)
        torch._foreach_copy_(same, [v.view(t.shape) for v, t in zip(
            flat.split([t.numel() for t in same]), same)])
